"""repro_torch: One-Hop Sub-Query Result Caches for Graph Database Systems,
in PyTorch and CUDA.

The PyTorch port of the JAX package ``repro``, which stays the reference.
Module layout mirrors ``repro`` so each twin sits at the same relative path.
The port imports nothing of JAX or of ``repro``. Entry points run on the
CUDA device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
