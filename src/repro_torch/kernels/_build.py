"""Build-at-first-use loader for the port's CUDA kernels.

Every ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes``. All sources are
compiled in parallel (one ``nvcc`` process each, started together) the
first time any kernel is launched, into ``build/repro_torch/<digest>/`` at
the repository root, where ``<digest>`` hashes the sources, the headers
they share (``csrc/*.cuh``) and the flags, so an edited source or header
rebuilds and an unchanged tree is reused.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict = {}
_BOUND: dict = {}
# what the last build did: seconds, and each source's ptxas report
BUILD_INFO: dict = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def sources() -> list:
    return sorted(SRC_DIR.glob("*.cu"))


def headers() -> list:
    return sorted(SRC_DIR.glob("*.cuh"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every source not yet built; returns ``{name: library path}``.

    Raises with nvcc's stderr if any compile fails.
    """
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: out_dir / f"lib{src.stem}.so" for src in sources()}
    t0 = time.perf_counter()
    procs = {}
    for src in sources():
        target = libs[src.stem]
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        ), tmp, target)
    failures = []
    for name, (proc, tmp, target) in procs.items():
        out, err = proc.communicate()
        BUILD_INFO.setdefault("ptxas", {})[name] = (out + err).strip()
        if proc.returncode != 0:
            failures.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n{err}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["built"] = sorted(procs)
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all sources first
    if this is the first use."""
    if name not in _LIBS:
        libs = build_all()
        if name not in libs:
            raise RuntimeError(f"no CUDA source csrc/{name}.cu")
        _LIBS[name] = ctypes.CDLL(str(libs[name]))
    return _LIBS[name]


def bind(name: str, symbol: str, n_pointers: int, n_ints: int):
    """``symbol`` of library ``name`` with its C signature declared:
    ``n_pointers`` device pointers, ``n_ints`` ints, then the stream; it
    returns the ``cudaGetLastError()`` code of its launch. Bound once per
    process: the lookup costs more host time than the launch it precedes."""
    key = (name, symbol)
    if key not in _BOUND:
        fn = getattr(load(name), symbol)
        fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BOUND[key] = fn
    return _BOUND[key]


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
