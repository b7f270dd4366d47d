"""Model configurations of the port, one module per architecture, each at
the path of its twin in ``repro.configs``. The JAX package's registry of
all its architectures waits for the slices that port the other families."""
