"""PyTorch/CUDA port of the CADC serving stack (the JAX package `repro`
is the reference it is held against).

Module names and layout mirror `repro`, so each module's counterpart is
found at the same path. The port imports torch and never jax, and nothing
from `repro`. Kernels are CUDA C++ for sm_90a under `csrc/`, built at
first use (kernels/_build.py).
"""
