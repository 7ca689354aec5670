"""PyTorch/CUDA port of the tpu_bench CFD micro-benchmark suite.

Beside the JAX package `tpu_bench`, which stays the reference, this package
runs benchmark05's headline path (the 3D BwdTrans sum-factorization at
nq=8^3) on one NVIDIA Hopper card through two CUDA kernels written by hand
for sm_90a (`csrc/`), with plain PyTorch versions of both that the CPU uses.
Importing it builds nothing and touches no device.
"""

__version__ = "0.1.0"
