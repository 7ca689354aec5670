"""PyTorch/CUDA port of the tpu_bench CFD micro-benchmark suite.

Beside the JAX package `tpu_bench`, which stays the reference, this package
runs benchmarks 01-05 (L2 norm, x += y, matvec, and the 2D and 3D BwdTrans
sum-factorizations) on one NVIDIA Hopper card, every hand column through
CUDA kernels written by hand for sm_90a (`csrc/`), each with a plain
PyTorch version that the CPU uses.  Importing it builds nothing and
touches no device.
"""

__version__ = "0.1.0"
