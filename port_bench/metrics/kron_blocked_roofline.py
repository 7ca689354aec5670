"""kron_blocked_roofline: the operation's least time of a call
(roofline.py) over K2's device time a call, from the profiler's records of
the traced window, in %.  K2 (csrc/bwdtrans2d.cu) runs C resident
(kron_resident_kernel) or dense on the tensor cores (dense_gemm_kernel in
its M-fastest tile order; K3 runs the same template N-fastest)."""

from port_bench import roofline


def _k2(name):
    return "kron_resident_kernel" in name or (
        "dense_gemm_kernel" in name and "MFast" in name)


def read(run):
    return roofline.share(run, _k2)
