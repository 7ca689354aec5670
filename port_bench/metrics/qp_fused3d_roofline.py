"""qp_fused3d_roofline: the operation's least time of a call (roofline.py)
over K1's device time a call (csrc/bwdtrans3d.cu qp_fused3d_kernel), from
the profiler's records of the traced window, in %."""

from port_bench import roofline


def read(run):
    return roofline.share(run, lambda name: "qp_fused3d_kernel" in name)
