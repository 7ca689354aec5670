"""qp_ring_pct: the share of K1's launches in the process that took its
depth-2 form, the persistent block with a two-slot slab ring, in %, from
the program's counter tpu_bench_torch/kernels/bwdtrans3d.qp_depths (K1's
launches by depth).  K1's form is fixed by shape (qp_config's cache), so
the count over the process, warm-up and windows alike, is the window's
share.  None where the program keeps no such counter or K1 never
launched."""


def read(run):
    try:
        from tpu_bench_torch.kernels.bwdtrans3d import qp_depths
    except ImportError:  # a program without the counter
        return None
    total = sum(qp_depths.values())
    if not total:
        return None
    return 100.0 * qp_depths[2] / total
