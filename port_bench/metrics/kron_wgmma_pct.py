"""kron_wgmma_pct: the share of K2's dense launches in the process that
took its f32 body on wgmma, in %, from the program's counter
tpu_bench_torch/kernels/bwdtrans2d.dense_bodies (K2's dense launches by
dtype and body).  K2's body is fixed by dtype, row width and alignment
(dense_body), so the count over the process, warm-up and windows alike,
is the window's share.  None where the program keeps no such counter or
K2 never launched its dense configuration."""


def read(run):
    try:
        from tpu_bench_torch.kernels.bwdtrans2d import dense_bodies
    except ImportError:  # a program without the counter
        return None
    total = sum(dense_bodies.values())
    if not total:
        return None
    wgmma = sum(n for (_, body), n in dense_bodies.items() if body == "wgmma")
    return 100.0 * wgmma / total
