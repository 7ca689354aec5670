"""qp_tf32_pct: the share of K1's launches in the process whose stage 2
ran on its f32 body on wgmma (3xTF32, wgmma.mma_async m64n64k8 with f32
sums), in %, from the program's counter
tpu_bench_torch/kernels/bwdtrans3d.qp_bodies (K1's launches by dtype and
body).  K1's body is fixed by shape and dtype (qp_config's cache), so the
count over the process, warm-up and windows alike, is the window's share.
None where the program keeps no such counter or K1 never launched; 0
where its K1 has no such body."""


def read(run):
    try:
        from tpu_bench_torch.kernels.bwdtrans3d import qp_bodies
    except ImportError:  # a program without the counter
        return None
    total = sum(qp_bodies.values())
    if not total:
        return None
    tf32 = sum(n for (_, body), n in qp_bodies.items() if body == "tf32")
    return 100.0 * tf32 / total
