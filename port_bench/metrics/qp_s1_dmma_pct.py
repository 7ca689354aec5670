"""qp_s1_dmma_pct: the share of K1's launches in the process whose stage 1
ran on DMMA (mma.sync.m16n8k8 on f64, beside the DMMA stage 2 with C12T
held), in %, from the program's counter
tpu_bench_torch/kernels/bwdtrans3d.qp_stage1_bodies (K1's launches by
dtype and stage-1 body).  K1's stage-1 body is fixed by shape and dtype
(qp_config's cache), so the count over the process, warm-up and windows
alike, is the window's share.  None where the program keeps no such
counter or K1 never launched; 0 where its K1 has no such body."""


def read(run):
    try:
        from tpu_bench_torch.kernels.bwdtrans3d import qp_stage1_bodies
    except ImportError:  # a program without the counter
        return None
    total = sum(qp_stage1_bodies.values())
    if not total:
        return None
    dmma = sum(n for (_, body), n in qp_stage1_bodies.items()
               if body == "dmma")
    return 100.0 * dmma / total
