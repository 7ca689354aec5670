"""kron_resident_pct: the share of K2's launches in the process that took
its C-resident configuration (kron_resident_kernel, a strip width > 0),
in %, from the program's counter
tpu_bench_torch/kernels/bwdtrans2d.kron_strips (K2's launches by dtype and
strip, 0 the dense configuration).  K2's configuration is fixed by C's
shape (kron_config), so the count over the process, warm-up and windows
alike, is the window's share.  None where the program keeps no such
counter or K2 never launched."""


def read(run):
    try:
        from tpu_bench_torch.kernels.bwdtrans2d import kron_strips
    except ImportError:  # a program without the counter
        return None
    total = sum(kron_strips.values())
    if not total:
        return None
    resident = sum(n for (_, strip), n in kron_strips.items() if strip)
    return 100.0 * resident / total
