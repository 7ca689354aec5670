"""Block-size sweep of the hand kernels on one CUDA card.

    python -m tpu_bench_torch.benchmarks.kernel_blocks

For each kernel with a block-size knob, at benchmark05's nq=4^3, 6^3,
8^3 and 10^3 shapes and E=131072 elements in f32 and f64, on random
inputs: the least device time of one call by CUDA events (20 calls, L2
flushed before each) for every setting, one line per setting, in turns
(each setting twice, in the order a b .. b a).  The block-size
constants of kernels/bwdtrans3d.py (EPB, QP2_EPB, QP1D_TILES) rest on its
output.  Prints the card's name and power limit first; needs a CUDA
device.
"""

from __future__ import annotations

import subprocess

import torch

from tpu_bench_torch.core.timing import event_ms
from tpu_bench_torch.kernels import bwdtrans3d as k1

NELMT = 131072


def knobs(rnd, nq: int, e: int) -> dict:
    """{kernel: (settings, fn(setting))} at isotropic order nq."""
    nm = nq - 1
    x, b0, c12t = rnd(nm, nm * nm, e), rnd(nm, nq), rnd(nq * nq, nm * nm)
    w = rnd(nm, nq * nq, e)
    widths = (nm ** 3, nm * nm * nq, nm * nq * nq, nq ** 3)
    em = rnd(e, widths[0])
    s = [rnd(k, n) for k, n in zip(widths, widths[1:])]
    return {
        "K1 qp_fused3d epb": (
            (64, 128, 256),
            lambda v: k1.qp_shared3d(x, b0, c12t, epb=v)),
        "K4 qp_stage2_3d epb": (
            (64, 128, 256, 512),
            lambda v: k1.qp_stage2_3d(w, b0, epb=v)),
        "K5 qp1d_fused3d element tile": (
            k1.qp1d_tiles(em, *s),
            lambda v: k1.qp1d_shared3d(em, *s, epb=v)),
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_blocks: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.float64):
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device="cuda",
                               dtype=dtype)

        for nq in (4, 6, 8, 10):
            for name, (settings, fn) in knobs(rnd, nq, NELMT).items():
                order = (*settings, *reversed(settings))
                times = {v: [] for v in settings}
                for v in order:
                    times[v].append(event_ms(lambda: fn(v)))
                for v in settings:
                    print(f"{str(dtype)[6:]} nq={nq}^3 E={NELMT} "
                          f"{name} {v}: " + " ".join(
                              f"{t:.4f}" for t in times[v]) + " ms",
                          flush=True)


if __name__ == "__main__":
    main()
