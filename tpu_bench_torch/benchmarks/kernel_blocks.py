"""Block-size sweep of the hand kernels on one CUDA card.

    python -m tpu_bench_torch.benchmarks.kernel_blocks

For each kernel with a block-size knob, on random inputs in f32 and f64:
the least device time of one call by CUDA events (20 calls, L2 flushed
before each) for every setting, one line per setting, in turns (each
setting twice, in the order a b .. b a).  The sweeps:

- K1 (qp_fused3d): every (element tile, plane group) whose buffers fit,
  at benchmark05's nq=4^3, 6^3, 8^3 and 10^3 (E=131072) and benchmark04's
  8^2, 16^2 and 32^2 (E=1,048,576); `*` marks qp_config's choice;
- K2 (kron_blocked): every strip width of the C-resident configuration
  that fits, and 0, the dense one, at benchmark05's Pallas(QP) stage 1
  (64 x 49, nq=8^3), benchmark04's at nq=8^2 (8 x 7) and benchmark04's
  kron_wide4 at nq=8^2 (64 x 49); `*` marks kron_config's choice;
- K4 (qp_stage2_3d) elements per block and K5 (qp1d_fused3d) element
  tiles at benchmark05's nq=4^3 .. 10^3.

After each K1 shape, a `best` line gives the fastest setting.  The
constants of kernels/bwdtrans3d.py (QP_MEASURED, QP2_EPB, QP1D_TILES)
and kernels/bwdtrans2d.py (KRON_STRIPS) rest on its output.  Prints the
card's name and power limit first; needs a CUDA device.
"""

from __future__ import annotations

import subprocess

import torch

from tpu_bench_torch.core.timing import event_ms
from tpu_bench_torch.kernels import bwdtrans2d as k2
from tpu_bench_torch.kernels import bwdtrans3d as k1

NELMT = 131072
B04_NELMT = 1048576
# K1's shapes: (label, nm0, nrq, nq0, nkj, E)
K1_SHAPES = [(f"b05 nq={n}^3", n - 1, (n - 1) ** 2, n, n * n, NELMT)
             for n in (4, 6, 8, 10)]
K1_SHAPES += [(f"b04 nq={n}^2", n - 1, n - 1, n, n, B04_NELMT)
              for n in (8, 16, 32)]
# K2's products: (label, M, K, chunks, columns a chunk)
K2_SHAPES = [("b05 nq=8^3 QP stage 1", 64, 49, 7, NELMT),
             ("b04 nq=8^2 QP stage 1", 8, 7, 7, B04_NELMT),
             ("b04 nq=8^2 kron_wide4", 64, 49, B04_NELMT // 8192, 8192)]


def in_turns(fn, settings) -> dict:
    """{setting: [ms, ms]}: each setting timed twice, a b .. b a."""
    times = {v: [] for v in settings}
    for v in (*settings, *reversed(settings)):
        times[v].append(event_ms(lambda: fn(v)))
    return times


def report(tag, name, times, chosen=None) -> None:
    for v, ts in times.items():
        mark = " *" if v == chosen else ""
        print(f"{tag} {name} {v}{mark}: "
              + " ".join(f"{t:.4f}" for t in ts) + " ms", flush=True)


def k1_sweep(rnd, tag, itemsize) -> None:
    for label, nm0, nrq, nq0, nkj, e in K1_SHAPES:
        x, b0, c = rnd(nm0 * nrq, e), rnd(nm0, nq0), rnd(nkj, nrq)
        settings = [(et, g) for et in k1.QP_TILES[itemsize]
                    for g in k1.QP_PLANE_GROUPS
                    if k1.qp_smem(itemsize, et, g, nm0, nrq, nq0, nkj)
                    <= k1.SMEM_BLOCK]
        times = in_turns(lambda v: k1.qp_shared3d_flat(
            x, b0, c, nrq=nrq, epb=v[0], planes=v[1]), settings)
        report(f"{tag} {label} E={e}", "K1 (element tile, planes)", times,
               k1.qp_config(itemsize, nm0, nrq, nq0, nkj))
        best = min(times, key=lambda v: min(times[v]))
        print(f"{tag} {label} K1 best {best}: {min(times[best]):.4f} ms",
              flush=True)
        del x
        torch.cuda.empty_cache()


def k2_sweep(rnd, tag, itemsize) -> None:
    for label, m, k, chunks, n in K2_SHAPES:
        x, c = rnd(chunks, k, n), rnd(m, k)
        settings = [0] + [s for s in k2.KRON_STRIPS
                          if k2.kron_resident_smem(itemsize, m, k, s)
                          <= k2.SMEM_BLOCK]
        times = in_turns(lambda v: k2.kron_blocked(x, c, strip=v), settings)
        report(f"{tag} {label}", "K2 strip", times,
               k2.kron_config(itemsize, m, k))
        del x
        torch.cuda.empty_cache()


def knobs(rnd, nq: int, e: int) -> dict:
    """{kernel: (settings, fn(setting))} of K4 and K5 at isotropic order
    nq."""
    nm = nq - 1
    w, b0 = rnd(nm, nq * nq, e), rnd(nm, nq)
    widths = (nm ** 3, nm * nm * nq, nm * nq * nq, nq ** 3)
    em = rnd(e, widths[0])
    s = [rnd(k, n) for k, n in zip(widths, widths[1:])]
    return {
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

        tag = str(dtype)[6:]
        k1_sweep(rnd, tag, dtype.itemsize)
        k2_sweep(rnd, tag, dtype.itemsize)
        for nq in (4, 6, 8, 10):
            for name, (settings, fn) in knobs(rnd, nq, NELMT).items():
                report(f"{tag} nq={nq}^3 E={NELMT}", name,
                       in_turns(fn, settings))


if __name__ == "__main__":
    main()
