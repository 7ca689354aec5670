"""Block-size sweep of the hand kernels on one CUDA card.

    python -m tpu_bench_torch.benchmarks.kernel_blocks [--only k1,k2,...]
    python -m tpu_bench_torch.benchmarks.kernel_blocks --uses

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
- K3 (em_gemm): every tile height of the S-resident configuration that
  fits, and 0, the dense one, at benchmark04's nq=8^2 kron_elem_major and
  QP-1D stages (E=1,048,576), benchmark05's nq=6^3 kron_elem_major and
  nq=8^3 kron_elem_major and QP-1D stages (E=131072); `*` marks
  em_config's choice;
- K4 (qp_stage2_3d): the 16-byte vectors a thread takes a step
  (QP2_UNROLLS; at most QP2_CHUNKED_UNROLL above nm0 = QP2_EXACT) at
  benchmark05's Pallas(QP) stage 2 at nq=8^3 (E=131072) and benchmark04's
  at nq=8^2, 16^2 and 32^2 (E=1,048,576); `*` marks the default;
- k4diag, what sets K4's pace at its two main shapes: K4 and torch.matmul
  on its layout beside a read-only pass over w (K10), a write-only fill
  of out's bytes (K11), K12's copy of as many bytes, and torch.matmul on
  views whose rows lie 4 KiB further apart than the 2^25 bytes of the
  main shapes, with the GB/s each reaches;
- K5 (qp1d_fused3d): element tiles at benchmark05's nq=4^3 .. 10^3;
- K8 (matvec_rm): rows a team of lanes owns (RM_ROWS) by vectors a lane
  takes a step (RM_UNROLLS) at benchmark03's 16384^2, A (4096, 16384) and A
  (16384, 4096); `*` marks the default;
- K9 (matvec_cm): rows in flight (CM_UNROLLS) by row shares (half, once
  and twice cm_splits' one wave) at benchmark03's 16384^2 and A (4096,
  16384); `*` marks the default.

After each K1 shape, a `best` line gives the fastest setting.  The
constants of kernels/bwdtrans3d.py (QP_MEASURED, QP2_UNROLL, QP1D_TILES),
kernels/bwdtrans2d.py (KRON_STRIPS, EM_TILES) and kernels/matvec.py
(RM_ROW, RM_UNROLL, CM_UNROLL) rest on its output.  `--only` runs the
named sweeps (k1, k2, k3, k4, k4diag, k5, k8, k9).

`--uses` times instead each K3 use (b04 nq=8^2 kron_elem_major and QP-1D
stages, E=1,048,576; b05 nq=8^3 kron_elem_major and QP-1D stages,
E=131072), K2's dense b05 nq=8^3 product, whose GEMM body K3 shares, K4
at its two main shapes beside torch.matmul, K9 at 16384^2 and K8 at
benchmark03's five shapes beside torch.mv, f32 and f64, through the calls
the columns make with no knob, so it (and k4diag) also times an earlier
tree of the port: run this file with that tree's root as the working
directory and on PYTHONPATH.

Prints the card's name and power limit first; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from tpu_bench_torch.core.timing import event_ms
from tpu_bench_torch.kernels import bwdtrans2d as k2
from tpu_bench_torch.kernels import bwdtrans3d as k1
from tpu_bench_torch.kernels import matvec as kmv
from tpu_bench_torch.kernels import stream

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
# K3's products: (label, E, K, N)
K3_SHAPES = [("b04 nq=8^2 kron_elem_major", B04_NELMT, 49, 64),
             ("b04 nq=8^2 QP-1D stage 1", B04_NELMT, 49, 56),
             ("b04 nq=8^2 QP-1D stage 2", B04_NELMT, 56, 64),
             ("b05 nq=6^3 kron_elem_major", NELMT, 125, 216),
             ("b05 nq=8^3 kron_elem_major", NELMT, 343, 512),
             ("b05 nq=8^3 QP-1D stage 1", NELMT, 343, 392),
             ("b05 nq=8^3 QP-1D stage 2", NELMT, 392, 448),
             ("b05 nq=8^3 QP-1D stage 3", NELMT, 448, 512)]
K3_USES = [shape for shape in K3_SHAPES if "6^3" not in shape[0]]
# K9's matrices A_cm: (label, rows N, columns M)
K9_SHAPES = [("b03 16384^2", 16384, 16384), ("A (4096, 16384)", 16384, 4096)]
# K4's main shapes: (label, nm0, nq0, nkj, E); w is (nm0, nkj, E)
K4_MAIN = [("b05 nq=8^3", 7, 8, 64, NELMT), ("b04 nq=8^2", 7, 8, 8, B04_NELMT)]
# K4's swept shapes: the main ones and benchmark04's nq=16^2 and 32^2
K4_SHAPES = K4_MAIN + [(f"b04 nq={n}^2", n - 1, n, n, B04_NELMT)
                       for n in (16, 32)]
# K8's matrices A (M, N): benchmark03's shapes that chip_smoke.py checks,
# and those its sweep takes
K8_SHAPES = [(1000, 777), (777, 1000), (4096, 16384), (16384, 4096),
             (16384, 16384)]
K8_SWEPT = [(16384, 16384), (4096, 16384), (16384, 4096)]
# k4diag: the extra row pitch of the padded views, in bytes
PAD_BYTES = 4096


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


def k3_sweep(rnd, tag, itemsize) -> None:
    for label, e, k, n in K3_SHAPES:
        x, s = rnd(e, k), rnd(k, n)
        settings = [0] + [h for h in k2.EM_TILES
                          if k2.em_resident_smem(itemsize, k, n, h)
                          <= k2.SMEM_BLOCK]
        times = in_turns(lambda v: k2.one_stage_em(x, s, tile=v), settings)
        report(f"{tag} {label} E={e}", "K3 tile", times,
               k2.em_config(itemsize, k, n))
        del x
        torch.cuda.empty_cache()


def k9_sweep(rnd, tag, itemsize) -> None:
    for label, n, m in K9_SHAPES:
        a_cm, x = rnd(n, m), rnd(n)
        blocks = kmv.cm_blocks(a_cm.device, itemsize, kmv.CM_UNROLL)
        rule = kmv.cm_splits(n, m, itemsize, blocks)
        splits = sorted({max(1, rule // 2), rule, 2 * rule})
        settings = [(u, sp) for u in kmv.CM_UNROLLS for sp in splits]
        times = in_turns(lambda v: kmv.matvec_cm(a_cm, x, unroll=v[0],
                                                 splits=v[1]), settings)
        report(f"{tag} {label} ({blocks} blocks in a wave)",
               "K9 (rows in flight, shares)", times, (kmv.CM_UNROLL, rule))
        del a_cm
        torch.cuda.empty_cache()


def k4diag(rnd, tag, itemsize) -> None:
    """What sets K4's pace at its main shapes: K4 and torch.matmul on the
    (nm0, F = nkj*E) @ layout, a read-only pass over w (K10), a write-only
    fill of out's bytes (K11), K12's copy of as many bytes as K4 moves,
    and torch.matmul on views of w and out whose rows are PAD_BYTES
    further apart (at the main shapes they are 2^25 bytes apart).  Only
    calls without knobs, so it also times an earlier tree."""
    for label, nm0, nq0, nkj, e in K4_MAIN:
        f = nkj * e
        w, b0 = rnd(nm0, nkj, e), rnd(nm0, nq0)
        pad = PAD_BYTES // itemsize
        w_pad = rnd(nm0, f + pad)[:, :f]
        out_pad = torch.empty(nq0, f + pad, dtype=w.dtype,
                              device=w.device)[:, :f]
        n_copy = (nm0 + nq0) * f // 2 // stream.LANES * stream.LANES
        src, seed = rnd(n_copy), rnd(1, 1)
        dst = torch.empty_like(src)
        moved = (nm0 + nq0) * f * itemsize
        probes = [
            ("K4 qp_stage2_3d", moved, lambda: k1.qp_stage2_3d(w, b0)),
            ("torch.matmul", moved,
             lambda: torch.matmul(b0.T, w.view(nm0, f))),
            ("K10 read of w", nm0 * f * itemsize,
             lambda: stream.read_manual(w.view(-1))),
            ("K11 fill of out's bytes", nq0 * f * itemsize,
             lambda: stream.fill_manual(nq0 * f // stream.LANES, seed,
                                        dtype=w.dtype)),
            ("K12 copy of as many bytes", 2 * n_copy * itemsize,
             lambda: stream.copy_manual(src, out=dst)),
            (f"torch.matmul, rows {PAD_BYTES} B further apart", moved,
             lambda: torch.mm(b0.T, w_pad, out=out_pad)),
        ]
        for name, nbytes, fn in probes:
            ms = event_ms(fn)
            print(f"{tag} {label} E={e} k4diag {name}: {ms:.4f} ms, "
                  f"{nbytes / ms * 1e-6:.1f} GB/s", flush=True)
        del w, w_pad, out_pad, src, dst
        torch.cuda.empty_cache()


def uses(rnd, tag) -> None:
    """K3's uses, K2's dense product (the GEMM body K3 shares), K4 at its
    main shapes and K8 and K9 at benchmark03's shapes, through the
    columns' calls."""
    x, c = rnd(16, 343, 8192), rnd(512, 343)
    print(f"{tag} K2 b05 nq=8^3 Coales (dense) E=131072: "
          f"{event_ms(lambda: k2.kron_blocked(x, c)):.4f} ms; "
          f"torch.matmul {event_ms(lambda: torch.matmul(c, x)):.4f} ms",
          flush=True)
    del x, c
    for label, e, k, n in K3_USES:
        x, s = rnd(e, k), rnd(k, n)
        print(f"{tag} K3 {label} E={e}: "
              f"{event_ms(lambda: k2.one_stage_em(x, s)):.4f} ms; "
              f"torch.matmul {event_ms(lambda: torch.matmul(x, s)):.4f} ms",
              flush=True)
        del x, s
        torch.cuda.empty_cache()
    a_cm, x = rnd(16384, 16384), rnd(16384)
    print(f"{tag} K9 16384^2: {event_ms(lambda: kmv.matvec_cm(a_cm, x)):.4f}"
          f" ms; torch.mv {event_ms(lambda: torch.mv(a_cm.t(), x)):.4f} ms",
          flush=True)
    del a_cm
    for label, nm0, nq0, nkj, e in K4_MAIN:
        w, b0 = rnd(nm0, nkj, e), rnd(nm0, nq0)
        wf = w.view(nm0, -1)
        print(f"{tag} K4 {label} E={e}: "
              f"{event_ms(lambda: k1.qp_stage2_3d(w, b0)):.4f} ms; "
              f"torch.matmul {event_ms(lambda: torch.matmul(b0.T, wf)):.4f}"
              " ms", flush=True)
        del w, wf
        torch.cuda.empty_cache()
    for m, n in K8_SHAPES:
        a, x = rnd(m, n), rnd(n)
        print(f"{tag} K8 ({m}, {n}): "
              f"{event_ms(lambda: kmv.matvec_rm(a, x)):.4f} ms; torch.mv "
              f"{event_ms(lambda: torch.mv(a, x)):.4f} ms", flush=True)


def k4_sweep(rnd, tag, itemsize) -> None:
    for label, nm0, nq0, nkj, e in K4_SHAPES:
        w, b0 = rnd(nm0, nkj, e), rnd(nm0, nq0)
        settings = [u for u in k1.QP2_UNROLLS
                    if nm0 <= k1.QP2_EXACT or u <= k1.QP2_CHUNKED_UNROLL]
        times = in_turns(lambda v: k1.qp_stage2_3d(w, b0, unroll=v),
                         settings)
        report(f"{tag} {label} E={e}", "K4 unroll", times, k1.QP2_UNROLL)
        del w
        torch.cuda.empty_cache()


def k5_sweep(rnd, tag) -> None:
    for nq in (4, 6, 8, 10):
        nm = nq - 1
        widths = (nm ** 3, nm * nm * nq, nm * nq * nq, nq ** 3)
        em = rnd(NELMT, widths[0])
        s = [rnd(k, n) for k, n in zip(widths, widths[1:])]
        report(f"{tag} nq={nq}^3 E={NELMT}", "K5 qp1d_fused3d element tile",
               in_turns(lambda v: k1.qp1d_shared3d(em, *s, epb=v),
                        k1.qp1d_tiles(em, *s)))
        del em
        torch.cuda.empty_cache()


def k8_sweep(rnd, tag, itemsize) -> None:
    for m, n in K8_SWEPT:
        a, x = rnd(m, n), rnd(n)
        settings = [(r, u) for r in kmv.RM_ROWS for u in kmv.RM_UNROLLS]
        times = in_turns(lambda v: kmv.matvec_rm(a, x, rows=v[0],
                                                 unroll=v[1]), settings)
        report(f"{tag} A ({m}, {n})", "K8 (rows, unroll)", times,
               (kmv.RM_ROW, kmv.RM_UNROLL))
        del a
        torch.cuda.empty_cache()


SWEEPS = ("k1", "k2", "k3", "k4", "k4diag", "k5", "k8", "k9")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default=",".join(SWEEPS),
                        help=f"comma-separated sweeps of {SWEEPS}")
    parser.add_argument("--uses", action="store_true",
                        help="time K3's uses and K9 instead of sweeping")
    args = parser.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= set(SWEEPS):
        parser.error(f"--only: {sorted(only - set(SWEEPS))} not in {SWEEPS}")
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
        if args.uses:
            uses(rnd, tag)
            continue
        if "k1" in only:
            k1_sweep(rnd, tag, dtype.itemsize)
        if "k2" in only:
            k2_sweep(rnd, tag, dtype.itemsize)
        if "k3" in only:
            k3_sweep(rnd, tag, dtype.itemsize)
        if "k4" in only:
            k4_sweep(rnd, tag, dtype.itemsize)
        if "k4diag" in only:
            k4diag(rnd, tag, dtype.itemsize)
        if "k5" in only:
            k5_sweep(rnd, tag)
        if "k8" in only:
            k8_sweep(rnd, tag, dtype.itemsize)
        if "k9" in only:
            k9_sweep(rnd, tag, dtype.itemsize)


if __name__ == "__main__":
    main()
