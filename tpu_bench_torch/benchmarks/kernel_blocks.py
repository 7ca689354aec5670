"""Block-size sweep of the hand kernels on one CUDA card.

    python -m tpu_bench_torch.benchmarks.kernel_blocks [--only k1,k2,...]
    python -m tpu_bench_torch.benchmarks.kernel_blocks --uses
    python -m tpu_bench_torch.benchmarks.kernel_blocks --only host
    python -m tpu_bench_torch.benchmarks.kernel_blocks --only ring
    python -m tpu_bench_torch.benchmarks.kernel_blocks --only k1 --probe

For each kernel with a block-size knob, on random inputs in f32 and f64
(`--dtype`; `--dtype bf16` runs the sweeps of K1-K5, whose bf16 instances
take the same knobs):
the least device time of one call by CUDA events (20 calls, L2 flushed
before each) for every setting, one line per setting, in turns (each
setting twice, in the order a b .. b a).  The sweeps:

- K1 (qp_fused3d): every (element tile, plane group, depth, threads,
  stage-2 body: SIMT, in f64 DMMA, with C12T staged in shared memory or
  held in registers, in bf16 HMMA and in f32 3xTF32 on wgmma, each with
  C12T held; stage-1 body: SIMT, and in f64 DMMA beside the held DMMA
  form at (16, 16, 1, 256)) whose buffers fit, at benchmark05's nq=4^3,
  6^3, 8^3 and 10^3 (E=131072) and benchmark04's 8^2, 16^2 and 32^2
  (E=1,048,576; `--nelmt` sets E for every K1 shape, `--rows` keeps the
  shapes whose label holds one of its parts); `*` marks qp_config's
  choice; with `--back-to-back` each setting's line also gives its time a
  call over K1_CALLS calls back to back (core/timing.run_ms, no flush),
  in turns as the flushed times; then K1's launches by depth
  (qp_depths), by (dtype, body) (qp_bodies), by (dtype, stage-1 body)
  (qp_stage1_bodies) and its DMMA launches by where C12T lived
  (qp_dmma_c12t);
- K2 (kron_blocked): every strip width of the C-resident configuration
  that fits, and 0, the dense one, at benchmark05's Pallas(QP) stage 1
  (64 x 49, nq=8^3), benchmark04's at nq=8^2 (8 x 7) and benchmark04's
  kron_wide4 at nq=8^2 (64 x 49); `*` marks kron_config's choice; then
  the dense configuration's bodies (wgmma where dense_body allows it,
  and mma.sync, on a copy of in one value off a 16-byte boundary, which
  dense_body sends there; `*` marks its choice) at benchmark05's nq=8^3
  kron (16 chunks of 8192) and kron_coalesced (one of 131072) and
  benchmark04's dense krons at 16^2 and 32^2 (chunks of 8192), beside
  torch.matmul; then K2's dense launches by (dtype, body)
  (dense_bodies);
- K3 (em_gemm): every tile height of the S-resident configuration that
  fits, and 0, the dense one, at benchmark04's nq=8^2 kron_elem_major and
  QP-1D stages (E=1,048,576), benchmark05's nq=6^3 kron_elem_major and
  nq=8^3 kron_elem_major and QP-1D stages (E=131072); `*` marks
  em_config's choice;
- K4 (qp_stage2_3d): the 16-byte vectors a thread takes a step
  (qp2_unrolls: at most QP2_CHUNKED_UNROLL above nm0 = QP2_EXACT, half in
  bf16) at
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
  16384); `*` marks the default;
- ring: K12's copy, scale and triad at the ceilings' 134,217,728 elements
  and K7's 16-byte form (add_inplace_manual) at 536,870,912, each beside
  the library call computing the same function, at every (chunk, depth)
  of kernels/ring.py's sweep that fits; `*` marks ring.RING's.  Run on a
  tree without the ring, it times the first design (the default call);
- host, what a column's call costs the host (host_sweep): at b05 nq=8^3
  and b04 nq=8^2 (f32, f64), b04 nq=2^2, b01/b02 at 2^20 and 536,870,912
  and b03 at 1024^2 and 16384^2 (f32), each column's enqueue µs, its
  host-clock time as the benchmarks take it, its CUDA-event time, the
  difference of the two as a median over calls taken in turns (with the
  part before the kernel ends and the part after), and for the hand
  columns the enqueue in parts, beside the library column's (`--rows b02`
  runs the rows whose label holds b02).

`--only k1 --probe` times instead K1 at qp_config's choice in its plain
form and in its probe form (kernels/bwdtrans3d.qp_probed, the form a
profiled call runs), in turns, at the shapes of the benchmark's seven qp
cells (PROBE_SHAPES): PROBE_ROUNDS rounds of `in_turns`, each time the
least of 20 flushed calls, and the probe's cost, its least time over the
plain form's, less 1; then the probe's readings of the shape's probed
calls under the qp cells' metric names (qp_wait_pct, qp_stage1_pct,
qp_stage2_pct, the rest of the block outside them, qp_slot_idle_pct).

After each K1 shape, a `best` line gives the fastest setting.  The
constants of kernels/bwdtrans3d.py (QP_MEASURED, QP2_UNROLL, QP1D_TILES),
kernels/bwdtrans2d.py (KRON_STRIPS, EM_TILES), kernels/matvec.py
(RM_ROW, RM_UNROLL, CM_UNROLL) and kernels/ring.py (RING) rest on its
output.  `--only` runs the named sweeps (k1, k2, k3, k4, k4diag, k5, k8,
k9, ring, host).  The host and ring sweeps use only calls every tree of
the port has (the ring sweep times the ring where the tree has it), so
they also time an earlier tree, as `--uses` does.

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
import statistics
import subprocess
import time

import torch

from tpu_bench_torch.core.timing import (ENQUEUE_CYCLES, L2Flush, event_ms,
                                         run_ms, time_variant)
from tpu_bench_torch.kernels import build
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
# The shapes of the benchmark's seven qp cells (port_bench): (label, dtype,
# nm0, nrq, nq0, nkj, E), where --probe times K1's probe form
PROBE_SHAPES = [("hex8-f32-qp b05 nq=8^3", torch.float32, 7, 49, 8, 64,
                 NELMT),
                ("hex8-f64-qp b05 nq=8^3", torch.float64, 7, 49, 8, 64,
                 B04_NELMT),
                ("hex10-f64-qp b05 nq=10^3", torch.float64, 9, 81, 10, 100,
                 524288),
                ("quad8-f32-qp b04 nq=8^2", torch.float32, 7, 7, 8, 8,
                 B04_NELMT),
                ("quad32-f64-qp b04 nq=32^2", torch.float64, 31, 31, 32, 32,
                 524288),
                ("hex8-bf16-qp b05 nq=8^3", torch.bfloat16, 7, 49, 8, 64,
                 B04_NELMT),
                ("quad8-bf16-qp b04 nq=8^2", torch.bfloat16, 7, 7, 8, 8,
                 B04_NELMT)]
PROBE_ROUNDS = 4
# --back-to-back: K1's calls a run of core/timing.run_ms
K1_CALLS = 10
# K2's products: (label, M, K, chunks, columns a chunk)
K2_SHAPES = [("b05 nq=8^3 QP stage 1", 64, 49, 7, NELMT),
             ("b04 nq=8^2 QP stage 1", 8, 7, 7, B04_NELMT),
             ("b04 nq=8^2 kron_wide4", 64, 49, B04_NELMT // 8192, 8192)]
# K2's dense products, whose bodies the sweep times: (label, M, K, chunks,
# columns a chunk)
K2_DENSE = [("b05 nq=8^3 kron", 512, 343, NELMT // 8192, 8192),
            ("b05 nq=8^3 kron_coalesced", 512, 343, 1, NELMT),
            ("b04 nq=16^2 kron", 256, 225, B04_NELMT // 8192, 8192),
            ("b04 nq=32^2 kron", 1024, 961, B04_NELMT // 8192, 8192)]
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


def k1_sweep(rnd, tag, itemsize, rows=(), nelmt=None,
             back_to_back=False) -> None:
    for label, nm0, nrq, nq0, nkj, e in K1_SHAPES:
        if rows and not any(r in label for r in rows):
            continue
        e = nelmt or e
        x, b0, c = rnd(nm0 * nrq, e), rnd(nm0, nq0), rnd(nkj, nrq)
        settings = k1.qp_settings(itemsize, nm0, nrq, nq0, nkj)

        def call(v):
            return k1.qp_shared3d_flat(
                x, b0, c, nrq=nrq, epb=v.et, planes=v.planes, depth=v.depth,
                threads=v.threads, body=v.body, where=v.c12t,
                stage1=v.stage1)

        times = in_turns(call, settings)
        if back_to_back:
            for v in (*settings, *reversed(settings)):
                times[v].append(run_ms(lambda: call(v), K1_CALLS, runs=3))
        report(f"{tag} {label} E={e}",
               "K1 (element tile, planes, depth, threads, body, C12T, "
               "stage 1)" + (": flushed, flushed, back to back, back to "
                             "back" if back_to_back else ""), times,
               k1.qp_config(itemsize, nm0, nrq, nq0, nkj))
        best = min(times, key=lambda v: min(times[v][:2]))
        print(f"{tag} {label} K1 best {best}: {min(times[best][:2]):.4f} ms",
              flush=True)
        del x
        torch.cuda.empty_cache()
    print(f"{tag} K1 launches by depth: {dict(sorted(k1.qp_depths.items()))}",
          flush=True)
    print(f"{tag} K1 launches by (dtype, body): "
          f"{dict(sorted(k1.qp_bodies.items()))}", flush=True)
    print(f"{tag} K1 launches by (dtype, stage-1 body): "
          f"{dict(sorted(k1.qp_stage1_bodies.items()))}", flush=True)
    print(f"{tag} K1 DMMA launches by where C12T lived: "
          f"{dict(sorted(k1.qp_dmma_c12t.items()))}", flush=True)


def probe_shares(before, after) -> dict:
    """K1's probe readings over the probed launches between two qp_phases
    readings (`before` None where none ran before), under the names of the
    qp cells' metrics (port_bench/metrics): qp_wait_pct, qp_stage1_pct and
    qp_stage2_pct, 100 x the phase's SM cycles over the blocks'; rest, 100
    less those three, thread 0's share of the block outside the phases;
    and qp_slot_idle_pct of the newest launch, None where the buffer holds
    fewer block records than that launch had blocks."""
    from port_bench.qp_probe import slot_idle_pct

    cycles = {phase: after["cycles"][phase]
              - (before["cycles"][phase] if before else 0)
              for phase in k1.QP_PHASES}
    shares = {f"qp_{phase}_pct": 100 * cycles[phase] / cycles["block"]
              for phase in ("wait", "stage1", "stage2")}
    shares["rest"] = 100 - sum(shares.values())
    shares["qp_slot_idle_pct"] = (
        slot_idle_pct(after["blocks"], after["slots"])
        if len(after["blocks"]) == after["grid"] else None)
    return shares


def probe_cost(gen) -> None:
    """K1's plain form beside its probe form at PROBE_SHAPES (the least
    flushed time of each, PROBE_ROUNDS rounds in turns), and the probe's
    readings of each shape's probed launches (probe_shares)."""
    before = k1.qp_phases()
    for label, dtype, nm0, nrq, nq0, nkj, e in PROBE_SHAPES:
        x, b0, c = (torch.randn(*shape, generator=gen, device="cuda",
                                dtype=dtype)
                    for shape in ((nm0 * nrq, e), (nm0, nq0), (nkj, nrq)))
        forms = {"plain": k1.qp_shared3d_flat, "probe": k1.qp_probed}
        times = {name: [] for name in forms}
        for _ in range(PROBE_ROUNDS):
            for name, ts in in_turns(
                    lambda name: forms[name](x, b0, c, nrq=nrq),
                    tuple(forms)).items():
                times[name] += ts
        report(label, "K1 form", times)
        best = {name: min(ts) for name, ts in times.items()}
        print(f"{label} K1 {k1.qp_config(dtype.itemsize, nm0, nrq, nq0, nkj)}"
              f" probe cost: {100 * (best['probe'] / best['plain'] - 1):+.3f}"
              f"% ({best['probe']:.4f} ms against {best['plain']:.4f})",
              flush=True)
        after = k1.qp_phases()
        print(f"{label} K1 probe phases: "
              + ", ".join(f"{name} {'None' if v is None else f'{v:.2f}'}"
                          for name, v in probe_shares(before, after).items()),
              flush=True)
        before = after
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
    for label, m, k, chunks, n in K2_DENSE:
        x, c = rnd(chunks, k, n), rnd(m, k)
        off = torch.empty(x.numel() + 1, dtype=x.dtype,
                          device=x.device)[1:].view(x.shape)
        off.copy_(x)
        # {body: the input dense_body sends to it}
        inputs = {k2.dense_body(t.dtype, n, t.data_ptr()): t
                  for t in (off, x)}
        times = in_turns(lambda v: k2.kron_blocked(inputs[v], c, strip=0),
                         list(inputs))
        report(f"{tag} {label}", "K2 dense body", times,
               k2.dense_body(x.dtype, n, x.data_ptr()))
        print(f"{tag} {label} torch.matmul "
              f"{event_ms(lambda: torch.matmul(c, x)):.4f} ms", flush=True)
        del x, off, inputs
        torch.cuda.empty_cache()
    print(f"{tag} K2 dense launches by (dtype, body): "
          f"{dict(sorted(k2.dense_bodies.items()))}", flush=True)


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
        settings = k1.qp2_unrolls(itemsize, nm0)
        times = in_turns(lambda v: k1.qp_stage2_3d(w, b0, unroll=v),
                         settings)
        report(f"{tag} {label} E={e}", "K4 unroll", times,
               min(k1.QP2_UNROLL, settings[-1]))
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


# The host sweep's rows: (label, benchmark, prepare's arguments, dtypes),
# and each benchmark's library column that its hand columns are set
# beside (b03: by column).
HOST_ROWS = [
    ("b05 nq=8^3 E=131072", "benchmark05", (8, 8, 8, NELMT), ("f32", "f64")),
    ("b04 nq=8^2 E=1048576", "benchmark04", (8, 8, B04_NELMT),
     ("f32", "f64")),
    ("b04 nq=2^2 E=1048576", "benchmark04", (2, 2, B04_NELMT), ("f32",)),
    ("b01 n=2^20", "benchmark01", (2**20,), ("f32",)),
    ("b01 n=536870912", "benchmark01", (536870912,), ("f32",)),
    ("b02 n=2^20", "benchmark02", (2**20,), ("f32",)),
    ("b02 n=536870912", "benchmark02", (536870912,), ("f32",)),
    ("b03 1024^2", "benchmark03", (1024,), ("f32",)),
    ("b03 16384^2", "benchmark03", (16384,), ("f32",)),
]
HOST_LIBRARY = {"benchmark05": "XLA(GEMM)", "benchmark04": "XLA(GEMM)",
                "benchmark01": "XLA(dot)", "benchmark02": "XLA(donate)",
                "benchmark03": {"Pallas(vpu)": "XLA(gemv-rm)",
                                "Pallas(mxu)": "XLA(gemv-cm)"}}
# Calls of one enqueue measurement, in batches, each batch enqueued while
# the card spins for SLEEP_CYCLES (about 10 ms), so no call waits on it
# and the launch queue never fills; reps of each measurement (the least
# is kept) and of the host-clock column time.
ENQUEUE_CALLS = 200
ENQUEUE_BATCH = 50
SLEEP_CYCLES = 20_000_000
HOST_REPS = 2
HOST_TESTS = 20
# rounds of paired_us, whose medians it reports
HOST_PAIRED = 60


def enqueue_us(fn) -> float:
    """Least host µs to enqueue one fn(), over HOST_REPS runs of
    ENQUEUE_CALLS calls made while the card is busy (time.perf_counter_ns
    around each batch, the card spinning ahead of it)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(HOST_REPS):
        total = 0
        for _ in range(ENQUEUE_CALLS // ENQUEUE_BATCH):
            torch.cuda._sleep(SLEEP_CYCLES)
            t0 = time.perf_counter_ns()
            for _ in range(ENQUEUE_BATCH):
                fn()
            total += time.perf_counter_ns() - t0
        torch.cuda.synchronize()
        best = min(best, total / ENQUEUE_CALLS / 1e3)
    return best


def captured_launches(fn) -> tuple:
    """(fn()'s output, the (name, x, args) of every build.run it made):
    one call with build.run recording its arguments as it launches."""
    calls, run = [], build.run

    def recording(name, x, *args):
        calls.append((name, x, args))
        run(name, x, *args)

    build.run = recording
    try:
        out = fn()
    finally:
        build.run = run
    torch.cuda.synchronize()
    return out, calls


def launch_parts(fn) -> dict:
    """A hand column's enqueue µs in parts, each timed as enqueue_us: the
    wrapper's Python (checks, rules, allocations) with build.run made a
    no-op; build.run alone, replaying the arguments one call gave it
    (entry lookup, device context, stream and the ctypes call); and the
    ctypes call alone with the stream fetched once (the C launcher and its
    CUDA runtime calls).  The replays write where the captured call did,
    whose output is kept alive meanwhile."""
    out, calls = captured_launches(fn)
    run = build.run
    build.run = lambda name, x, *args: None
    try:
        wrapper = enqueue_us(fn)
    finally:
        build.run = run
    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream
    entries = [(getattr(lib, f"tbt_{name}_{build.SUFFIXES[x.dtype]}"), args)
               for name, x, args in calls]

    def replay():
        for name, x, args in calls:
            build.run(name, x, *args)

    def ctypes_only():
        for entry, args in entries:
            entry(*args, stream)

    parts = dict(wrapper=wrapper, run=enqueue_us(replay),
                 ctypes=enqueue_us(ctypes_only), launches=len(calls))
    del out
    return parts


def paired_us(fn, flush) -> tuple:
    """Medians in µs over HOST_PAIRED rounds, each of three calls of fn()
    with the L2 flushed before each: (host clock - events, idle events -
    events, host clock - idle events).  The host clock is time_variant's
    window (the card idle, synchronized before and after); the events are
    event_ms's (the card spinning while fn is enqueued, so they hold the
    device time alone); the idle events are recorded around fn with the
    card idle, so they also hold fn's enqueue and its launch.  Taking the
    three in each round and the median keeps the spread of the device
    time from call to call out of the differences, which the least of each
    protocol over separate calls keeps in."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)

    def window(spin):
        flush()
        if spin:
            torch.cuda._sleep(ENQUEUE_CYCLES)
        else:
            torch.cuda.synchronize()
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) * 1e3

    over, launch, tail = [], [], []
    for _ in range(HOST_PAIRED):
        flush()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        fn()
        torch.cuda.synchronize()
        host = (time.perf_counter_ns() - t0) / 1e3
        events, idle = window(True), window(False)
        over.append(host - events)
        launch.append(idle - events)
        tail.append(host - idle)
    return tuple(statistics.median(v) for v in (over, launch, tail))


def host_sweep(only_rows=None) -> None:
    """What each column costs the host: at every row of HOST_ROWS, each
    column's enqueue µs (enqueue_us), its time as the benchmarks take it
    (time_variant, L2 flushed, least of HOST_TESTS) and its device time by
    CUDA events (event_ms), each twice in turns and the least kept, whose
    difference is the host's share of the column's time, and the same
    share as paired_us's median with its parts; for each hand column its
    enqueue in parts (launch_parts) and its library column's figures
    beside it.  `only_rows`: parts of the labels of the rows to run.  Only
    the benchmarks' own prepare and variant_specs and build.run are used,
    so it runs on any tree of the port."""
    import importlib

    from tpu_bench_torch.core.config import Config

    lib = build.library()
    device = torch.device("cuda")
    x = torch.empty(1024, device=device)

    def in_context():
        with torch.cuda.device(x.device):
            pass

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    primitives = [
        ("ctypes call of tbt_error_string(0)",
         lambda: lib.tbt_error_string(0)),
        ("torch.cuda.device(x.device) entered and left", in_context),
        ("torch.cuda.current_stream().cuda_stream",
         lambda: torch.cuda.current_stream().cuda_stream),
        ("torch.cuda.current_device()", torch.cuda.current_device),
        ("torch.cuda.get_device_properties(x.device)",
         lambda: torch.cuda.get_device_properties(x.device)),
        ("x.device", lambda: x.device),
        ("x.get_device()", x.get_device),
        ("x.data_ptr()", x.data_ptr),
        ("torch.empty(1024, device=x.device)",
         lambda: torch.empty(1024, device=x.device)),
        ("torch.empty_like(x)", lambda: torch.empty_like(x)),
    ]
    if raw is not None:
        primitives.append(("torch._C._cuda_getCurrentRawStream(0)",
                           lambda: raw(0)))
    for name, fn in primitives:
        print(f"host primitive {name}: {enqueue_us(fn):.3f} us", flush=True)
    flush = L2Flush(device)
    for label, module, prep, dtypes in HOST_ROWS:
        if only_rows and not any(r in label for r in only_rows):
            continue
        bench = importlib.import_module(
            f"tpu_bench_torch.benchmarks.{module}")
        for tag in dtypes:
            cfg = Config(dtype=getattr(torch, {"f32": "float32",
                                               "f64": "float64"}[tag]))
            data = bench.prepare(*prep, cfg)
            rows = {}
            with cfg.library_precision():
                for name, fn, keys, *_ in bench.variant_specs(data, cfg):
                    args = tuple(data[k] for k in keys)

                    def call(fn=fn, args=args):
                        return fn(*args)

                    # host clock and events in turns: b c c b
                    host = [time_variant(call, HOST_TESTS, device, flush)]
                    events = [event_ms(call), event_ms(call)]
                    host.append(time_variant(call, HOST_TESTS, device,
                                             flush))
                    rows[name] = dict(enqueue=enqueue_us(call),
                                      host_ms=min(host) * 1e3,
                                      events_ms=min(events),
                                      paired=paired_us(call, flush))
                    if name.startswith("Pallas"):
                        rows[name].update(launch_parts(call))
                    del args
                    torch.cuda.empty_cache()
            for name, r in rows.items():
                over = (r["host_ms"] - r["events_ms"]) * 1e3
                line = (f"host {tag} {label} {name}: enqueue "
                        f"{r['enqueue']:.2f} us, host clock "
                        f"{r['host_ms']:.4f} ms, events {r['events_ms']:.4f}"
                        f" ms, overhead {over:.2f} us; paired medians: "
                        "overhead {:.2f}, idle events - events {:.2f}, "
                        "host - idle events {:.2f} us".format(*r["paired"]))
                if "wrapper" in r:
                    lib_name = HOST_LIBRARY[module]
                    if isinstance(lib_name, dict):
                        lib_name = lib_name[name]
                    ref = rows[lib_name]
                    ref_over = (ref["host_ms"] - ref["events_ms"]) * 1e3
                    line += (f" (wrapper {r['wrapper']:.2f}, build.run "
                             f"{r['run'] - r['ctypes']:.2f}, ctypes and C "
                             f"{r['ctypes']:.2f} us over {r['launches']} "
                             f"launches); {lib_name} enqueue "
                             f"{ref['enqueue']:.2f} us, overhead "
                             f"{ref_over:.2f} us; hand - library: enqueue "
                             f"{r['enqueue'] - ref['enqueue']:+.2f} us, "
                             f"overhead {over - ref_over:+.2f} us, paired "
                             f"{r['paired'][0] - ref['paired'][0]:+.2f} us")
                print(line, flush=True)
            del data
            torch.cuda.empty_cache()


# The ring sweep's uses: (label, ring use, elements) at their main sizes,
# the ceilings' buffer for K12 and benchmark02's top size for K7.
RING_SHAPES = [("K12 copy_manual", "copy", 128 * 2**20),
               ("K12 scale_manual", "scale", 128 * 2**20),
               ("K12 triad_manual", "triad", 128 * 2**20),
               ("K7 add_inplace_manual", "add", 536870912)]


def ring_sweep(rnd, tag) -> None:
    """K12's and K7's 16-byte form at their main sizes: the library call
    computing the same function, the use's default call, and where the
    tree has the cp.async.bulk ring (kernels/ring.py) every (chunk, depth)
    of ring.settings through the kernel's C entry, in turns; `*` marks
    ring.RING's.  On a tree without the ring only the first two run, so
    the first design is timed by running this sweep on that tree."""
    try:
        from tpu_bench_torch.kernels import ring
    except ImportError:
        ring = None
    for label, use, n in RING_SHAPES:
        x, y, c = rnd(n), rnd(n), rnd(1, 1)
        out = torch.empty_like(x)
        alpha = float(c)
        default = {"copy": lambda: stream.copy_manual(x, out=out),
                   "scale": lambda: stream.scale_manual(x, c),
                   "triad": lambda: stream.triad_manual(x, y, c),
                   "add": lambda: stream.add_inplace_manual(x, y)}[use]
        library = {"copy": lambda: out.copy_(x),
                   "scale": lambda: x.mul_(c.reshape(())),
                   "triad": lambda: x.add_(y, alpha=alpha),
                   "add": lambda: x.add_(y)}[use]
        settings = ["library", "default"]
        if ring is not None:
            settings += ring.settings(use)

        def fn(v):
            if v == "library":
                return library()
            if v == "default":
                return default()
            if use == "add":
                return build.run("map2_inplace", x, x.data_ptr(),
                                 y.data_ptr(), n, 1, *v)
            src = out if use == "copy" else x
            return build.run("stream_map", x, src.data_ptr(), x.data_ptr(),
                             y.data_ptr(), c.data_ptr(), n,
                             ring.MAP_OPS[use], *v)

        chosen = ring.RING[use] if ring is not None else None
        report(f"{tag} {label} n={n}", "ring (chunk, depth)",
               in_turns(fn, settings), chosen)
        del x, y, out
        torch.cuda.empty_cache()


SWEEPS = ("k1", "k2", "k3", "k4", "k4diag", "k5", "k8", "k9", "host", "ring")
# The sweeps run in bf16: K1-K5's, the kernels built for it.
BF16_SWEEPS = ("k1", "k2", "k3", "k4", "k5")
DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default=",".join(SWEEPS),
                        help=f"comma-separated sweeps of {SWEEPS}")
    parser.add_argument("--uses", action="store_true",
                        help="time K3's uses and K9 instead of sweeping")
    parser.add_argument("--rows", default="",
                        help="host and K1 sweeps: comma-separated parts of "
                        "the row labels to run (e.g. b02, 32^2), all by "
                        "default")
    parser.add_argument("--nelmt", type=int, default=None,
                        help="K1 sweep: elements of every shape (default: "
                        "each shape's own)")
    parser.add_argument("--back-to-back", action="store_true",
                        help="K1 sweep: also time each setting over "
                        "calls back to back")
    parser.add_argument("--probe", action="store_true",
                        help="with --only k1: K1's plain form beside its "
                        "probe form at the benchmark's qp cells' shapes")
    parser.add_argument("--dtype", default="f32,f64",
                        help="comma-separated element types of the sweeps "
                        f"({', '.join(DTYPES)}); bf16 runs {BF16_SWEEPS} "
                        "only")
    args = parser.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= set(SWEEPS):
        parser.error(f"--only: {sorted(only - set(SWEEPS))} not in {SWEEPS}")
    if args.probe and only != {"k1"}:
        parser.error("--probe goes with --only k1")
    tags = args.dtype.split(",")
    if not set(tags) <= set(DTYPES):
        parser.error(f"--dtype: {sorted(set(tags) - set(DTYPES))} not in "
                     f"{tuple(DTYPES)}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_blocks: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    rows = [r for r in args.rows.split(",") if r]
    if "host" in only and not args.uses:
        host_sweep(rows)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.probe:
        probe_cost(gen)
        return
    for dtype in (DTYPES[t] for t in tags):
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device="cuda",
                               dtype=dtype)

        tag = str(dtype)[6:]
        runs = only
        if dtype == torch.bfloat16:
            if args.uses:
                continue
            runs = only & set(BF16_SWEEPS)
        if args.uses:
            uses(rnd, tag)
            continue
        if "k1" in runs:
            k1_sweep(rnd, tag, dtype.itemsize, rows, args.nelmt,
                     args.back_to_back)
        if "k2" in runs:
            k2_sweep(rnd, tag, dtype.itemsize)
        if "k3" in runs:
            k3_sweep(rnd, tag, dtype.itemsize)
        if "k4" in runs:
            k4_sweep(rnd, tag, dtype.itemsize)
        if "k4diag" in runs:
            k4diag(rnd, tag, dtype.itemsize)
        if "k5" in runs:
            k5_sweep(rnd, tag)
        if "k8" in runs:
            k8_sweep(rnd, tag, dtype.itemsize)
        if "k9" in runs:
            k9_sweep(rnd, tag, dtype.itemsize)
        if "ring" in runs:
            ring_sweep(rnd, tag)


if __name__ == "__main__":
    main()
