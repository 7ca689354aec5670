#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tpu_bench_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.  It
builds the hand kernels from the checkout's sources and drives the port's
paths through the entry points a user calls: the headline (benchmark05's
three headline columns at nq=8^3, nelmt=131072, f32), the ceilings CLI,
the benchmark05 and benchmark04 CLIs, each with all eleven columns, also
with the f64 Pallas(Coales) column on the split-mantissa route
(`--f64-coales ozaki`), and the benchmark01, 02 and 03 CLIs, each with all
five.  Every phase is fatal:

1. device facts (nvidia-smi, torch, nvcc, device properties);
2. build of K1 (qp_fused3d), K2 (kron_blocked), K3 (em_gemm),
   K4 (qp_stage2_3d), K5 (qp1d_fused3d, two-stage entry qp1d_fused2d),
   K6 (sumsq), K7 (map2_inplace), K8 (matvec_rm), K9 (matvec_cm), K10
   (stream_read), K11 (stream_fill), K12 (stream_map), K13
   (stream_expand) and K14 (ozaki_slices) with nvcc for sm_90a, one
   process per source; ptxas must report no spills in the tensor-core
   kernels K14, K5 and the dense GEMM that K2 and K3 share, nor in K1,
   K2's C-resident and K3's S-resident configurations, K4 (every nm0
   instance), K8, K9 and the cp.async.bulk rings of K12 and K7 (f32 and
   f64; K1-K5 in bf16 too) nor in K1's probe form (P = true), and
   `cuobjdump -sass` must show HMMA in K14 and in the f32 and bf16
   entries of K5 and of K2's and K3's dense GEMM on mma.sync, HGMMA on
   TF32 in K2's f32 dense body on wgmma, DMMA in K5's f64 entry,
   sm_90's m16n8k8 (DMMA.16x8x8) and no m8n8k4 in the dense GEMM's f64
   entries and in K1's f64 instances on its DMMA stage-2 body (C12T
   staged, C12T held in registers, and C12T held with stage 1 on DMMA
   too, each), no DMMA
   in K1's f32 instances, the bf16 m16n8k16 with f32 sums
   (HMMA.16816.F32.BF16) in K1's bf16 instances on its HMMA stage-2
   body and no HMMA in K1's f32 and f64 instances nor in its bf16 SIMT
   ones, HGMMA on TF32 in K1's f32 instances on its TF32 stage-2 body
   (3xTF32 on wgmma) and no HGMMA in K1's other instances, the bulk copy
   (UBLKCP) in the rings, and no
   read of the SM clock or %globaltimer in K1's plain instances (P =
   false), where its probe instances read both; with `--parent-build-log
   <build.log of the parent tree>`, K1's plain instances' ptxas lines
   (registers, stack, spills) must equal the parent's, instance for
   instance, for every instance the parent has;
3. each kernel, in each of its uses, and the two-kernel Pallas(QP) and
   multi-launch Pallas(QP-1D) compositions against their plain PyTorch
   versions on the card, on random inputs in f32 and f64 (f32 to 1e-5,
   K6's f32 sums to 1e-4, f64 to 1e-12, relative to the largest output):
   the benchmark05 uses at nq 4^3, 8^3, 10^3 and (3,4,5), E=1000 (ragged)
   and 131072; the benchmark04 uses at nq (2,2), (8,8), (10,12), (16,16)
   and (32,32), E=1000 and 1,048,576; the K6 and K7 uses at n = 1000 (x
   and y placed differently against 16-byte boundaries), 1,048,579 and
   536,870,912 (K7 bit for bit); K8 and K9 at (1000, 777), (777, 1000),
   (4096, 16384), (16384, 4096) and (16384, 16384); the seven ceiling
   probes of K10-K13 (expand at m = 2, 4 and 8) at n = 128*8 (one chunk),
   128*64 and 128*24 in chunks of 8 rows (more chunks than the ring's
   depth, and exactly depth), 128*64 with x and y off a 16-byte boundary,
   and the ceilings' 134,217,728 (copy, scale, fill, expand and the token
   bit for bit); K14's pair and band forms bit for bit in hi and lo on
   slices of random f64 operands at b04 nq=8^2, E = 1,048,576 and b05
   nq=8^3, E = 131072, the recombined product within 5e-14 of K2 in
   double, and kron_coalesced at b04 nq=8^2 and b05 nq=8^3 in f32 and
   f64; K14, K5 (f32, and f64 timed apart) and the dense configurations
   of K2 and K3 at their main shapes with the rate they reach and their
   units' peak time (K2's f32 on both its bodies: wgmma, and mma.sync
   through Pallas(Coales)'s input copied off a 16-byte boundary, a use
   of its own held against its plain version at every shape above); K1-K4 in f64 at b05 nq=8^3 timed beside
   torch.matmul in f64, and K8 at every matvec shape beside torch.mv.  At
   each path's main shapes (b05 nq=8^3, E=131072; b04 nq=8^2,
   E=1,048,576; f32; b01/b02 n = 536,870,912 and b03 16384^2, f32 and
   f64; the probes at 134,217,728, f32; K14 at b04 nq=8^2, E=1,048,576
   and b05 nq=8^3, E=131072, against torch.matmul in f64; kron_coalesced
   at the same shapes, f32), and for the b04 uses of B04_USES at their
   own order, each use is timed beside its plain version, one library
   call and its bound, with what one call costs the host beside the
   library call's (the µs to enqueue it, and the host clock's time minus
   the events'; printed, not held); then every column's f64 golden norm
   of the benchmark data (b05 nq=8^3 and b04 nq=8^2, nelmt=128; b01 and
   b02 at 1024, b02 after 40 accumulating calls; b03 at 128), device_x
   and device_y built on the card against utils/native.py bit for bit,
   and every b04 column in f32 at (10, 12) and (12, 10) against the f64
   oracle; and every K1-K5 use in bf16 against its plain version (the
   same cast points, computed in f32) at the b05 and b04 orders above, E
   = 1000, 131071 and the main size: elementwise within 2^-7 of the
   largest output, norms within 1e-4; timed at the main shapes beside its
   plain version, the library call in bf16 and its bound (bytes at 2 a
   value, FLOP at the bf16 tensor cores' rate);
4. the headline (`python -m tpu_bench_torch.bench`): K1's and K2's launch
   counts must rise during it, and the three columns' norms must agree
   with each other and with the f64 oracle to 5e-4;
5. the ceilings (`python -m tpu_bench_torch.benchmarks.ceilings`) at their
   defaults: K6, K7 and K10-K13 must each launch, and no other; the
   JSON line must carry the JAX CLI's keys, and every measured rate must
   be > 0 and at most the HBM rate (+5%);
6. the benchmark05 CLI (`python -m tpu_bench_torch.benchmarks.benchmark05
   8 8 8`), an f32 sweep to nelmt 131072 and a short f64 sweep;
7. the benchmark04 CLI (`python -m tpu_bench_torch.benchmarks.benchmark04
   8 8`), an f32 sweep to nelmt 1,048,576 and a short f64 sweep;
8. the benchmark05 (8 8 8) and benchmark04 (8 8) CLIs with `--dtype f64
   --f64-coales ozaki`, nelmt 128 to 131072 in steps of x32: the golden
   norms at nelmt 128 in every column, and K14 launched;
9. benchmark04 at nelmt 1,048,576 at every order of scripts/run04.sh
   (2 .. 32) and at (10, 12), f32 and f64;
10. the benchmark01, 02 and 03 CLIs, f32 over the reference's sweeps (to
   536,870,912 and 16384) and f64 over every 32nd size to the same tops;
11. the benchmark05 (8 8 8) and benchmark04 (8 8) CLIs with `--dtype
   bf16`, nelmt 128 to 131072 and 1,048,576 in steps of x2: only the
   bf16 instances of K1-K5 launch, the rows agree to 5e-2, and at nelmt
   128 every hand column is within 1e-4 of the JAX package's committed
   bf16 log (artifacts/bf16), but b04 Pallas(QP/Shared), whose JAX kernel
   rounds elsewhere (ROADMAP Queue 3); then K1 in bf16 at nq=6^3,
   nelmt 256 within 5e-4 of the f64 oracle.

Each kernel against its plain version at its edge cases and in every
configuration it is built for (K1's tiles, plane groups and slab rings,
K2's strips, K3's tile heights, K4's and K8's unrolls, the rings of K12
and K7, K14's tile edges), and the shared memory the configuration rules
count against the library's own, is held by the `cuda` tests, not here:
README.md's `pytest ... -m cuda` line runs them.

In phases 6-10 the kernels of the sweep's own set must each launch, and no
other; the logs must parse with postprocess/common.py with every column
> 0, and the norms of each row must agree to 5e-4 (f32), 1e-10 (f64) and
5e-2 (bf16, phase 11).
Once a row's operands exceed twice the L2, at an isotropic order, no
column may read above the honesty cap of phase 5's ceilings for its
traffic mix (core/roofline.honesty_cap_mix, honesty_cap_bwdtrans; +5%),
nor, in phase 10, above the HBM rate (+5%).

The line before the last is a JSON object with each kernel use's launches
in its path's run (the ceilings run of phase 5, the b05 or b04 sweep of
phase 6, 7 or 8, phase 9's run at the use's order, the b01-b03 sweep of
phase 10 in the use's dtype, or the bf16 sweep of phase 11 for the bf16
uses, listed apart; K14's band form and kron_coalesced, which no
CLI runs, in one call of each at b05 nq=8^3 in phase 3), its error, its
time beside its plain version's and a library call's, and its bound; the
last line is
{"ok": true, "device": {...}}.  Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import ast
import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import Callable, NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_NQ8_NELMT128 = 189.3141665  # reference benchmark05/nq8x8x8.log
GOLDEN_B04_NQ8_NELMT128 = 29.12205853  # reference benchmark04/nq8x8.log
RTOL = {"float32": 1e-5, "float64": 1e-12, "bfloat16": 2**-7}
# bf16 against its plain version: a bf16 rounding that falls the other
# side of a tie on f32 sums taken in another order moves a value by one
# bf16 ulp (2^-8 of it: RTOL's 2^-7 of the largest output); the norm
# averages those out (a wrong cast point moves it by 3e-4 to 7e-4)
BF16_NORM_RTOL = 1e-4
# the JAX package's committed bf16 logs (TPU), whose nelmt 128 row phase 11
# holds the hand columns to, and the one column whose JAX kernel rounds
# elsewhere (b04 qp_shared; ROADMAP Queue 3)
BF16_LOGS = {"benchmark05": "artifacts/bf16/b05/nq8x8x8.log",
             "benchmark04": "artifacts/bf16/b04/nq8x8.log"}
BF16_EXEMPT = {"benchmark04": {"Pallas(QP/Shared)"}}
HEADLINE_NELMT = 131072
B04_NELMT = 1048576  # the reference sweep's largest size
RUN04_ORDERS = (2, 4, 6, 8, 10, 12, 14, 16, 32)  # scripts/run04.sh
B04_MAIN = (8, 8)
# phase 9's orders: run04.sh's, and (10, 12), where the JAX package's f32
# Pallas(QP/Shared) runs qp_w_flat (ROADMAP Queue 3)
B04_ORDERS = [(nq, nq) for nq in RUN04_ORDERS] + [(10, 12)]
# Published H100 SXM rates (NVIDIA's data sheet) for the bounds.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12  # outside the tensor cores
BT2D_CU = "tpu_bench_torch/csrc/bwdtrans2d.cu"
BT3D_CU = "tpu_bench_torch/csrc/bwdtrans3d.cu"
QP1D_CU = "tpu_bench_torch/csrc/qp1d_fused3d.cu"
PL2D = "tpu_bench/kernels/bwdtrans2d.py"
# benchmark05's kernels: name: (its source, the TPU kernel it replaces, the
# use whose time stands in the kernels line)
KERNELS = {
    "qp_fused3d": (BT3D_CU, "tpu_bench/kernels/bwdtrans3d.py:137",
                   "K1 qp_shared3d_flat"),
    "kron_blocked": (BT2D_CU, f"{PL2D}:113", "K2 kron_blocked (Coales)"),
    "em_gemm": (BT2D_CU, f"{PL2D}:551", "K3 kron_elem_major (Uncoales)"),
    "qp_stage2_3d": (BT3D_CU, "tpu_bench/kernels/bwdtrans3d.py:198",
                     "K4 qp_stage2_3d (QP stage 2)"),
    "qp1d_fused3d": (QP1D_CU, "tpu_bench/kernels/bwdtrans3d.py:250",
                     "K5 qp1d_shared3d (QP-1D/Shared)"),
}
# benchmark04's kernel uses: (entry of the kernels line, kernel launched,
# its source, the TPU kernel it replaces, the use timed in phase 3, the
# order where it is timed and its launches counted).  The port runs one
# kernel per column at every order; the JAX package's f32 dispatch
# (tpu_bench/benchmarks/benchmark04.py:94-143) picks another TPU kernel for
# Pallas(Coales) at nq=2 and for Pallas(QP/Shared) from nq=10, so those
# entries read the same use at the order where that TPU kernel runs.
K1_2D, K2_COALES = "K1 qp_shared3d (QP/Shared)", "K2 kron_wide4 (Coales)"
B04_USES = [
    ("kron_blocked (b04 kron_wide4)", "kron_blocked", BT2D_CU,
     f"{PL2D}:164", K2_COALES, B04_MAIN),
    ("kron_blocked (b04 kron_vpu_blocked, nq=2)", "kron_blocked", BT2D_CU,
     f"{PL2D}:211", K2_COALES, (2, 2)),
    ("qp_fused3d (b04 qp_shared)", "qp_fused3d", BT3D_CU, f"{PL2D}:265",
     K1_2D, B04_MAIN),
    ("qp_fused3d (b04 qp_w_flat, nq=(10,12))", "qp_fused3d", BT3D_CU,
     f"{PL2D}:377", K1_2D, (10, 12)),
    ("qp_fused3d (b04 qp_w, nq=16)", "qp_fused3d", BT3D_CU, f"{PL2D}:314",
     K1_2D, (16, 16)),
    ("qp_fused3d (b04 qp_mxu_grouped, nq=32)", "qp_fused3d", BT3D_CU,
     f"{PL2D}:505", K1_2D, (32, 32)),
    ("kron_blocked (b04 qp_global stage 1)", "kron_blocked", BT2D_CU,
     f"{PL2D}:441", "K2 kron_blocked (QP stage 1)", B04_MAIN),
    ("qp_stage2_3d (b04 qp_global stage 2)", "qp_stage2_3d", BT3D_CU,
     f"{PL2D}:441", "K4 qp_stage2 (QP stage 2)", B04_MAIN),
    ("em_gemm (b04 kron_elem_major)", "em_gemm", BT2D_CU, f"{PL2D}:551",
     "K3 kron_elem_major (Uncoales)", B04_MAIN),
    ("em_gemm (b04 _one_stage_em stage 1)", "em_gemm", BT2D_CU,
     f"{PL2D}:614", "K3 one_stage_em (QP-1D stage 1)", B04_MAIN),
    ("em_gemm (b04 _one_stage_em stage 2)", "em_gemm", BT2D_CU,
     f"{PL2D}:614", "K3 one_stage_em (QP-1D stage 2)", B04_MAIN),
    ("qp1d_fused2d (b04 qp1d_shared)", "qp1d_fused2d", QP1D_CU,
     f"{PL2D}:580", "K5 qp1d_fused (QP-1D/Shared)", B04_MAIN),
]
B04_KERNELS = {kernel for _, kernel, *_ in B04_USES}
# Benchmarks 01-03: the largest sizes of their sweeps, the sizes and
# shapes each use is checked at in phase 3, and the reference logs' f64
# norms (benchmark01/outfile.log, benchmark02/outfile.log after 40
# accumulating additions, benchmark03/outfile.log).
STREAM_N = 536870912
MATVEC_N = 16384
# (m, n) of A; K9 runs on A_cm (n, m), in scalar loads at (777, 1000)
MATVEC_SHAPES = ((1000, 777), (777, 1000), (4096, 16384), (16384, 4096),
                 (MATVEC_N, MATVEC_N))
GOLDEN_B01_1024 = 231.3925755
GOLDEN_B02_1024 = 5979.883197
GOLDEN_B03_128 = 1053.208334
# K6's f32 sum runs through serial per-thread sums of up to about 500
# terms (n / (MAX_BLOCKS * 256 threads * 4 accumulators) at 536,870,912),
# whose rounding is bounded by about 500 * 2**-24 = 3e-5, then a tree;
# the plain torch.sum rounds too.  1e-4, under the package's 5e-4.
SUM_RTOL_F32 = 1e-4
RED_CU = "tpu_bench_torch/csrc/reduction.cu"
STREAM_CU = "tpu_bench_torch/csrc/stream.cu"
MV_CU = "tpu_bench_torch/csrc/matvec.cu"
PL = "tpu_bench/kernels"
DF2 = f"{PL}/df2stream.py"
# benchmarks 01-03's kernel uses: (entry of the kernels line, kernel
# launched, its source, the TPU kernel it replaces, the use timed in phase
# 3, the dtype of the timing and of the sweep its launches come from).
# The JAX package runs its f64 columns on (hi, lo) f32 pairs (df2stream);
# the port runs the same kernels built in double.
STREAM_USES = [
    ("sumsq (b01 sumsq_two_pass)", "sumsq", RED_CU, f"{PL}/reduction.py:67",
     "K6 sumsq_two_pass", "float32"),
    ("sumsq (b01 sumsq_wide)", "sumsq", RED_CU, f"{PL}/reduction.py:108",
     "K6 sumsq_wide", "float32"),
    ("sumsq (b01 sumsq_functor)", "sumsq", RED_CU,
     f"{PL}/reduction.py:108", "K6 sumsq_functor", "float32"),
    ("map2_inplace (b02 add_inplace)", "map2_inplace", STREAM_CU,
     f"{PL}/axpy.py:38", "K7 add_inplace", "float32"),
    ("map2_inplace (b02 add_inplace_manual)", "map2_inplace", STREAM_CU,
     f"{PL}/stream.py:120", "K7 add_inplace_manual", "float32"),
    ("map2_inplace (b02 map2_inplace)", "map2_inplace", STREAM_CU,
     f"{PL}/axpy.py:38", "K7 map2_inplace", "float32"),
    ("matvec_rm (b03 matvec_vpu)", "matvec_rm", MV_CU, f"{PL}/matvec.py:46",
     "K8 matvec_rm", "float32"),
    ("matvec_cm (b03 matvec_mxu)", "matvec_cm", MV_CU, f"{PL}/matvec.py:85",
     "K9 matvec_cm", "float32"),
    ("sumsq f64 (b01 sumsq_pair_two_pass)", "sumsq", RED_CU, f"{DF2}:79",
     "K6 sumsq_two_pass", "float64"),
    ("sumsq f64 (b01 sumsq_pair_wide)", "sumsq", RED_CU, f"{DF2}:166",
     "K6 sumsq_wide", "float64"),
    ("sumsq f64 (b01 sumsq_pair_one_pass)", "sumsq", RED_CU, f"{DF2}:133",
     "K6 sumsq_functor", "float64"),
    ("map2_inplace f64 (b02 add_pair)", "map2_inplace", STREAM_CU,
     f"{DF2}:181", "K7 add_inplace", "float64"),
    ("map2_inplace f64 (b02 add_pair_wide)", "map2_inplace", STREAM_CU,
     f"{DF2}:212", "K7 add_inplace_manual", "float64"),
    ("map2_inplace f64 (b02 map2_pair)", "map2_inplace", STREAM_CU,
     f"{DF2}:218", "K7 map2_inplace", "float64"),
    ("matvec_rm f64 (b03 matvec_pair_rm)", "matvec_rm", MV_CU, f"{DF2}:248",
     "K8 matvec_rm", "float64"),
    ("matvec_cm f64 (b03 matvec_pair_cm)", "matvec_cm", MV_CU, f"{DF2}:302",
     "K9 matvec_cm", "float64"),
]
# The ceilings: the CLI's default buffer (f32 elements), the JAX CLI's
# measured keys (tpu_bench/benchmarks/ceilings.py) and the kernels its run
# launches
CEILING_N = 128 * 2**20
CEILING_KEYS = ("read_dma", "read_auto", "read", "write_dma", "write_auto",
                "write", "copy_2x", "scale_2x", "add_3x", "triad_3x",
                "expand2", "expand4", "expand8")
CEILING_KERNELS = {"stream_read", "stream_fill", "stream_map",
                   "stream_expand", "sumsq", "map2_inplace"}
PROBES_CU = "tpu_bench_torch/csrc/stream_probes.cu"
PLS = f"{PL}/stream.py"
# the ceiling probes' entries: (entry of the kernels line, kernel launched,
# the TPU kernel it replaces, the use timed in phase 3); launches from the
# ceilings run of phase 5
PROBE_USES = [
    ("stream_map (copy_manual)", "stream_map", f"{PLS}:151",
     "K12 copy_manual"),
    ("stream_map (scale_manual)", "stream_map", f"{PLS}:163",
     "K12 scale_manual"),
    ("stream_map (triad_manual)", "stream_map", f"{PLS}:171",
     "K12 triad_manual"),
    ("stream_fill (fill)", "stream_fill", f"{PLS}:188", "K11 fill"),
    ("stream_fill (fill_manual)", "stream_fill", f"{PLS}:234",
     "K11 fill_manual"),
    ("stream_expand (expand_manual, m=8)", "stream_expand", f"{PLS}:295",
     "K13 expand_manual m=8"),
    ("stream_read (read_manual)", "stream_read", f"{PLS}:354",
     "K10 read_manual"),
]


# K14 (csrc/ozaki.cu), the split-mantissa f64 GEMM of --f64-coales ozaki:
# phase 3's shapes, where both forms are timed (label, K = nmTot, nqTot,
# E), the last one's band-form launches counted, and the recombined
# product's tolerance against K2 in double (the JAX package's,
# tests/test_ozaki.py).
OZAKI_CU = "tpu_bench_torch/csrc/ozaki.cu"
PLO = f"{PL}/ozaki.py"
OZAKI_SHAPES = [("b04 nq=8^2", 49, 64, B04_NELMT),
                ("b05 nq=8^3", 343, 512, HEADLINE_NELMT)]
OZAKI_RTOL = 5e-14
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor cores (NVIDIA's data sheet)
TF32_FLOP_PER_S = 495e12  # dense TF32 tensor cores
FP64_TC_FLOP_PER_S = 67e12  # FP64 on the tensor cores (DMMA)
# sm_90's f64 mma.sync.m16n8k8 and the A100's m8n8k4 in cuobjdump's SASS
DMMA_SM90, DMMA_SM80 = "DMMA.16x8x8", "DMMA.8x8x4"
# a warp-group mma on TF32 operands (wgmma, e.g. HGMMA.64x128x8.F32.TF32)
HGMMA_TF32 = "HGMMA TF32"
# reads of the SM clock and of %globaltimer (csrc/qp_fused3d.cuh's probe)
CLOCK, TIMER = "SR_CLOCK", "SR_GLOBALTIMER"
# SASS patterns (re.search) of ops that are no literal prefix of a line
SASS_PATTERNS = {HGMMA_TF32: r"\bHGMMA\.\S*TF32",
                 CLOCK: r"\bSR_CLOCK(LO|HI)\b", TIMER: r"\bSR_GLOBALTIMER"}
# The tensor-core kernels: name: a pattern (re.search) of their instances'
# mangled names, and the mma instruction each must hold in the SASS.  K2
# and K3 share one dense GEMM on mma.sync, told apart by its tile-order
# argument (MFast: K2, NFast: K3); K2's f32 body on wgmma is its own
# kernel.
TC_KERNELS = {"K14 ozaki_slices": "ozaki_mma_kernel",
              "K2 kron dense f32 (wgmma 3xTF32)":
                  "dense_gemm_kernel_wgmma.*MFast",
              "K5 qp1d f32 (3xTF32)": "qp1d_tc_kernelIf",
              "K5 qp1d f64 (DMMA)": "qp1d_tc_kernelId",
              "K2 kron dense f32 (3xTF32)": "dense_gemm_kernelIf.*MFast",
              "K2 kron dense f64 (DMMA)": "dense_gemm_kernelId.*MFast",
              "K3 em dense f32 (3xTF32)": "dense_gemm_kernelIf.*NFast",
              "K3 em dense f64 (DMMA)": "dense_gemm_kernelId.*NFast",
              "K5 qp1d bf16": "qp1d_tc_kernelI13__nv_bfloat16",
              "K2 kron dense bf16": "dense_gemm_kernelI13__nv_bfloat16.*MFast",
              "K3 em dense bf16": "dense_gemm_kernelI13__nv_bfloat16.*NFast"}
TC_MMA = [("K14 ozaki_slices", "HMMA"), ("K5 qp1d f32 (3xTF32)", "HMMA"),
          ("K2 kron dense f32 (wgmma 3xTF32)", HGMMA_TF32),
          ("K5 qp1d f64 (DMMA)", "DMMA"),
          ("K2 kron dense f32 (3xTF32)", "HMMA"),
          ("K2 kron dense f64 (DMMA)", DMMA_SM90),
          ("K3 em dense f32 (3xTF32)", "HMMA"),
          ("K3 em dense f64 (DMMA)", DMMA_SM90), ("K5 qp1d bf16", "HMMA"),
          ("K2 kron dense bf16", "HMMA"), ("K3 em dense bf16", "HMMA")]
# The f64 dense entries issue sm_90's m16n8k8 only, never the A100's
# m8n8k4, which the H100 runs at half the rate (scripts/dmma_probe.cu)
DMMA_F64_DENSE = ("K2 kron dense f64 (DMMA)", "K3 em dense f64 (DMMA)")
# K1's plain instances (P = false) and its probe form's (P = true, the
# bool template argument after QPBody): only the probe form may read the
# SM clock or %globaltimer (SR_CLOCKLO, SR_CLOCKHI, SR_GLOBALTIMERLO/HI).
K1_PLAIN, K1_PROBE = "K1 qp_fused3d (plain form)", "K1 qp_fused3d (probe form)"
K1_FORMS = {K1_PLAIN: r"qp_fused3d_kernel.*QPBodyE\dELb0E",
            K1_PROBE: r"qp_fused3d_kernel.*QPBodyE\dELb1E"}
# K1's instance in a ptxas line's mangled name: its template arguments up
# to the stage-2 body, the same with or without the probe argument
K1_INSTANCE = r"qp_fused3d_kernelI(.*?QPBodyE\dE)"
# K1's instances by dtype and stage-2 body (the QPBody template argument,
# QP_DMMA = 1 with C12T staged, QP_DMMA_HELD = 2 with it in registers,
# QP_HMMA = 3 in bf16, QP_TF32 = 4 in f32, QP_DMMA_S1 = 5 as 2 with stage
# 1 on DMMA too): its f64 DMMA bodies must hold
# sm_90's m16n8k8 and no m8n8k4, its f32 instances no DMMA at all, its
# bf16 HMMA body the bf16 m16n8k16 with f32 sums, its f32 TF32 body HGMMA
# on TF32, and no other instance any HMMA or HGMMA.
K1_DMMA, K1_F32 = "K1 qp_fused3d f64 (DMMA)", "K1 qp_fused3d f32 (SIMT)"
K1_HELD = "K1 qp_fused3d f64 (DMMA, C12T held)"
K1_S1 = "K1 qp_fused3d f64 (DMMA, C12T held, stage 1 on DMMA)"
K1_HMMA = "K1 qp_fused3d bf16 (HMMA)"
K1_TF32 = "K1 qp_fused3d f32 (TF32 on wgmma)"
K1_F64, K1_BF16 = "K1 qp_fused3d f64 (SIMT)", "K1 qp_fused3d bf16 (SIMT)"
K1_KERNELS = {K1_DMMA: r"qp_fused3d_kernelId.*QPBodyE1E",
              K1_HELD: r"qp_fused3d_kernelId.*QPBodyE2E",
              K1_S1: r"qp_fused3d_kernelId.*QPBodyE5E",
              K1_HMMA: r"qp_fused3d_kernelI13__nv_bfloat16.*QPBodyE3E",
              K1_TF32: r"qp_fused3d_kernelIf.*QPBodyE4E",
              K1_F32: "qp_fused3d_kernelIf", K1_F64: "qp_fused3d_kernelId",
              K1_BF16: "qp_fused3d_kernelI13__nv_bfloat16"}
# the bf16 m16n8k16 with f32 sums in cuobjdump's SASS
HMMA_BF16 = "HMMA.16816.F32.BF16"
# The cp.async.bulk rings (csrc/ring.cuh) of K12 (copy, scale, triad) and
# K7's 16-byte form (add), whose SASS must hold the bulk copy (UBLKCP).
RING_KERNELS = {"K12 ring f32": "ring_kernelIfN.*(Copy|Scale|Triad)",
                "K12 ring f64": "ring_kernelIdN.*(Copy|Scale|Triad)",
                "K7 ring f32": "ring_kernelIfN.*Add",
                "K7 ring f64": "ring_kernelIdN.*Add"}
RING_BULK = [(name, "UBLKCP") for name in RING_KERNELS]
# The kernels ptxas must build without a spill: the tensor-core kernels,
# K1, K2's C-resident and K3's S-resident configurations, K4 (every nm0
# instance, f32, f64 and bf16), K8, K9 and the rings of K12 and K7.
NO_SPILL = {**TC_KERNELS, "K1 qp_fused3d": "qp_fused3d_kernel",
            K1_PROBE: K1_FORMS[K1_PROBE],
            "K2 kron resident": "kron_resident_kernel",
            "K3 em resident": "em_resident_kernel",
            "K4 qp_stage2_3d": "qp_stage2_3d_kernel",
            "K8 matvec_rm": "matvec_rm_kernel",
            "K9 matvec_cm": "matvec_cm", **RING_KERNELS}
K5_3D = "K5 qp1d_shared3d (QP-1D/Shared)"
K3_KRON = "K3 kron_elem_major (Uncoales)"
# Pallas(Coales)'s K2 use on its input copied one value off a 16-byte
# boundary, which takes K2's dense f32 launch from its wgmma body to the
# mma.sync one (kernels/bwdtrans2d.dense_body)
K2_OFF = "K2 kron_blocked (Coales, in off 16 B)"
K3_STAGES = tuple(f"K3 one_stage_em (QP-1D stage {i})" for i in (1, 2, 3))
K5_2D = "K5 qp1d_fused (QP-1D/Shared)"
K4_3D, K4_2D = "K4 qp_stage2_3d (QP stage 2)", "K4 qp_stage2 (QP stage 2)"
# K1's, K2's, K3's and K4's uses also timed in f64 at b05 nq=8^3,
# E=131072
F64_USES = ("K1 qp_shared3d_flat", "K1 qp_shared3d", "K2 kron_blocked (Coales)",
            "K2 kron_blocked (QP stage 1)", K3_KRON, *K3_STAGES, K4_3D)
# kron_coalesced (K2 on the flat layout): (label, nmTot, nqTot, E), the last
# one's launches counted
COALESCED_SHAPES = [("b04 nq=8^2", 49, 64, B04_NELMT),
                    ("b05 nq=8^3", 343, 512, HEADLINE_NELMT)]
# The bf16 uses of the kernels line: (entry of the line, kernel launched
# (its bf16 instance counts as <kernel>_bf16), its source, the TPU kernel
# it replaces, the use timed in phase 3, its order); launches from phase
# 11's sweep of the use's benchmark
PL3D = "tpu_bench/kernels/bwdtrans3d.py"
BF16_USES = [
    ("qp_fused3d bf16 (qp_shared3d_flat)", "qp_fused3d", BT3D_CU,
     f"{PL3D}:137", "K1 qp_shared3d_flat", (8, 8, 8)),
    ("qp_fused3d bf16 (qp_shared3d)", "qp_fused3d", BT3D_CU, f"{PL3D}:94",
     "K1 qp_shared3d", (8, 8, 8)),
    ("kron_blocked bf16 (kron_blocked)", "kron_blocked", BT2D_CU,
     f"{PL2D}:113", "K2 kron_blocked (Coales)", (8, 8, 8)),
    ("kron_blocked bf16 (qp_global3d stage 1)", "kron_blocked", BT2D_CU,
     f"{PL3D}:198", "K2 kron_blocked (QP stage 1)", (8, 8, 8)),
    ("qp_stage2_3d bf16 (qp_global3d stage 2)", "qp_stage2_3d", BT3D_CU,
     f"{PL3D}:198", K4_3D, (8, 8, 8)),
    ("em_gemm bf16 (kron_elem_major)", "em_gemm", BT2D_CU, f"{PL2D}:551",
     K3_KRON, (8, 8, 8)),
    *[(f"em_gemm bf16 (qp1d_global3d stage {i + 1})", "em_gemm", BT2D_CU,
       f"{PL3D}:285", use, (8, 8, 8)) for i, use in enumerate(K3_STAGES)],
    ("qp1d_fused3d bf16 (qp1d_shared3d)", "qp1d_fused3d", QP1D_CU,
     f"{PL3D}:250", K5_3D, (8, 8, 8)),
    ("kron_blocked bf16 (b04 kron_wide4)", "kron_blocked", BT2D_CU,
     f"{PL2D}:164", K2_COALES, B04_MAIN),
    ("qp_fused3d bf16 (b04 qp_shared)", "qp_fused3d", BT3D_CU, f"{PL2D}:265",
     K1_2D, B04_MAIN),
    ("kron_blocked bf16 (b04 qp_global stage 1)", "kron_blocked", BT2D_CU,
     f"{PL2D}:441", "K2 kron_blocked (QP stage 1)", B04_MAIN),
    ("qp_stage2_3d bf16 (b04 qp_global stage 2)", "qp_stage2_3d", BT3D_CU,
     f"{PL2D}:441", K4_2D, B04_MAIN),
    ("em_gemm bf16 (b04 kron_elem_major)", "em_gemm", BT2D_CU,
     f"{PL2D}:551", K3_KRON, B04_MAIN),
    *[(f"em_gemm bf16 (b04 _one_stage_em stage {i + 1})", "em_gemm", BT2D_CU,
       f"{PL2D}:614", use, B04_MAIN) for i, use in enumerate(K3_STAGES[:2])],
    ("qp1d_fused2d bf16 (b04 qp1d_shared)", "qp1d_fused2d", QP1D_CU,
     f"{PL2D}:580", K5_2D, B04_MAIN),
]


def _run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"])


def device_facts(torch) -> None:
    print(card())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    from tpu_bench_torch.kernels import build

    print(_run([build.nvcc(), "--version"]).splitlines()[-1])
    p = torch.cuda.get_device_properties(0)
    print(f"device {p.name}: {p.multi_processor_count} SMs, "
          f"L2 {p.L2_cache_size} B, memory {p.total_memory} B")


def k1_ptxas(text) -> dict:
    """{(K1 instance, probe form): its ptxas lines of registers and of
    stack and spills} in a build.log's text."""
    found, name = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("registers" in line or "stack frame" in line):
            m = re.search(K1_INSTANCE, name)
            if m:
                key = (m[1], bool(re.search(K1_FORMS[K1_PROBE], name)))
                found.setdefault(key, []).append(line.strip())
    return found


REGS_SM, REGS_UNIT = 65536, 8  # an SM's registers; a thread's granule


def k1_resident(lines, threads, smem) -> int:
    """K1's blocks an SM by the registers of its ptxas lines and by its
    `smem` bytes of shared memory a block."""
    from tpu_bench_torch.kernels import bwdtrans3d as k1

    regs = int(next(re.search(r"Used (\d+) registers", line)[1]
                    for line in lines if "registers" in line))
    return min(REGS_SM // (-(-regs // REGS_UNIT) * REGS_UNIT * threads),
               k1.SMEM_SM // (smem + k1.SMEM_RESERVED))


def same_k1_residency(log) -> None:
    """At the qp cells' shapes (kernel_blocks.PROBE_SHAPES, at qp_config's
    choice) K1's probe form keeps its plain form's blocks an SM, as
    registers and shared memory set them: the probe's readings are those
    of the form the timed runs take."""
    from tpu_bench_torch.benchmarks.kernel_blocks import PROBE_SHAPES
    from tpu_bench_torch.kernels import bwdtrans3d as k1

    found = k1_ptxas(log)
    for label, dtype, *shape, _ in PROBE_SHAPES:
        size = dtype.itemsize
        tag = {2: "13__nv_bfloat16", 4: "f", 8: "d"}[size]
        cfg = k1.qp_config(size, *shape)
        body = k1.qp_entry_body(cfg)
        key = (f"{tag}Li{cfg.et}ELi{cfg.planes}ELi{cfg.depth}ELi"
               f"{cfg.threads}ELNS_6QPBodyE{body}E")
        smem = k1.qp_smem(size, cfg.et, cfg.planes, *shape, cfg.depth,
                          cfg.body, cfg.c12t, cfg.stage1)
        plain, probe = (k1_resident(found[(key, p)], cfg.threads, smem)
                        for p in (False, True))
        print(f"  ptxas: K1 at {label} {tuple(cfg)}: blocks an SM {plain}, "
              f"probe form {probe}")
        assert plain == probe, (label, cfg, plain, probe)


def same_k1_registers(log, parent_log) -> None:
    """K1's plain instances' ptxas lines in `log` equal those of the
    parent tree's build.log `parent_log`, instance for instance, for each
    instance the parent has; those it lacks are listed."""
    mine = {k: v for (k, probe), v in k1_ptxas(log).items() if not probe}
    theirs = {k: v for (k, probe), v in k1_ptxas(parent_log).items()
              if not probe}
    assert theirs and theirs.keys() <= mine.keys(), (
        sorted(theirs.keys() - mine.keys()))
    differ = {k: (mine[k], theirs[k]) for k in theirs
              if mine[k] != theirs[k]}
    assert not differ, differ
    print(f"  ptxas: K1's {len(theirs)} plain instances as the parent's")
    for k in sorted(mine.keys() - theirs.keys()):
        print(f"  ptxas: K1 instance the parent lacks: {k}: {mine[k]}")


def build_kernels(parent_log=None) -> None:
    """Phase 2: the build, ptxas's registers and spills (none allowed in
    NO_SPILL: the tensor-core kernels K14, K5 and the dense GEMM of K2 and
    K3, K1 and its probe form, K2's C-resident and K3's S-resident
    configurations, K4, K8, K9 and the rings of K12 and K7), the
    tensor-core kernels' mma instructions, the rings' bulk copies and K1's
    clock reads in the library's SASS; with `parent_log` (the text of the
    parent tree's build.log), K1's plain instances' ptxas lines against
    the parent's."""
    from tpu_bench_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    log = (build.BUILD_DIR / "build.log")
    if log.exists():  # absent when the library was already built
        text = log.read_text()
        probes = [k for k, probe in k1_ptxas(text) if probe]
        assert probes, "no ptxas line of K1's probe form in build.log"
        print(f"  ptxas: {len(probes)} instances of K1's probe form")
        same_k1_residency(text)
        if parent_log is not None:
            same_k1_registers(text, parent_log)
        function = None
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                        "spill")):
                print("  ptxas:", line.strip())
            if "Function properties for" in line:
                function = line.split()[-1]
            elif "spill" in line and any(re.search(k, function or "")
                                         for k in NO_SPILL.values()):
                stores, loads = (int(n) for n in re.findall(
                    r"(\d+) bytes spill (?:stores|loads)", line))
                assert stores == loads == 0, (function, line)
    counts = sass_counts(build.library_path())
    for (kernel, op), n in sorted(counts.items()):
        print(f"  SASS: {n} {op} in {kernel}")
    for kernel, op in TC_MMA + RING_BULK:
        assert counts.get((kernel, op), 0) > 0, (kernel, op, counts)
    for kernel in (*DMMA_F64_DENSE, K1_DMMA, K1_HELD, K1_S1):
        assert counts.get((kernel, DMMA_SM80), 0) == 0, (kernel, counts)
    for kernel in (K1_DMMA, K1_HELD, K1_S1):
        assert counts.get((kernel, DMMA_SM90), 0) > 0, (kernel, counts)
    assert counts.get((K1_F32, "DMMA"), 0) == 0, counts
    assert counts.get((K1_HMMA, HMMA_BF16), 0) > 0, counts
    assert counts.get((K1_TF32, HGMMA_TF32), 0) > 0, counts
    assert counts.get((K1_TF32, "DMMA"), 0) == 0, counts
    for kernel in (K1_DMMA, K1_HELD, K1_S1, K1_F32, K1_F64, K1_BF16,
                   K1_TF32):
        assert counts.get((kernel, "HMMA"), 0) == 0, (kernel, counts)
    for kernel in (K1_DMMA, K1_HELD, K1_S1, K1_HMMA, K1_F32, K1_F64,
                   K1_BF16):
        assert counts.get((kernel, "HGMMA"), 0) == 0, (kernel, counts)
    for op in (CLOCK, TIMER):
        assert counts.get((K1_PLAIN, op), 0) == 0, (op, counts)
        assert counts.get((K1_PROBE, op), 0) > 0, (op, counts)


def sass_counts(library) -> dict:
    """{(kernel, op): instructions over its instances} in `cuobjdump
    -sass` of the built library: HMMA, DMMA and HGMMA on TF32 in the
    tensor-core kernels (TC_KERNELS), each DMMA also under its shape
    (DMMA_SM90, DMMA_SM80), DMMA, HMMA (also as HMMA_BF16) and HGMMA (also
    on TF32) in K1's instances by dtype and body (K1_KERNELS), and the
    bulk copies (UBLKCP) and mbarrier operations
    (SYNCS) in the rings (RING_KERNELS), and reads of the SM clock and
    %globaltimer in K1's plain and probe forms (K1_FORMS).  A function
    counts under the first kernel of each group whose pattern it
    matches."""
    from tpu_bench_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    groups = [(TC_KERNELS, ("HMMA", "DMMA", DMMA_SM90, DMMA_SM80,
                            HGMMA_TF32)),
              (K1_KERNELS, ("DMMA", DMMA_SM90, DMMA_SM80, "HMMA",
                            HMMA_BF16, "HGMMA", HGMMA_TF32)),
              (RING_KERNELS, ("UBLKCP", "SYNCS")),
              (K1_FORMS, (CLOCK, TIMER))]
    counts, matched = {}, []
    for line in _run([tool, "-sass", str(library)]).splitlines():
        if "Function :" in line:
            name = line.split()[-1]
            matched = [next(((k, o) for k, tag in kernels.items()
                             if re.search(tag, name)), None)
                       for kernels, o in groups]
            matched = [m for m in matched if m]
            continue
        for kernel, ops in matched:
            for op in ops:
                pattern = SASS_PATTERNS.get(op, rf"\b{re.escape(op)}[.\s]")
                if re.search(pattern, line):
                    counts[(kernel, op)] = counts.get((kernel, op), 0) + 1
    return counts


def compare(torch, name, out, ref, dtype, tol=None) -> float:
    """The largest |out - ref|, held to `tol` (RTOL's by default) relative
    to the largest |ref|; in bf16 taken in f64, and the norms also held to
    BF16_NORM_RTOL."""
    torch.cuda.synchronize()
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    assert bool(torch.isfinite(out).all()), f"{name}: non-finite output"
    if dtype == torch.bfloat16:  # a bf16 instance, not a widened one
        assert out.dtype == ref.dtype == dtype, (name, out.dtype, ref.dtype)
        out, ref = out.double(), ref.double()
    err = float((out - ref).abs().max())
    rel = err / float(ref.abs().max())
    if tol is None:
        tol = RTOL[str(dtype).split(".")[-1]]
    norm = ""
    if dtype == torch.bfloat16:
        norm_rel = abs(float(out.norm()) / float(ref.norm()) - 1)
        norm = f", norm rel err {norm_rel:.2e} (tol {BF16_NORM_RTOL:g})"
        assert norm_rel <= BF16_NORM_RTOL, f"{name}: norm {norm_rel}"
    print(f"  {name}: max rel err {rel:.3e} (tol {tol:g}){norm}")
    assert rel <= tol, f"{name}: {rel} > {tol}"
    return err


class Case(NamedTuple):
    """One use of a kernel: the wrapper call, its plain version, one
    library call computing the same function, the tensors it must read,
    the FLOP it must do, what restores the operands of an in-place use
    before the check, and a tolerance other than RTOL's."""
    label: str
    run: Callable
    plain: Callable
    library: Callable
    inputs: tuple
    flops: int
    reset: Callable = None
    rtol: float = None


def chain_flops(*dims) -> int:
    """Least FLOP of the matrix chain (d0 x d1) @ (d1 x d2) @ ... over its
    association orders (the textbook dynamic program), 2 per multiply-add.
    (in @ S1) @ S2 may cost more than in @ (S1 @ S2): the bound takes the
    cheaper, as torch.linalg.multi_dot does."""
    n = len(dims) - 1
    cost = [[0] * n for _ in range(n)]
    for length in range(1, n):
        for i in range(n - length):
            j = i + length
            cost[i][j] = min(cost[i][k] + cost[k + 1][j]
                             + 2 * dims[i] * dims[k + 1] * dims[j + 1]
                             for k in range(i, j))
    return cost[0][n - 1]


def qp_flops(e, nm0, nrq, nq0, nkj) -> int:
    """Least FLOP of out[i, k] = sum_{p, r} B0[p, i] C12T[k, r] in[p, r]
    over E elements: p contracted first, r first, or the kron of B0 and
    C12T formed once and applied densely."""
    return min(2 * e * nq0 * nrq * (nm0 + nkj),
               2 * e * nm0 * nkj * (nrq + nq0),
               nm0 * nq0 * nrq * nkj * (1 + 2 * e))


def shape_cases(torch, rnd, nq, e) -> list:
    """Every kernel use and composition at order nq and E elements, on
    random inputs and random dense operators."""
    from tpu_bench_torch.kernels import bwdtrans2d as k2
    from tpu_bench_torch.kernels import bwdtrans3d as k1

    nq0, nq1, nq2 = nq
    nm0, nm1, nm2 = nq0 - 1, nq1 - 1, nq2 - 1
    nrq, nkj = nm2 * nm1, nq2 * nq1
    nm_tot, nq_tot = nm0 * nrq, nq0 * nkj
    n1, n2 = nrq * nq0, nm2 * nq1 * nq0
    b0, c12t = rnd(nm0, nq0), rnd(nkj, nrq)
    x = rnd(nm0, nrq, e)
    xf = x.reshape(nm_tot, e)
    ce = 1000 if e == 1000 else 8192
    c_coa, xb = rnd(nq_tot, nm_tot), rnd(e // ce, nm_tot, ce)
    w = rnd(nm0, nkj, e)
    em, c_em = rnd(e, nm_tot), rnd(nm_tot, nq_tot)
    s1, s2, s3 = rnd(nm_tot, n1), rnd(n1, n2), rnd(n2, nq_tot)
    w1, w2 = rnd(e, n1), rnd(e, n2)
    xo = torch.empty(xb.numel() + 1, dtype=xb.dtype,
                     device=xb.device)[1:].view(xb.shape)
    xo.copy_(xb)
    assert k2.dense_body(xo.dtype, ce, xo.data_ptr()) == "mma"
    mm = torch.matmul

    def k1_library():
        return torch.einsum("pi,kr,pre->ike", b0, c12t, x)

    k1_flops = qp_flops(e, nm0, nrq, nq0, nkj)
    k5_flops = chain_flops(e, nm_tot, n1, n2, nq_tot)
    return [
        Case("K1 qp_shared3d", lambda: k1.qp_shared3d(x, b0, c12t),
             lambda: k1.qp_shared3d_plain(x, b0, c12t), k1_library,
             (x, b0, c12t), k1_flops),
        Case("K1 qp_shared3d_flat",
             lambda: k1.qp_shared3d_flat(xf, b0, c12t, nrq=nrq),
             lambda: k1.qp_shared3d_flat_plain(xf, b0, c12t, nrq=nrq),
             k1_library, (xf, b0, c12t), k1_flops),
        Case("K2 kron_blocked (Coales)", lambda: k2.kron_blocked(xb, c_coa),
             lambda: k2.kron_blocked_plain(xb, c_coa),
             lambda: mm(c_coa, xb), (xb, c_coa), 2 * nq_tot * nm_tot * e),
        Case(K2_OFF, lambda: k2.kron_blocked(xo, c_coa),
             lambda: k2.kron_blocked_plain(xo, c_coa),
             lambda: mm(c_coa, xo), (xo, c_coa), 2 * nq_tot * nm_tot * e),
        Case("K2 kron_blocked (QP stage 1)", lambda: k2.kron_blocked(x, c12t),
             lambda: k2.kron_blocked_plain(x, c12t), lambda: mm(c12t, x),
             (x, c12t), 2 * nkj * nrq * nm0 * e),
        Case(K4_3D, lambda: k1.qp_stage2_3d(w, b0),
             lambda: k1.qp_stage2_3d_plain(w, b0),
             lambda: mm(b0.T, w.reshape(nm0, -1)), (w, b0),
             2 * nm0 * nq0 * nkj * e),
        Case("Pallas(QP) qp_global3d", lambda: k1.qp_global3d(x, b0, c12t),
             lambda: k1.qp_global3d_plain(x, b0, c12t), k1_library,
             (x, b0, c12t), k1_flops),
        Case("K3 kron_elem_major (Uncoales)",
             lambda: k2.kron_elem_major(em, c_em),
             lambda: k2.kron_elem_major_plain(em, c_em),
             lambda: mm(em, c_em), (em, c_em), 2 * e * nm_tot * nq_tot),
        Case("K3 one_stage_em (QP-1D stage 1)",
             lambda: k2.one_stage_em(em, s1),
             lambda: k2.kron_elem_major_plain(em, s1), lambda: mm(em, s1),
             (em, s1), 2 * e * nm_tot * n1),
        Case("K3 one_stage_em (QP-1D stage 2)",
             lambda: k2.one_stage_em(w1, s2),
             lambda: k2.kron_elem_major_plain(w1, s2), lambda: mm(w1, s2),
             (w1, s2), 2 * e * n1 * n2),
        Case("K3 one_stage_em (QP-1D stage 3)",
             lambda: k2.one_stage_em(w2, s3),
             lambda: k2.kron_elem_major_plain(w2, s3), lambda: mm(w2, s3),
             (w2, s3), 2 * e * n2 * nq_tot),
        Case("Pallas(QP-1D) qp1d_global3d",
             lambda: k1.qp1d_global3d(em, s1, s2, s3),
             lambda: k1.qp1d3d_plain(em, s1, s2, s3),
             lambda: torch.linalg.multi_dot([em, s1, s2, s3]),
             (em, s1, s2, s3), k5_flops),
        Case("K5 qp1d_shared3d (QP-1D/Shared)",
             lambda: k1.qp1d_shared3d(em, s1, s2, s3),
             lambda: k1.qp1d3d_plain(em, s1, s2, s3),
             lambda: torch.linalg.multi_dot([em, s1, s2, s3]),
             (em, s1, s2, s3), k5_flops),
    ]


def shape_cases_2d(torch, rnd, nq, e) -> list:
    """Every benchmark04 kernel use and composition at order nq = (nq0,
    nq1) and E elements, on random inputs and random dense operators."""
    from tpu_bench_torch.kernels import bwdtrans2d as k2
    from tpu_bench_torch.kernels import bwdtrans3d as k1

    nq0, nq1 = nq
    nm0, nm1 = nq0 - 1, nq1 - 1
    nm_tot, nq_tot, n1 = nm0 * nm1, nq0 * nq1, nm1 * nq0
    b0, b1t = rnd(nm0, nq0), rnd(nq1, nm1)
    # p-major; its bytes also serve the 4D chunk and element-major layouts
    x = rnd(nm0, nm1, e)
    ce, lanes = (8192, 128) if e % 8192 == 0 else (e, 8 if e % 8 == 0
                                                        else 1)
    xb4 = x.view(e // ce, nm_tot, ce // lanes, lanes)
    em = x.view(e, nm_tot)
    c_coa, c_em = rnd(nq_tot, nm_tot), rnd(nm_tot, nq_tot)
    w, w1 = rnd(nm0, nq1, e), rnd(e, n1)
    s1, s2 = rnd(nm_tot, n1), rnd(n1, nq_tot)
    mm = torch.matmul

    def k1_library():
        return torch.einsum("pi,jq,pqe->ije", b0, b1t, x)

    def kron_library():
        return mm(c_coa, xb4.view(e // ce, nm_tot, ce))

    k1_flops = qp_flops(e, nm0, nm1, nq0, nq1)
    kron_flops = 2 * nq_tot * nm_tot * e
    k5_flops = chain_flops(e, nm_tot, n1, nq_tot)
    return [
        Case(K2_COALES, lambda: k2.kron_wide4(xb4, c_coa),
             lambda: k2.kron_wide4_plain(xb4, c_coa), kron_library,
             (xb4, c_coa), kron_flops),
        Case(K1_2D, lambda: k1.qp_shared3d(x, b0, b1t),
             lambda: k1.qp_shared3d_plain(x, b0, b1t), k1_library,
             (x, b0, b1t), k1_flops),
        Case("K2 kron_blocked (QP stage 1)", lambda: k2.kron_blocked(x, b1t),
             lambda: k2.kron_blocked_plain(x, b1t), lambda: mm(b1t, x),
             (x, b1t), 2 * nq1 * nm1 * nm0 * e),
        Case(K4_2D, lambda: k1.qp_stage2_3d(w, b0),
             lambda: k1.qp_stage2_3d_plain(w, b0),
             lambda: mm(b0.T, w.reshape(nm0, -1)), (w, b0),
             2 * nm0 * nq0 * nq1 * e),
        Case("Pallas(QP) qp_global3d", lambda: k1.qp_global3d(x, b0, b1t),
             lambda: k1.qp_global3d_plain(x, b0, b1t), k1_library,
             (x, b0, b1t), k1_flops),
        Case("K3 kron_elem_major (Uncoales)",
             lambda: k2.kron_elem_major(em, c_em),
             lambda: k2.kron_elem_major_plain(em, c_em),
             lambda: mm(em, c_em), (em, c_em), kron_flops),
        Case("K3 one_stage_em (QP-1D stage 1)",
             lambda: k2.one_stage_em(em, s1),
             lambda: k2.kron_elem_major_plain(em, s1), lambda: mm(em, s1),
             (em, s1), 2 * e * nm_tot * n1),
        Case("K3 one_stage_em (QP-1D stage 2)",
             lambda: k2.one_stage_em(w1, s2),
             lambda: k2.kron_elem_major_plain(w1, s2), lambda: mm(w1, s2),
             (w1, s2), 2 * e * n1 * nq_tot),
        Case("Pallas(QP-1D) qp1d_global",
             lambda: k2.qp1d_global(em, s1, s2),
             lambda: k2.qp1d_plain(em, s1, s2),
             lambda: torch.linalg.multi_dot([em, s1, s2]), (em, s1, s2),
             k5_flops),
        Case("K5 qp1d_fused (QP-1D/Shared)",
             lambda: k1.qp1d_fused(em, s1, s2),
             lambda: k2.qp1d_plain(em, s1, s2),
             lambda: torch.linalg.multi_dot([em, s1, s2]), (em, s1, s2),
             k5_flops),
    ]


def stream_cases(torch, rnd, n, offsets) -> list:
    """Every K6 and K7 use on n random elements; x and y start `offsets`
    elements into their buffers, so (1, 3) places them differently
    against 16-byte boundaries and (1, 1) both off one."""
    from tpu_bench_torch.kernels import axpy as k7
    from tpu_bench_torch.kernels import reduction as k6
    from tpu_bench_torch.kernels import stream

    ox, oy = offsets
    x, y = rnd(n + 4)[ox:ox + n], rnd(n + 4)[oy:oy + n]
    # K7's operand, placed as x, and the plain version's
    xs = torch.empty(n + 4, dtype=x.dtype, device="cuda")[ox:ox + n]
    xp = torch.empty_like(x)
    eps = 0.0 if n == STREAM_N else 0.5
    sum_tol = SUM_RTOL_F32 if x.dtype == torch.float32 else None

    def reset():
        xs.copy_(x)
        xp.copy_(x)

    def k6_case(label, fn):
        # the library call is timed at n = STREAM_N only, where eps = 0
        return Case(label, lambda: fn(x, eps),
                    lambda: k6.sumsq_plain(x, eps), lambda: torch.dot(x, x),
                    (x,), 3 * n, rtol=sum_tol)

    def k7_case(label, fn):  # one rounded add each side: bit for bit
        return Case(label, lambda: fn(xs, y),
                    lambda: k7.map2_inplace_plain(xp, y),
                    lambda: xs.add_(y), (x, y), n, reset=reset, rtol=0.0)

    return [
        k6_case("K6 sumsq_two_pass", k6.sumsq_two_pass),
        k6_case("K6 sumsq_wide", k6.sumsq_wide),
        k6_case("K6 sumsq_functor", k6.sumsq_functor),
        k7_case("K7 add_inplace", k7.add_inplace),
        k7_case("K7 add_inplace_wide", k7.add_inplace_wide),
        k7_case("K7 add_inplace_manual", stream.add_inplace_manual),
        k7_case("K7 map2_inplace", k7.map2_inplace),
    ]


def matvec_cases(torch, rnd, m, n) -> list:
    """K8 and K9 on a random (m, n) matrix, K9 on its transposed copy."""
    from tpu_bench_torch.kernels import matvec as kmv

    a, x = rnd(m, n), rnd(n)
    a_cm = a.t().contiguous()
    return [
        Case("K8 matvec_rm", lambda: kmv.matvec_rm(a, x),
             lambda: kmv.matvec_rm_plain(a, x), lambda: torch.mv(a, x),
             (a, x), 2 * m * n),
        Case("K9 matvec_cm", lambda: kmv.matvec_cm(a_cm, x),
             lambda: kmv.matvec_cm_plain(a_cm, x),
             lambda: torch.mv(a_cm.t(), x), (a_cm, x), 2 * m * n),
    ]


def bound(inputs, out, flops, flop_rate=FP32_FLOP_PER_S) -> tuple:
    """(least ms the card could take, what bounds it): each input read
    once and the output (a tensor or a tuple of them) written once at the
    HBM rate, against the least FLOP of the function (over its association
    orders) at the peak rate of their type, FP32 outside the tensor cores
    unless `flop_rate` says otherwise."""
    outs = out if isinstance(out, tuple) else (out,)
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outs))
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / flop_rate * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def host_cost(torch, run, library) -> dict:
    """What one call costs the host, for a hand use (`run`) and its
    library call: the µs to enqueue it while the card is busy
    (benchmarks/kernel_blocks.enqueue_us), and the host clock's time of a
    synchronized call as the benchmarks take it (core/timing.time_variant,
    L2 flushed) minus its CUDA-event time (event_ms), each the least of
    two taken in turns."""
    from tpu_bench_torch.benchmarks.kernel_blocks import enqueue_us
    from tpu_bench_torch.core.timing import L2Flush, event_ms, time_variant

    device = torch.device("cuda")
    flush = L2Flush(device)
    cost = {}
    for key, fn in (("kernel", run), ("library", library)):
        host = [time_variant(fn, 10, device, flush)]
        events = [event_ms(fn), event_ms(fn)]
        host.append(time_variant(fn, 10, device, flush))
        cost[key] = (enqueue_us(fn), min(host) * 1e6 - min(events) * 1e3)
    return cost


def host_text(cost) -> str:
    """host_cost's figures, for a line of phase 3."""
    (enq, over), (lib_enq, lib_over) = cost["kernel"], cost["library"]
    return (f"; host: enqueue {enq:.2f} us, host clock - events "
            f"{over:.2f} us; library {lib_enq:.2f} us, {lib_over:.2f} us")


def kernels_vs_plain(torch) -> dict:
    """Phase 3.  Returns {(use, nq): its error, times and bound} in f32 at
    each path's main shapes (b05 nq=8^3, E=131072; b04 nq=8^2,
    E=1,048,576) and for the b04 uses of B04_USES at their own order,
    E=1,048,576, and {(use, nq, "float64"): the same} for K1's, K2's,
    K3's and K4's uses in f64 at b05 nq=8^3 (F64_USES; the bound's FLOP at
    the card's FP64 peak, DMMA)."""
    from tpu_bench_torch.core.timing import event_ms
    from tpu_bench_torch.kernels import bwdtrans3d as k1

    gen = torch.Generator(device="cuda").manual_seed(5)
    measured, hosts = {}, {}
    sets = [(shape_cases, nq, e, (8, 8, 8), HEADLINE_NELMT)
            for nq in ((4, 4, 4), (8, 8, 8), (10, 10, 10), (3, 4, 5))
            for e in (1000, HEADLINE_NELMT)]
    sets += [(shape_cases_2d, nq, e, B04_MAIN, B04_NELMT)
             for nq in ((2, 2), (8, 8), (10, 12), (16, 16), (32, 32))
             for e in (1000, B04_NELMT)]
    at_order = {(use, order) for *_, use, order in B04_USES}
    for dtype in (torch.float32, torch.float64):
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device="cuda",
                               dtype=dtype)

        for cases, nq, e, main_nq, main_e in sets:
            tag = f"{str(dtype)[6:]} nq={nq} E={e}"
            for case in cases(torch, rnd, nq, e):
                out = case.run()
                err = compare(torch, f"{case.label} {tag}", out,
                              case.plain(), dtype)
                main = e == main_e and (nq == main_nq
                                        or (case.label, nq) in at_order)
                if dtype == torch.float64 and main and nq == (8, 8, 8) \
                        and case.label in F64_USES:
                    bound_ms, bound_by = bound(case.inputs, out, case.flops,
                                               FP64_TC_FLOP_PER_S)
                    measured[(case.label, nq, "float64")] = dict(
                        max_abs_err=err, ms=event_ms(case.run),
                        plain_ms=event_ms(case.plain),
                        library_ms=event_ms(case.library),
                        bound_ms=bound_ms, bound_by=bound_by)
                    hosts[(case.label, nq, "float64")] = host_cost(
                        torch, case.run, case.library)
                elif dtype == torch.float32 and main:
                    bound_ms, bound_by = bound(case.inputs, out, case.flops)
                    measured[(case.label, nq)] = dict(
                        max_abs_err=err, ms=event_ms(case.run),
                        plain_ms=event_ms(case.plain),
                        library_ms=event_ms(case.library),
                        bound_ms=bound_ms, bound_by=bound_by)
                    hosts[(case.label, nq)] = host_cost(torch, case.run,
                                                        case.library)
                del out
            torch.cuda.empty_cache()
        # K5's element tiles at b04 nq=32 (widths 961, 992): only 16 fits
        # in f32, only 8 in f64
        em, s1, s2 = (torch.empty(n, device="cuda", dtype=dtype)
                      for n in ((1, 961), (961, 992), (992, 1024)))
        print(f"  K5 tiles that fit at b04 nq=32 {str(dtype)[6:]}: "
              f"{k1.qp1d_tiles(em, s1, s2)}")
    for key, k in measured.items():
        label, nq, *f64 = key
        e = HEADLINE_NELMT if len(nq) == 3 else B04_NELMT
        dtype = f64[0] if f64 else "float32"
        print(f"  {label} at nq={nq} E={e} {dtype}: kernel "
              f"{k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, library "
              f"{k['library_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']})" + host_text(hosts[key]))
    return measured


def bf16_vs_plain(torch) -> dict:
    """Phase 3, bf16: every K1-K5 use and the Pallas(QP) and Pallas(QP-1D)
    compositions against their plain versions (the same cast points, in
    f32) on random bf16 inputs at the b05 orders 4^3, 8^3, 10^3 and
    (3,4,5), E = 1000, 131071 and 131072, and the b04 orders (2,2), (8,8),
    (10,12), (16,16) and (32,32), E = 1000, 131071 and 1,048,576 (compare:
    2^-7 elementwise, norms to 1e-4).  At the main shapes (b05 nq=8^3,
    E=131072; b04 nq=8^2, E=1,048,576) each use is timed beside its plain
    version, the library call in bf16 (summing in f32, as Config's
    "highest" sets cuBLAS) and its bound: bytes at 2 a value, FLOP at
    BF16_FLOP_PER_S, the least time of bf16 operands on the card.  Returns
    {(use, nq): those}."""
    from tpu_bench_torch.core.timing import event_ms

    gen = torch.Generator(device="cuda").manual_seed(13)
    dtype = torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    sets = [(shape_cases, nq, e, nq == (8, 8, 8) and e == HEADLINE_NELMT)
            for nq in ((4, 4, 4), (8, 8, 8), (10, 10, 10), (3, 4, 5))
            for e in (1000, 131071, HEADLINE_NELMT)]
    sets += [(shape_cases_2d, nq, e, nq == B04_MAIN and e == B04_NELMT)
             for nq in ((2, 2), (8, 8), (10, 12), (16, 16), (32, 32))
             for e in (1000, 131071, B04_NELMT)]
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    measured = {}
    try:
        for cases, nq, e, main in sets:
            for case in cases(torch, rnd, nq, e):
                out = case.run()
                err = compare(torch, f"{case.label} bfloat16 nq={nq} E={e}",
                              out, case.plain(), dtype)
                if main:
                    bound_ms, bound_by = bound(case.inputs, out, case.flops,
                                               BF16_FLOP_PER_S)
                    measured[(case.label, nq)] = dict(
                        max_abs_err=err, ms=event_ms(case.run),
                        plain_ms=event_ms(case.plain),
                        library_ms=event_ms(case.library),
                        bound_ms=bound_ms, bound_by=bound_by)
                del out
            torch.cuda.empty_cache()
    finally:
        matmul.allow_bf16_reduced_precision_reduction = saved
    for (label, nq), k in measured.items():
        e = HEADLINE_NELMT if len(nq) == 3 else B04_NELMT
        print(f"  {label} at nq={nq} E={e} bfloat16: kernel {k['ms']:.4f} "
              f"ms, plain {k['plain_ms']:.4f} ms, library "
              f"{k['library_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']})")
    return measured


def streams_vs_plain(torch) -> dict:
    """Phase 3, benchmarks 01-03.  Every K6-K9 use against its plain
    version on random inputs, in f32 and f64: K6 and K7 at n = 1000 (x and
    y placed differently against 16-byte boundaries), 1,048,579 (both one
    element off) and 536,870,912; K8 and K9 at MATVEC_SHAPES.  At
    536,870,912 and 16384^2 each use is timed beside its plain version, one
    library call and its bound, and K8 at the other MATVEC_SHAPES beside
    torch.mv; returns {(use, dtype): those}."""
    from tpu_bench_torch.core.timing import event_ms

    gen = torch.Generator(device="cuda").manual_seed(6)
    measured, hosts = {}, {}
    for dtype in (torch.float32, torch.float64):
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device="cuda",
                               dtype=dtype)

        tag = str(dtype)[6:]
        sets = [(stream_cases, (n, offsets), n == STREAM_N)
                for n, offsets in ((1000, (1, 3)), (1048579, (1, 1)),
                                   (STREAM_N, (0, 0)))]
        sets += [(matvec_cases, shape, shape == (MATVEC_N, MATVEC_N))
                 for shape in MATVEC_SHAPES]
        for cases, args, main in sets:
            for case in cases(torch, rnd, *args):
                if case.reset:
                    case.reset()
                out = case.run()
                err = compare(torch, f"{case.label} {tag} {args}", out,
                              case.plain(), dtype, case.rtol)
                if main:
                    bound_ms, bound_by = bound(case.inputs, out, case.flops)
                    measured[(case.label, tag)] = dict(
                        max_abs_err=err, ms=event_ms(case.run),
                        plain_ms=event_ms(case.plain),
                        library_ms=event_ms(case.library),
                        bound_ms=bound_ms, bound_by=bound_by)
                    hosts[(case.label, tag)] = host_cost(torch, case.run,
                                                         case.library)
                elif case.label == "K8 matvec_rm":
                    print(f"  K8 matvec_rm at {args} {tag}: kernel "
                          f"{event_ms(case.run):.4f} ms, torch.mv "
                          f"{event_ms(case.library):.4f} ms, bound "
                          f"{bound(case.inputs, out, case.flops)[0]:.4f} ms")
                del out
            torch.cuda.empty_cache()
    for (label, tag), k in measured.items():
        print(f"  {label} at its main shape {tag}: kernel {k['ms']:.4f} ms, "
              f"plain {k['plain_ms']:.4f} ms, library "
              f"{k['library_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']})" + host_text(hosts[(label, tag)]))
    return measured


def probe_cases(torch, rnd, n, chunk_bytes, offsets) -> list:
    """The seven ceiling probes (K10-K13; expand at m = 2, 4, 8) on n
    random elements in chunks of chunk_bytes; x and y start `offsets`
    elements into their buffers.  Copy, fill, expand and the token are
    held bit for bit."""
    from tpu_bench_torch.kernels import stream

    ox, oy = offsets
    x, y = rnd(n + 4)[ox:ox + n], rnd(n + 4)[oy:oy + n]
    c, seed, bias = rnd(1, 1), rnd(1, 1), rnd(1, 1)
    rows = n // stream.LANES
    # the copies' destinations, and K12's in-place operand, placed as x,
    # beside the plain version's
    out, out_plain, fill_out = (torch.empty_like(x), torch.empty_like(x),
                                torch.empty((rows, stream.LANES),
                                            dtype=x.dtype, device="cuda"))
    xs = torch.empty(n + 4, dtype=x.dtype, device="cuda")[ox:ox + n]
    xp = torch.empty_like(x)
    chunk = stream.chunk_rows(rows, x.element_size(),
                              chunk_bytes) * stream.LANES
    alpha = float(c)  # add_'s alpha is a host number; read before timing
    kw = {"chunk_bytes": chunk_bytes}

    def reset():
        xs.copy_(x)
        xp.copy_(x)

    def expand_library(m):
        # one broadcasting add into the interleaved view of the output
        src = x.view(-1, 1, chunk).expand(-1, m, chunk)
        dst = torch.empty((m * rows, stream.LANES), dtype=x.dtype,
                          device="cuda")
        return torch.add(src, bias.reshape(()), out=dst.view(-1, m, chunk))

    def fill_case(label, fn):
        return Case(label, lambda: fn(rows, seed, dtype=x.dtype),
                    lambda: stream.fill_plain(rows, seed, dtype=x.dtype),
                    lambda: fill_out.fill_(seed.reshape(())), (seed,), 0,
                    rtol=0.0)

    return [
        Case("K12 copy_manual", lambda: stream.copy_manual(x, out=out),
             lambda: stream.copy_plain(x, out_plain), lambda: out.copy_(x),
             (x,), 0, rtol=0.0),
        Case("K12 scale_manual", lambda: stream.scale_manual(xs, c),
             lambda: stream.scale_plain(xp, c),
             lambda: xs.mul_(c.reshape(())), (x, c), n, reset=reset,
             rtol=0.0),
        Case("K12 triad_manual", lambda: stream.triad_manual(xs, y, c),
             lambda: stream.triad_plain(xp, y, c),
             lambda: xs.add_(y, alpha=alpha), (x, y, c), 2 * n,
             reset=reset),
        fill_case("K11 fill", stream.fill),
        fill_case("K11 fill_manual", stream.fill_manual),
        *[Case(f"K13 expand_manual m={m}",
               lambda m=m: stream.expand_manual(x, m, bias, **kw),
               lambda m=m: stream.expand_plain(x, m, bias, **kw),
               lambda m=m: expand_library(m), (x, bias), n, rtol=0.0)
          for m in (2, 4, 8)],
        Case("K10 read_manual", lambda: stream.read_manual(x, bias, **kw),
             lambda: stream.read_plain(x, bias, **kw), x.sum, (x, bias), 0,
             rtol=0.0),
    ]


def probes_vs_plain(torch) -> dict:
    """Phase 3, the ceilings.  Every probe against its plain version on
    random inputs, in f32 and f64: at n = 128*8 in one chunk, at 128*64
    and 128*24 in chunks of 8 rows (more chunks than the ring's depth, and
    exactly depth), at 128*64 with x and y off a 16-byte boundary and
    placed differently, and at CEILING_N, where each f32 probe is timed
    beside its plain version, one library call and its bound; returns
    {use: those}."""
    from tpu_bench_torch.core.timing import event_ms

    gen = torch.Generator(device="cuda").manual_seed(7)
    measured, hosts = {}, {}
    for dtype in (torch.float32, torch.float64):
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device="cuda",
                               dtype=dtype)

        tag = str(dtype)[6:]
        rows8 = 8 * 128 * dtype.itemsize
        for n, chunk_bytes, offsets in (
                (128 * 8, 1 << 20, (0, 0)), (128 * 64, rows8, (0, 0)),
                (128 * 24, rows8, (0, 0)), (128 * 64, rows8, (1, 3)),
                (CEILING_N, 16 * 2**20, (0, 0))):
            for case in probe_cases(torch, rnd, n, chunk_bytes, offsets):
                if case.reset:
                    case.reset()
                out = case.run()
                err = compare(torch, f"{case.label} {tag} n={n} "
                              f"chunk {chunk_bytes} B at {offsets}", out,
                              case.plain(), dtype, case.rtol)
                if n == CEILING_N and dtype == torch.float32:
                    bound_ms, bound_by = bound(case.inputs, out, case.flops)
                    measured[case.label] = dict(
                        max_abs_err=err, ms=event_ms(case.run),
                        plain_ms=event_ms(case.plain),
                        library_ms=event_ms(case.library),
                        bound_ms=bound_ms, bound_by=bound_by)
                    hosts[case.label] = host_cost(torch, case.run,
                                                  case.library)
                del out
            torch.cuda.empty_cache()
    for label, k in measured.items():
        print(f"  {label} at n={CEILING_N} f32: kernel {k['ms']:.4f} ms, "
              f"plain {k['plain_ms']:.4f} ms, library "
              f"{k['library_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']})" + host_text(hosts[label]))
    return measured


def ozaki_operands(torch, rng, k, nq_tot, e):
    """Random f64 C (nq_tot, k) and X (k, e) on the card, and their slices
    by the port's split_f64_np (slice_params' T of them) in bf16 on the
    card with the product of the scales."""
    from tpu_bench_torch.kernels import ozaki

    w, t = ozaki.slice_params(k)
    out = []
    for a in (rng.standard_normal((nq_tot, k)), rng.standard_normal((k, e))):
        sl, scale = ozaki.split_f64_np(a, w, t)
        out.append((torch.from_numpy(sl).to("cuda", torch.bfloat16), scale,
                    torch.from_numpy(a).to("cuda")))
        del a, sl
    (c_sl, s_c, c64), (x_sl, s_x, x64) = out
    return x_sl, c_sl, s_c * s_x, x64, c64


def ozaki_vs_plain(torch) -> tuple:
    """Phase 3, K14.  Both forms against kron_ozaki_pair_plain bit for bit
    in hi and lo on slices of random f64 operands at OZAKI_SHAPES, and
    scale * (hi + lo) against K2 in double on those f64 operands, to
    OZAKI_RTOL of the largest output; each form timed beside the plain
    version, torch.matmul in f64 on the f64 operands and its bound (bytes
    at the HBM rate; FLOP, the band's slice products, at the bf16
    tensor-core rate).  Returns
    ({(use, shape label): those}, the band form's launches in one call at
    b05 nq=8^3)."""
    import numpy as np

    from tpu_bench_torch.core.timing import event_ms
    from tpu_bench_torch.kernels import build, ozaki
    from tpu_bench_torch.kernels import bwdtrans2d as k2

    rng = np.random.default_rng(8)
    measured, hosts, band_launches = {}, {}, None
    forms = (("K14 kron_ozaki_pair", ozaki.kron_ozaki_pair),
             ("K14 kron_ozaki_band", ozaki.kron_ozaki_band))
    for label, k, nq_tot, e in OZAKI_SHAPES:
        x_sl, c_sl, scale, x64, c64 = ozaki_operands(torch, rng, k, nq_tot,
                                                     e)
        hi_p, lo_p = ozaki.kron_ozaki_pair_plain(x_sl, c_sl)
        # the plain version and the library call, once a shape
        shared = dict(
            plain_ms=event_ms(
                lambda: ozaki.kron_ozaki_pair_plain(x_sl, c_sl)),
            library_ms=event_ms(lambda: torch.matmul(c64, x64)))
        pairs = sum(len(ss) for _, ss in ozaki.bands(c_sl.shape[0],
                                                     x_sl.shape[0]))
        shared.update(zip(("bound_ms", "bound_by"), bound(
            (x_sl, c_sl), (hi_p, lo_p), pairs * 2 * nq_tot * k * e,
            BF16_FLOP_PER_S)))
        for use, fn in forms:
            hi, lo = fn(x_sl, c_sl)
            torch.cuda.synchronize()
            same = torch.equal(hi, hi_p) and torch.equal(lo, lo_p)
            err = max(float((hi - hi_p).abs().max()),
                      float((lo - lo_p).abs().max()))
            print(f"  {use} {label} K={k} E={e} T_c={c_sl.shape[0]} "
                  f"T_x={x_sl.shape[0]}: hi and lo equal to the plain "
                  f"version: {same}")
            assert same, (use, err)
            del hi, lo
            measured[(use, label)] = dict(
                max_abs_err=err, ms=event_ms(lambda: fn(x_sl, c_sl)),
                **shared)
            hosts[(use, label)] = host_cost(
                torch, lambda: fn(x_sl, c_sl),
                lambda: torch.matmul(c64, x64))
        ref = k2.kron_coalesced(x64, c64)
        out = scale * (hi_p.double() + lo_p.double())
        compare(torch, f"K14 recombined vs K2 f64 {label} E={e}", out, ref,
                torch.float64, OZAKI_RTOL)
        del ref, out
        if label == OZAKI_SHAPES[-1][0]:
            build.launches.clear()
            ozaki.kron_ozaki_band(x_sl, c_sl)
            torch.cuda.synchronize()
            band_launches = build.launches["ozaki_slices"]
        del x_sl, c_sl, x64, c64, hi_p, lo_p
        torch.cuda.empty_cache()
    for key, m in measured.items():
        print(f"  {key[0]} at {key[1]}: kernel {m['ms']:.4f} ms, plain "
              f"{m['plain_ms']:.4f} ms, torch.matmul f64 "
              f"{m['library_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms "
              f"({m['bound_by']})" + host_text(hosts[key]))
    return measured, band_launches


def tensor_core_times(torch, measured, measured_ozaki) -> None:
    """Phase 3, the tensor-core kernels at their main shapes: K14 (both
    forms; phase 3's times), K5 in f32 (phase 3's times) and in f64
    (timed here on random inputs) and the dense configurations of K2 and
    K3 at b05 nq=8^3 in f32 and f64 (phase 3's times; K2's f32 also on
    its mma.sync body, K2_OFF): each one's time, the
    rate it reaches in the FLOP of its own arithmetic (the slice products;
    the chain in stage order) and the time of the units it uses at their
    peak (dense bf16; 3 TF32 passes; DMMA)."""
    from tpu_bench_torch.core.timing import event_ms
    from tpu_bench_torch.kernels import bwdtrans3d as k1
    from tpu_bench_torch.kernels import ozaki

    rows = []
    for label, k, nq_tot, e in OZAKI_SHAPES:
        w, t = ozaki.slice_params(k)
        flops = 2 * nq_tot * k * e * sum(len(ss) for _, ss in
                                         ozaki.bands(t, t))
        for use in ("K14 kron_ozaki_pair", "K14 kron_ozaki_band"):
            rows.append((use, label, "bf16", measured_ozaki[(use, label)]
                         ["ms"], flops, flops / BF16_FLOP_PER_S * 1e3))
    gen = torch.Generator(device="cuda").manual_seed(10)
    for use, label, nq, e in ((K5_3D, "b05 nq=8^3", (8, 8, 8),
                               HEADLINE_NELMT),
                              (K5_2D, "b04 nq=8^2", B04_MAIN, B04_NELMT)):
        widths = stage_widths(nq)
        flops = 2 * e * sum(a * b for a, b in zip(widths, widths[1:]))
        rows.append((use, label, "f32 3xTF32", measured[(use, nq)]["ms"],
                     flops, 3 * flops / TF32_FLOP_PER_S * 1e3))
        em, *ops = (torch.randn(a, b, generator=gen, device="cuda",
                                dtype=torch.float64)
                    for a, b in zip((e, *widths), widths))
        rows.append((use, label, "f64 DMMA",
                     event_ms(lambda: k1.qp1d_fused(em, *ops)), flops,
                     flops / FP64_TC_FLOP_PER_S * 1e3))
        del em, ops
        torch.cuda.empty_cache()
    # K2's dense configuration (phase 3's times): b05 nq=8^3 Pallas(Coales)
    k2_use, flops = "K2 kron_blocked (Coales)", 2 * 512 * 343 * HEADLINE_NELMT
    rows.append((k2_use, "b05 nq=8^3", "f32 3xTF32",
                 measured[(k2_use, (8, 8, 8))]["ms"], flops,
                 3 * flops / TF32_FLOP_PER_S * 1e3))
    rows.append((K2_OFF, "b05 nq=8^3", "f32 3xTF32 (mma.sync)",
                 measured[(K2_OFF, (8, 8, 8))]["ms"], flops,
                 3 * flops / TF32_FLOP_PER_S * 1e3))
    rows.append((k2_use, "b05 nq=8^3", "f64 DMMA",
                 measured[(k2_use, (8, 8, 8), "float64")]["ms"], flops,
                 flops / FP64_TC_FLOP_PER_S * 1e3))
    # K3's dense configuration, the same FLOP: b05 nq=8^3 Pallas(Uncoales)
    rows.append((K3_KRON, "b05 nq=8^3", "f32 3xTF32",
                 measured[(K3_KRON, (8, 8, 8))]["ms"], flops,
                 3 * flops / TF32_FLOP_PER_S * 1e3))
    rows.append((K3_KRON, "b05 nq=8^3", "f64 DMMA",
                 measured[(K3_KRON, (8, 8, 8), "float64")]["ms"], flops,
                 flops / FP64_TC_FLOP_PER_S * 1e3))
    for use, label, units, ms, flops, unit_ms in rows:
        print(f"  {use} at {label} {units}: {ms:.4f} ms, "
              f"{flops / ms * 1e-9:.1f} TFLOP/s; its units at peak "
              f"{unit_ms:.4f} ms")


def stage_widths(nq) -> list:
    """Widths of the QP-1D chain at order nq (2D or 3D): nmTot, each
    workspace, nqTot."""
    nm = [n - 1 for n in nq]
    if len(nq) == 2:
        return [nm[0] * nm[1], nm[1] * nq[0], nq[0] * nq[1]]
    return [nm[0] * nm[1] * nm[2], nm[2] * nm[1] * nq[0],
            nm[2] * nq[1] * nq[0], nq[0] * nq[1] * nq[2]]


def coalesced_vs_plain(torch) -> tuple:
    """Phase 3, kron_coalesced (K2 on the flat layout) against its plain
    version on random inputs in f32 and f64 at b04 nq=8^2, E=1,048,576 and
    b05 nq=8^3, E=131072, timed in f32 beside torch.matmul and its bound.
    Returns ({shape label: those}, its launches in one call at b05)."""
    from tpu_bench_torch.core.timing import event_ms
    from tpu_bench_torch.kernels import build
    from tpu_bench_torch.kernels import bwdtrans2d as k2

    gen = torch.Generator(device="cuda").manual_seed(9)
    measured, hosts, launches = {}, {}, None
    for dtype in (torch.float32, torch.float64):
        for label, nm_tot, nq_tot, e in COALESCED_SHAPES:
            x = torch.randn(nm_tot, e, generator=gen, device="cuda",
                            dtype=dtype)
            c = torch.randn(nq_tot, nm_tot, generator=gen, device="cuda",
                            dtype=dtype)
            out = k2.kron_coalesced(x, c)
            err = compare(torch, f"kron_coalesced {str(dtype)[6:]} {label} "
                          f"E={e}", out, k2.kron_coalesced_plain(x, c),
                          dtype)
            if dtype == torch.float32:
                bound_ms, bound_by = bound((x, c), out,
                                           2 * nq_tot * nm_tot * e)
                measured[label] = dict(
                    max_abs_err=err, ms=event_ms(lambda: k2.kron_coalesced(
                        x, c)),
                    plain_ms=event_ms(lambda: k2.kron_coalesced_plain(x, c)),
                    library_ms=event_ms(lambda: torch.matmul(c, x)),
                    bound_ms=bound_ms, bound_by=bound_by)
                hosts[label] = host_cost(
                    torch, lambda: k2.kron_coalesced(x, c),
                    lambda: torch.matmul(c, x))
                if label == COALESCED_SHAPES[-1][0]:
                    build.launches.clear()
                    k2.kron_coalesced(x, c)
                    torch.cuda.synchronize()
                    launches = build.launches["kron_blocked"]
            del x, c, out
            torch.cuda.empty_cache()
    for label, m in measured.items():
        print(f"  kron_coalesced at {label} f32: kernel {m['ms']:.4f} ms, "
              f"plain {m['plain_ms']:.4f} ms, torch.matmul "
              f"{m['library_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms "
              f"({m['bound_by']})" + host_text(hosts[label]))
    return measured, launches


def initdata_on_card(torch) -> None:
    """Phase 3, benchmark data: device_x and device_y built on the card
    equal utils/native.py's f64 bytes, and the CPU's f32 bytes, at a size
    past both periods of the formulas (13 | 100191 and 8, 100721)."""
    import numpy as np

    from tpu_bench_torch.ops import initdata
    from tpu_bench_torch.utils import native

    n = 1048579
    for build_fn, ref in ((initdata.device_x, native.init_mod13),
                          (initdata.device_y, native.init_mod8)):
        f64 = build_fn(n, torch.float64, "cuda").cpu().numpy()
        assert np.array_equal(f64, ref(n)), build_fn.__name__
        f32 = build_fn(n, torch.float32, "cuda").cpu()
        assert torch.equal(f32, build_fn(n, torch.float32, "cpu")), \
            build_fn.__name__
    print(f"  device_x, device_y at n={n}: f64 equal to utils/native.py, "
          "f32 equal to the CPU's")


def golden_norm(torch, bench, args, golden, norm=None, run=None) -> None:
    """Phase 3, benchmark data: the reference log's f64 norm through every
    column of `bench` at prepare(*args).  `run(fn, args, cfg)` gives
    (seconds, output) where the norm is not of one call's output (b02's
    accumulating protocol, at the reference's 40 calls); `norm` maps the
    output to the norm (b01's square root of the sum)."""
    from tpu_bench_torch.core.config import Config
    from tpu_bench_torch.core.validate import l2norm

    cfg = Config(dtype=torch.float64, device="cuda", n_tests=40)
    data = bench.prepare(*args, cfg)
    norm = norm or l2norm
    labels = []
    for label, fn, keys in bench.variant_specs(data, cfg):
        fargs = tuple(data[k] for k in keys)
        value = norm(run(fn, fargs, cfg)[1] if run else fn(*fargs))
        rel = abs(value - golden) / golden
        print(f"  golden f64 {bench.__name__.split('.')[-1]} {args} "
              f"{label}: {value!r} (rel {rel:.2e})")
        assert rel <= 1e-8, (label, value)
        labels.append(label)
    assert labels == bench.LABELS, labels


def anisotropic_b04(torch) -> None:
    """Phase 3, benchmark data: every benchmark04 column in f32 at the
    anisotropic orders (10, 12) and (12, 10), nelmt=128, against the f64
    oracle to 5e-4.  The JAX package's f32 Pallas(QP/Shared) at (10, 12)
    computes the (12, 10) problem (ROADMAP Queue 3)."""
    import numpy as np

    from tpu_bench_torch.benchmarks import benchmark04 as b04
    from tpu_bench_torch.core.config import Config
    from tpu_bench_torch.core.validate import l2norm
    from tpu_bench_torch.ops import bwdtrans

    cfg = Config(dtype=torch.float32, device="cuda")
    for nq in ((10, 12), (12, 10)):
        data = b04.prepare(*nq, 128, cfg)
        oracle = float(np.linalg.norm(bwdtrans.reference2d(data["basis"],
                                                           128)))
        for label, fn, args in b04.build_variants(data, cfg):
            norm = l2norm(fn(*args))
            rel = abs(norm - oracle) / oracle
            if label == "Pallas(QP/Shared)":
                print(f"  f32 b04 nq={nq} nelmt=128 {label}: {norm!r} "
                      f"(oracle {oracle!r}, rel {rel:.2e})")
            assert rel <= 5e-4, (nq, label, norm, oracle)


def headline(torch) -> None:
    """Phase 4: the port's main path, through its entry point."""
    from tpu_bench_torch import bench
    from tpu_bench_torch.core.validate import check_norm_agreement
    from tpu_bench_torch.kernels import build
    from tpu_bench_torch.ops import bwdtrans

    build.launches.clear()
    result, columns = bench.main(["--nelmt", str(HEADLINE_NELMT)])
    torch.cuda.synchronize()
    counts = dict(build.launches)
    print(f"  launches in the headline: {counts}")
    assert set(counts) == {"qp_fused3d", "kron_blocked"}, counts
    assert min(counts.values()) > 0, counts

    basis = bwdtrans.make_basis3d(8, 8, 8, torch.float64, "cpu")
    oracle = math.sqrt(HEADLINE_NELMT) * float(
        (bwdtrans.reference3d(basis, 1) ** 2).sum()) ** 0.5
    for c in columns:
        rel = abs(c["norm"] - oracle) / oracle
        print(f"  {c['label']}: {c['gdofs']:.4f} GDOF/s, "
              f"{c['seconds'] * 1e3:.4f} ms, norm {c['norm']!r} "
              f"(oracle {oracle!r}, rel {rel:.2e})")
        assert math.isfinite(c["gdofs"]) and c["gdofs"] > 0, c
        assert rel <= 5e-4, (c["label"], c["norm"], oracle)
    mismatches = check_norm_agreement([c["label"] for c in columns],
                                      [c["norm"] for c in columns], 5e-4,
                                      context="headline")
    assert not mismatches, mismatches
    assert result["unit"] == "GDOF/s" and result["value"] > 0, result


def parse_log_fn():
    """postprocess/common.py's parse_log, loaded from the file's source
    without the module's top-level matplotlib import, which only its
    plotting needs."""
    path = os.path.join(ROOT, "postprocess", "common.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "parse_log")
    namespace: dict = {}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"),
         namespace)
    return namespace["parse_log"]


def cli_sweep(torch, bench, positionals: list, dtype: str, size_args: list,
              kernels: set, last_size: int, key: str = "nelmt",
              unit: str = "DOF/s", operand_bytes=None, caps=None,
              golden=None, reference=None) -> tuple:
    """Phases 6-10: `python -m tpu_bench_torch.benchmarks.<bench>
    <positionals> --dtype <dtype> <size_args>`, run in this process so the
    kernels' launch counts can be read; its log is parsed as postprocess
    does, by `key` and `unit`.  Exactly the kernels of `kernels` must
    launch.  With `operand_bytes(size, itemsize)` and `caps(itemsize)`
    ({name: cap in `unit`}), no column of a row whose operands exceed twice
    the L2 may read above any cap (+5%), which holds the timing and the
    byte counts.  With `golden`, every column's norm in the first row must
    be within 1e-8 of it.  With `reference` ({label: norm}), each of those
    columns' norms in the first row must be within BF16_NORM_RTOL of it.
    Returns the launches of each kernel during the sweep and the last
    row's throughput by column."""
    from tpu_bench_torch.core.validate import default_rtol
    from tpu_bench_torch.kernels import build

    argv = [*map(str, positionals), "--dtype", dtype, *size_args]
    name = bench.__name__.split(".")[-1]
    err = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, f"{name}.log")
        with open(log, "w") as out:
            build.launches.clear()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                bench.main(argv)
            torch.cuda.synchronize()
            counts = dict(build.launches)
        sizes, series, labels, title = parse_log_fn()(log, key, unit)
        with open(log) as f:
            norm_rows = [[float(v) for v in line.split()[3:]]
                         for line in f if " norm: " in line]
    notes = [line for line in err.getvalue().splitlines() if line.strip()]
    print(f"  {dtype} {name} {title}: {len(sizes)} rows, {key} "
          f"{int(sizes[0])}..{int(sizes[-1])}; launches {counts}")
    assert labels == bench.LABELS, labels
    assert sizes[-1] == last_size and len(norm_rows) == len(sizes), sizes
    for row in series:
        for label, v in zip(labels, row):
            assert v > 0, (dtype, label, v)
    torch_dtype = getattr(torch, {"f32": "float32", "f64": "float64",
                                  "bf16": "bfloat16"}[dtype])
    rtol = default_rtol(torch_dtype)
    for size, norms in zip(sizes, norm_rows):
        worst = max(abs(n - norms[0]) / norms[0] for n in norms)
        assert worst <= rtol, (dtype, size, norms)
    if golden is not None:
        worst = max(abs(n - golden) / golden for n in norm_rows[0])
        print(f"  {dtype} {name} {key} {int(sizes[0])}: every column's norm "
              f"within {worst:.2e} of the golden {golden}")
        assert worst <= 1e-8, (norm_rows[0], golden)
    if reference is not None:
        first = dict(zip(labels, norm_rows[0]))
        for label, ref in reference.items():
            rel = abs(first[label] - ref) / ref
            print(f"  {dtype} {name} {key} {int(sizes[0])} {label}: "
                  f"{first[label]!r}, reference {ref!r} (rel {rel:.2e})")
            assert rel <= BF16_NORM_RTOL, (label, first[label], ref)
    if operand_bytes is not None:
        l2 = torch.cuda.get_device_properties(0).L2_cache_size
        limits = caps(torch_dtype.itemsize)
        held = [(size, max(row)) for size, row in zip(sizes, series)
                if operand_bytes(int(size), torch_dtype.itemsize) > 2 * l2]
        for size, top in held:
            for cap_name, cap in limits.items():
                assert top <= cap * 1.05, (dtype, size, top, cap_name, cap)
        if held:
            size, top = max(held, key=lambda h: h[1])
            print(f"  {dtype} {name}: {len(held)} rows above 2x L2 under "
                  + ", ".join(f"{k} {v:.4f}" for k, v in limits.items())
                  + f" (x1.05); highest column {top:.4f} at {key} "
                  f"{int(size)}")
    last = dict(zip(labels, series[-1]))
    print(f"  {dtype} {key} {int(sizes[-1])} {unit}: " + ", ".join(
        f"{k} {v:.4f}" for k, v in last.items()), flush=True)
    bad = [n for n in notes if "WARNING" in n or "failed" in n]
    assert not bad, bad
    assert set(counts) == kernels and min(counts.values()) > 0, counts
    return counts, last


def ceilings_run(torch) -> tuple:
    """Phase 5: `python -m tpu_bench_torch.benchmarks.ceilings` at its
    defaults, in this process; prints its lines.  Returns the measured
    rates (its JSON line) and each kernel's launches during the run."""
    from tpu_bench_torch.benchmarks import ceilings
    from tpu_bench_torch.kernels import build

    out = io.StringIO()
    build.launches.clear()
    with contextlib.redirect_stdout(out):
        ceilings.main([])
    torch.cuda.synchronize()
    counts = dict(build.launches)
    lines = out.getvalue().splitlines()
    for line in lines:
        print(f"  {line}")
    print(f"  launches in the ceilings run: {counts}")
    bw = json.loads(lines[-1])
    assert list(bw) == ["device", "f32_elems", *CEILING_KEYS], list(bw)
    assert bw["f32_elems"] == CEILING_N, bw
    assert sum(line.startswith("Ceiling ") for line in lines) == 17, lines
    top = HBM_BYTES_PER_S * 1.05 * 1e-9
    for key in CEILING_KEYS:
        assert 0 < bw[key] <= top, (key, bw[key], top)
    assert set(counts) == CEILING_KERNELS and min(counts.values()) > 0, \
        counts
    return bw, counts


def bwdtrans_caps(bw, nq, dim):
    """caps(itemsize) of cli_sweep for b04 (dim 2) or b05 (dim 3) at the
    isotropic order nq, in GDOF/s, from phase 5's ceilings."""
    from tpu_bench_torch.core import roofline

    return lambda s: {"measured-mix cap": roofline.honesty_cap_bwdtrans(
        bw, nq, dim, s)}


def bwdtrans_bytes(nq, dim):
    """operand_bytes of cli_sweep for b04/b05 at order nq: each element's
    nm^dim modes in and nq^dim points out."""
    return lambda nelmt, s: ((nq - 1) ** dim + nq ** dim) * nelmt * s


def stream_sweeps(torch, bw) -> dict:
    """Phase 10: the benchmark01, 02 and 03 CLIs, f32 over the reference's
    sweeps (b01/b02 1024..536,870,912, b03 128..16384; 5 reps) and f64 over
    every 32nd size to the same tops (3 reps).  Above twice the L2 each
    column stays under the HBM rate and under the measured cap of its mix
    (bw, phase 5): b01 and b03 count one read, b02 two reads and a write.
    The mixes are those of tests/test_artifact_honesty.py.  Returns the
    launches of each kernel in each sweep, by (kernel, dtype)."""
    from tpu_bench_torch.benchmarks import benchmark01 as b01
    from tpu_bench_torch.benchmarks import benchmark02 as b02
    from tpu_bench_torch.benchmarks import benchmark03 as b03
    from tpu_bench_torch.core import roofline

    sweeps = [
        (b01, {"sumsq"}, STREAM_N, "16384", lambda n, s: n * s, (1, 0)),
        (b02, {"map2_inplace"}, STREAM_N, "16384", lambda n, s: 2 * n * s,
         (2, 1)),
        (b03, {"matvec_rm", "matvec_cm"}, MATVEC_N, "512",
         lambda n, s: n * n * s, (1, 0)),
    ]
    launches = {}
    for bench, kernels, top, f64_min, operand_bytes, mix in sweeps:
        caps = {"HBM rate": HBM_BYTES_PER_S * 1e-9,
                "measured-mix cap": roofline.honesty_cap_mix(bw, *mix)}
        for dtype, size_args in (
                ("f32", ["--ntests", "5"]),
                ("f64", ["--min-size", f64_min, "--step", "32",
                         "--ntests", "3"])):
            counts, _ = cli_sweep(torch, bench, [], dtype, size_args,
                                  kernels, top, key="Size", unit="GB/s",
                                  operand_bytes=operand_bytes,
                                  caps=lambda s, caps=caps: caps)
            tag = {"f32": "float32", "f64": "float64"}[dtype]
            launches.update({(k, tag): c for k, c in counts.items()})
    return launches


def ozaki_route(torch, bw) -> dict:
    """Phase 8: the benchmark05 (8 8 8) and benchmark04 (8 8) CLIs with
    `--dtype f64 --f64-coales ozaki`, nelmt 128 to 131072 in steps of x32,
    3 reps: the golden norms at nelmt 128, the eleven columns within 1e-10
    of each other, K14 launched beside the kernels of the native f64 run,
    and every column under phase 5's caps.  Returns K14's launches in each
    run, by benchmark."""
    from tpu_bench_torch.benchmarks import benchmark04 as b04
    from tpu_bench_torch.benchmarks import benchmark05 as b05

    size_args = ["--f64-coales", "ozaki", "--min-size", "128", "--max-size",
                 str(HEADLINE_NELMT), "--step", "32", "--ntests", "3"]
    launches = {}
    for bench, nq, kernels, golden in (
            (b05, 8, set(KERNELS), GOLDEN_NQ8_NELMT128),
            (b04, 8, B04_KERNELS, GOLDEN_B04_NQ8_NELMT128)):
        dim = 3 if bench is b05 else 2
        counts, _ = cli_sweep(torch, bench, [nq] * dim, "f64", size_args,
                              kernels | {"ozaki_slices"}, HEADLINE_NELMT,
                              operand_bytes=bwdtrans_bytes(nq, dim),
                              caps=bwdtrans_caps(bw, nq, dim), golden=golden)
        launches[bench] = counts["ozaki_slices"]
    return launches


def b04_orders(torch, bw) -> dict:
    """Phase 9: benchmark04 at nelmt 1,048,576 at each order of
    B04_ORDERS, f32 and f64, the isotropic ones held to their measured
    caps (bw, phase 5); prints each order's best column and returns the
    kernels' launches in each f32 run, by order."""
    from tpu_bench_torch.benchmarks import benchmark04 as b04

    launches = {}
    for dtype in ("f32", "f64"):
        for nq in B04_ORDERS:
            held = {}
            if nq[0] == nq[1]:
                held = dict(operand_bytes=bwdtrans_bytes(nq[0], 2),
                            caps=bwdtrans_caps(bw, nq[0], 2))
            counts, last = cli_sweep(torch, b04, list(nq), dtype,
                                     ["--min-size", str(B04_NELMT),
                                      "--max-size", str(B04_NELMT),
                                      "--ntests", "3"],
                                     B04_KERNELS, B04_NELMT, **held)
            if dtype == "f32":
                launches[nq] = counts
            best = max(last, key=last.get)
            print(f"  best {dtype} nq={nq} nelmt {B04_NELMT}: {best} "
                  f"{last[best]:.4f} GDOF/s", flush=True)
    return launches


def log_norms(path, nelmt=128) -> dict:
    """{label: norm} of a committed benchmark log's row at nelmt."""
    labels = None
    with open(os.path.join(ROOT, path)) as f:
        for line in f:
            if line.startswith(f"nelmt {nelmt} Case:"):
                labels = line.split()[3:]
            elif labels and line.startswith(f"nelmt {nelmt} norm:"):
                return dict(zip(labels, map(float, line.split()[3:])))
    raise ValueError(f"no nelmt {nelmt} row in {path}")


def bf16_sweeps(torch, bw) -> dict:
    """Phase 11: the benchmark05 (8 8 8) and benchmark04 (8 8) CLIs with
    `--dtype bf16`, nelmt 128 to 131072 and 1,048,576 in the reference's
    steps of x2, 5 reps: exactly the bf16 instances of
    K1-K5 launch, each row's norms agree to 5e-2, every column stays under
    phase 5's caps at 2 bytes a value, and at nelmt 128 every hand column
    is within 1e-4 of the JAX package's committed bf16 log (BF16_LOGS) but
    BF16_EXEMPT's.  Then K1 in bf16 at nq=6^3, nelmt 256 (benchmark05's
    data) within 5e-4 of the f64 oracle.  Returns each sweep's launches,
    by benchmark."""
    import numpy as np

    from tpu_bench_torch.benchmarks import benchmark04 as b04
    from tpu_bench_torch.benchmarks import benchmark05 as b05
    from tpu_bench_torch.core.config import Config
    from tpu_bench_torch.core.validate import l2norm
    from tpu_bench_torch.kernels import bwdtrans3d as k1
    from tpu_bench_torch.ops import bwdtrans

    launches = {}
    for bench, nq, top, kernels in ((b05, 8, HEADLINE_NELMT, set(KERNELS)),
                                    (b04, 8, B04_NELMT, B04_KERNELS)):
        name = bench.__name__.split(".")[-1]
        dim = 3 if bench is b05 else 2
        logged = log_norms(BF16_LOGS[name])
        reference = {label: v for label, v in logged.items()
                     if label.startswith("Pallas")
                     and label not in BF16_EXEMPT.get(name, ())}
        counts, _ = cli_sweep(
            torch, bench, [nq] * dim, "bf16",
            ["--min-size", "128", "--max-size", str(top), "--ntests", "5"],
            {f"{k}_bf16" for k in kernels}, top,
            operand_bytes=bwdtrans_bytes(nq, dim),
            caps=bwdtrans_caps(bw, nq, dim), reference=reference)
        launches[bench] = counts
    cfg = Config(dtype=torch.bfloat16, device="cuda")
    data = b05.prepare(6, 6, 6, 256, cfg)
    oracle = float(np.linalg.norm(bwdtrans.reference3d(data["basis"], 256)))
    norm = l2norm(k1.qp_shared3d(data["in_pcoa3"], data["b0"], data["c12t"]))
    rel = abs(norm - oracle) / oracle
    print(f"  K1 bf16 at nq=6^3, nelmt 256: {norm!r} (oracle {oracle!r}, rel "
          f"{rel:.2e}, tol 5e-4)")
    assert rel <= 5e-4, (norm, oracle)
    return launches


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="Smoke test of the port on one NVIDIA GPU.")
    parser.add_argument("--parent-build-log", default=None,
                        help="the parent tree's _build/build.log: phase 2 "
                        "holds K1's plain instances' ptxas lines to it")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import tpu_bench_torch

    pkg = os.path.dirname(os.path.abspath(tpu_bench_torch.__file__))
    if pkg != os.path.join(ROOT, "tpu_bench_torch"):
        print(f"chip_smoke: tpu_bench_torch was imported from {pkg}, not "
              "from this checkout", file=sys.stderr)
        return 1

    print("== 1. device facts", flush=True)
    device_facts(torch)
    print("== 2. build", flush=True)
    build_kernels(None if args.parent_build_log is None else
                  open(args.parent_build_log).read())
    print("== 3. kernels against their plain versions", flush=True)
    measured = kernels_vs_plain(torch)
    measured_bf16 = bf16_vs_plain(torch)
    measured_streams = streams_vs_plain(torch)
    measured_probes = probes_vs_plain(torch)
    measured_ozaki, band_launches = ozaki_vs_plain(torch)
    tensor_core_times(torch, measured, measured_ozaki)
    measured_coalesced, coalesced_launches = coalesced_vs_plain(torch)
    from tpu_bench_torch.benchmarks import benchmark01 as b01
    from tpu_bench_torch.benchmarks import benchmark02 as b02
    from tpu_bench_torch.benchmarks import benchmark03 as b03
    from tpu_bench_torch.benchmarks import benchmark04 as b04
    from tpu_bench_torch.benchmarks import benchmark05 as b05
    from tpu_bench_torch.core.timing import accumulating

    golden_norm(torch, b05, (8, 8, 8, 128), GOLDEN_NQ8_NELMT128)
    golden_norm(torch, b04, (8, 8, 128), GOLDEN_B04_NQ8_NELMT128)
    golden_norm(torch, b01, (1024,), GOLDEN_B01_1024, norm=b01.sumsq_norm)
    golden_norm(torch, b02, (1024,), GOLDEN_B02_1024, run=accumulating)
    golden_norm(torch, b03, (128,), GOLDEN_B03_128)
    initdata_on_card(torch)
    anisotropic_b04(torch)
    print("== 4. headline", flush=True)
    headline(torch)
    print("== 5. ceilings", flush=True)
    bw, launches_ceilings = ceilings_run(torch)
    print("== 6. benchmark05 CLI sweeps", flush=True)
    b05_held = dict(operand_bytes=bwdtrans_bytes(8, 3),
                    caps=bwdtrans_caps(bw, 8, 3))
    launches, _ = cli_sweep(torch, b05, [8, 8, 8], "f32",
                            ["--max-size", str(HEADLINE_NELMT), "--ntests",
                             "10"], set(KERNELS), HEADLINE_NELMT, **b05_held)
    cli_sweep(torch, b05, [8, 8, 8], "f64",
              ["--min-size", "128", "--max-size", str(HEADLINE_NELMT),
               "--step", "32", "--ntests", "5"], set(KERNELS),
              HEADLINE_NELMT, **b05_held)
    print("== 7. benchmark04 CLI sweeps", flush=True)
    b04_held = dict(operand_bytes=bwdtrans_bytes(8, 2),
                    caps=bwdtrans_caps(bw, 8, 2))
    launches_b04, _ = cli_sweep(torch, b04, [8, 8], "f32",
                                ["--max-size", str(B04_NELMT), "--ntests",
                                 "10"], B04_KERNELS, B04_NELMT, **b04_held)
    cli_sweep(torch, b04, [8, 8], "f64",
              ["--min-size", "128", "--max-size", str(B04_NELMT), "--step",
               "32", "--ntests", "5"], B04_KERNELS, 131072, **b04_held)
    print("== 8. benchmark05 and benchmark04 CLIs, f64, --f64-coales ozaki",
          flush=True)
    launches_ozaki = ozaki_route(torch, bw)
    print("== 9. benchmark04 at every order of run04.sh and (10, 12)",
          flush=True)
    launches_by_order = b04_orders(torch, bw)
    launches_by_order[B04_MAIN] = launches_b04  # the full f32 sweep
    print("== 10. benchmark01, 02 and 03 CLI sweeps", flush=True)
    launches_streams = stream_sweeps(torch, bw)
    print("== 11. benchmark05 and benchmark04 CLIs, bf16", flush=True)
    launches_bf16 = bf16_sweeps(torch, bw)
    from tpu_bench_torch.kernels import bwdtrans3d as k1

    print(f"K1 launches by ring depth (qp_depths): "
          f"{dict(sorted(k1.qp_depths.items()))}")
    print(f"K1 launches by (dtype, stage-2 body) (qp_bodies): "
          f"{dict(sorted(k1.qp_bodies.items()))}")
    print(f"K1 DMMA launches by where C12T lived (qp_dmma_c12t): "
          f"{dict(sorted(k1.qp_dmma_c12t.items()))}")
    print(f"K1 launches by (dtype, stage-1 body) (qp_stage1_bodies): "
          f"{dict(sorted(k1.qp_stage1_bodies.items()))}")
    print(card())  # again beside the numbers, for a reader of the tail
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=launches[name], **measured[(use, (8, 8, 8))])
        for name, (source, replaces, use) in KERNELS.items()] + [
        dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=launches_by_order[order][kernel],
             **measured[(use, order)])
        for name, kernel, source, replaces, use, order in B04_USES] + [
        dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=launches_streams[(kernel, dtype)],
             **measured_streams[(use, dtype)])
        for name, kernel, source, replaces, use, dtype in STREAM_USES] + [
        dict(name=name, route="cuda", source=PROBES_CU, replaces=replaces,
             launches=launches_ceilings[kernel], **measured_probes[use])
        for name, kernel, replaces, use in PROBE_USES] + [
        dict(name="ozaki_slices (kron_ozaki_pair)", route="cuda",
             source=OZAKI_CU, replaces=f"{PLO}:137",
             launches=launches_ozaki[b05],
             **measured_ozaki[("K14 kron_ozaki_pair", "b05 nq=8^3")]),
        dict(name="ozaki_slices (b04 kron_ozaki_pair)", route="cuda",
             source=OZAKI_CU, replaces=f"{PLO}:137",
             launches=launches_ozaki[b04],
             **measured_ozaki[("K14 kron_ozaki_pair", "b04 nq=8^2")]),
        dict(name="ozaki_slices (kron_ozaki_band)", route="cuda",
             source=OZAKI_CU, replaces=f"{PLO}:208", launches=band_launches,
             **measured_ozaki[("K14 kron_ozaki_band", "b05 nq=8^3")]),
        dict(name="kron_blocked (kron_coalesced)", route="cuda",
             source=BT2D_CU, replaces=f"{PL2D}:86",
             launches=coalesced_launches,
             **measured_coalesced["b05 nq=8^3"])] + [
        dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=launches_bf16[b05 if len(order) == 3 else b04][
                 f"{kernel}_bf16"], **measured_bf16[(use, order)])
        for name, kernel, source, replaces, use, order in BF16_USES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
