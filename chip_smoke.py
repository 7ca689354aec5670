#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tpu_bench_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.  It
builds the hand kernels from the checkout's sources and drives the port's
two paths through the entry points a user calls: the headline
(benchmark05's three headline columns at nq=8^3, nelmt=131072, f32) and
the benchmark05 CLI with all eleven columns.  Every phase is fatal:

1. device facts (nvidia-smi, torch, nvcc, device properties);
2. build of K1 (qp_fused3d), K2 (kron_blocked), K3 (em_gemm),
   K4 (qp_stage2_3d) and K5 (qp1d_fused3d) with nvcc for sm_90a;
3. each kernel, in each of its uses, and the two-kernel Pallas(QP) and
   three-launch Pallas(QP-1D) compositions against their plain PyTorch
   versions on the card, on random per-element inputs and random dense
   operators in f32 and f64 (f32 to 1e-5, f64 to 1e-12 relative to the
   largest output) at nq 4^3, 8^3, 10^3 and (3,4,5), E=1000 (ragged) and
   131072; at the main path's shapes (nq=8^3, E=131072, f32) each is timed
   beside its plain version, one library call and its bound; then every
   column's f64 golden norm of the benchmark data at nq=8^3, nelmt=128;
4. the headline (`python -m tpu_bench_torch.bench`): K1's and K2's launch
   counts must rise during it, and the three columns' norms must agree
   with each other and with the f64 oracle to 5e-4;
5. the benchmark05 CLI (`python -m tpu_bench_torch.benchmarks.benchmark05
   8 8 8`), an f32 sweep to nelmt 131072 and a short f64 sweep: every
   kernel's launch count must rise during the f32 sweep, the logs must
   parse with postprocess/common.py with all eleven columns > 0, and the
   norms of each row must agree to 5e-4 (f32) and 1e-10 (f64).

The line before the last is a JSON object with each kernel's launches in
the f32 sweep, its error, its time beside its plain version's and a
library call's, and its bound; the last line is {"ok": true, "device":
{...}}.  Without a CUDA device, or outside a checkout of the repository,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import ast
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_NQ8_NELMT128 = 189.3141665  # reference benchmark05/nq8x8x8.log
RTOL = {"float32": 1e-5, "float64": 1e-12}
HEADLINE_NELMT = 131072
# Published H100 SXM rates (NVIDIA's data sheet) for the bounds.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12  # outside the tensor cores
# kernel name: (its source, the TPU kernel it replaces, the use whose time
# stands in the kernels line)
KERNELS = {
    "qp_fused3d": ("tpu_bench_torch/csrc/bwdtrans3d.cu",
                   "tpu_bench/kernels/bwdtrans3d.py:137",
                   "K1 qp_shared3d_flat"),
    "kron_blocked": ("tpu_bench_torch/csrc/bwdtrans2d.cu",
                     "tpu_bench/kernels/bwdtrans2d.py:113",
                     "K2 kron_blocked (Coales)"),
    "em_gemm": ("tpu_bench_torch/csrc/bwdtrans2d.cu",
                "tpu_bench/kernels/bwdtrans2d.py:551",
                "K3 kron_elem_major (Uncoales)"),
    "qp_stage2_3d": ("tpu_bench_torch/csrc/bwdtrans3d.cu",
                     "tpu_bench/kernels/bwdtrans3d.py:198",
                     "K4 qp_stage2_3d (QP stage 2)"),
    "qp1d_fused3d": ("tpu_bench_torch/csrc/qp1d_fused3d.cu",
                     "tpu_bench/kernels/bwdtrans3d.py:250",
                     "K5 qp1d_shared3d (QP-1D/Shared)"),
}


def _run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def device_facts(torch) -> None:
    print(_run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]))
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    from tpu_bench_torch.kernels import build

    print(_run([build.nvcc(), "--version"]).splitlines()[-1])
    p = torch.cuda.get_device_properties(0)
    print(f"device {p.name}: {p.multi_processor_count} SMs, "
          f"L2 {p.L2_cache_size} B, memory {p.total_memory} B")


def build_kernels() -> None:
    from tpu_bench_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    log = (build.BUILD_DIR / "build.log")
    if log.exists():  # absent when the library was already built
        for line in log.read_text().splitlines():
            if any(w in line for w in ("entry function", "registers",
                                        "spill")):
                print("  ptxas:", line.strip())


def compare(torch, name, out, ref, dtype) -> float:
    torch.cuda.synchronize()
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    assert bool(torch.isfinite(out).all()), f"{name}: non-finite output"
    err = float((out - ref).abs().max())
    rel = err / float(ref.abs().max())
    tol = RTOL[str(dtype).split(".")[-1]]
    print(f"  {name}: max rel err {rel:.3e} (tol {tol:g})")
    assert rel <= tol, f"{name}: {rel} > {tol}"
    return err


class Case(NamedTuple):
    """One use of a kernel: the wrapper call, its plain version, one
    library call computing the same function, the tensors it must read,
    and the FLOP it must do."""
    label: str
    run: Callable
    plain: Callable
    library: Callable
    inputs: tuple
    flops: int


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
    mm = torch.matmul

    def k1_library():
        return torch.einsum("pi,kr,pre->ike", b0, c12t, x)

    k1_flops = 2 * nq0 * nrq * (nm0 + nkj) * e
    k5_flops = 2 * e * (nm_tot * n1 + n1 * n2 + n2 * nq_tot)
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
        Case("K2 kron_blocked (QP stage 1)", lambda: k2.kron_blocked(x, c12t),
             lambda: k2.kron_blocked_plain(x, c12t), lambda: mm(c12t, x),
             (x, c12t), 2 * nkj * nrq * nm0 * e),
        Case("K4 qp_stage2_3d (QP stage 2)", lambda: k1.qp_stage2_3d(w, b0),
             lambda: k1.qp_stage2_3d_plain(w, b0),
             lambda: mm(b0.T, w.reshape(nm0, -1)), (w, b0),
             2 * nm0 * nq0 * nkj * e),
        Case("Pallas(QP) qp_global3d", lambda: k1.qp_global3d(x, b0, c12t),
             lambda: k1.qp_global3d_plain(x, b0, c12t), k1_library,
             (x, b0, c12t), 2 * nm0 * nkj * (nrq + nq0) * e),
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


def bound(inputs, out, flops) -> tuple:
    """(least ms the card could take, what bounds it): each input read
    once and the output written once at the HBM rate, against the FLOP at
    the FP32 rate."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, out))
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOP_PER_S * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def kernels_vs_plain(torch) -> dict:
    """Phase 3.  Returns, per use, the error, times and bound at the main
    path's shapes (nq=8^3, E=131072, f32)."""
    from tpu_bench_torch.core.timing import event_ms

    gen = torch.Generator(device="cuda").manual_seed(5)
    main_path = {}
    for dtype in (torch.float32, torch.float64):
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device="cuda",
                               dtype=dtype)

        for nq in ((4, 4, 4), (8, 8, 8), (10, 10, 10), (3, 4, 5)):
            for e in (1000, HEADLINE_NELMT):
                tag = f"{str(dtype)[6:]} nq={nq} E={e}"
                timed = (dtype == torch.float32 and nq == (8, 8, 8)
                         and e == HEADLINE_NELMT)
                for case in shape_cases(torch, rnd, nq, e):
                    out = case.run()
                    err = compare(torch, f"{case.label} {tag}", out,
                                  case.plain(), dtype)
                    if not timed:
                        continue
                    bound_ms, bound_by = bound(case.inputs, out, case.flops)
                    main_path[case.label] = dict(
                        max_abs_err=err, ms=event_ms(case.run),
                        plain_ms=event_ms(case.plain),
                        library_ms=event_ms(case.library),
                        bound_ms=bound_ms, bound_by=bound_by)
    for label, k in main_path.items():
        print(f"  {label} at nq=8^3 E={HEADLINE_NELMT} f32: kernel "
              f"{k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, library "
              f"{k['library_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']})")
    return main_path


def golden_norm(torch) -> None:
    """Phase 3, benchmark data: the reference log's f64 norm through every
    column."""
    from tpu_bench_torch.benchmarks import benchmark05 as b05
    from tpu_bench_torch.core.config import Config
    from tpu_bench_torch.core.validate import l2norm

    cfg = Config(dtype=torch.float64, device="cuda")
    data = b05.prepare(8, 8, 8, 128, cfg)
    labels = []
    for label, fn, args in b05.build_variants(data, cfg):
        norm = l2norm(fn(*args))
        torch.cuda.synchronize()
        rel = abs(norm - GOLDEN_NQ8_NELMT128) / GOLDEN_NQ8_NELMT128
        print(f"  golden f64 nq=8^3 nelmt=128 {label}: {norm!r} "
              f"(rel {rel:.2e})")
        assert rel <= 1e-8, (label, norm)
        labels.append(label)
    assert labels == b05.LABELS, labels


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


def cli_sweep(torch, dtype: str, size_args: list) -> dict:
    """Phase 5: `python -m tpu_bench_torch.benchmarks.benchmark05 8 8 8
    --dtype <dtype> <size_args>`, run in this process so the kernels'
    launch counts can be read; its log is parsed as postprocess does.
    Returns the launches of each kernel during the sweep."""
    from tpu_bench_torch.benchmarks import benchmark05 as b05
    from tpu_bench_torch.core.validate import default_rtol
    from tpu_bench_torch.kernels import build

    argv = ["8", "8", "8", "--dtype", dtype, *size_args]
    err = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "nq8x8x8.log")
        with open(log, "w") as out:
            build.launches.clear()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                b05.main(argv)
            torch.cuda.synchronize()
            counts = dict(build.launches)
        sizes, series, labels, title = parse_log_fn()(log, "nelmt", "DOF/s")
        with open(log) as f:
            norm_rows = [[float(v) for v in line.split()[3:]]
                         for line in f if " norm: " in line]
    notes = [line for line in err.getvalue().splitlines() if line.strip()]
    print(f"  {dtype} {title}: {len(sizes)} rows, nelmt {int(sizes[0])}.."
          f"{int(sizes[-1])}; launches {counts}")
    assert labels == b05.LABELS, labels
    assert sizes[-1] == HEADLINE_NELMT and len(norm_rows) == len(sizes), sizes
    for row in series:
        for label, v in zip(labels, row):
            assert v > 0, (dtype, label, v)
    rtol = default_rtol(getattr(torch, {"f32": "float32",
                                        "f64": "float64"}[dtype]))
    for size, norms in zip(sizes, norm_rows):
        worst = max(abs(n - norms[0]) / norms[0] for n in norms)
        assert worst <= rtol, (dtype, size, norms)
    last = dict(zip(labels, series[-1]))
    print(f"  {dtype} nelmt {HEADLINE_NELMT} GDOF/s: " + ", ".join(
        f"{k} {v:.4f}" for k, v in last.items()))
    bad = [n for n in notes if "WARNING" in n or "failed" in n]
    assert not bad, bad
    assert set(counts) == set(KERNELS) and min(counts.values()) > 0, counts
    return counts


def main() -> int:
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
    build_kernels()
    print("== 3. kernels against their plain versions", flush=True)
    uses = kernels_vs_plain(torch)
    golden_norm(torch)
    print("== 4. headline", flush=True)
    headline(torch)
    print("== 5. benchmark05 CLI sweeps", flush=True)
    launches = cli_sweep(torch, "f32", ["--max-size", str(HEADLINE_NELMT),
                                        "--ntests", "10"])
    cli_sweep(torch, "f64", ["--min-size", "128", "--max-size",
                             str(HEADLINE_NELMT), "--step", "32",
                             "--ntests", "5"])

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=launches[name], **uses[use])
        for name, (source, replaces, use) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
