#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tpu_bench_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.  It
builds the hand kernels from the checkout's sources and drives the port's
main path, benchmark05 at nq=8^3, nelmt=131072, f32, through the entry
points a user calls.  Every phase is fatal:

1. device facts (nvidia-smi, torch, nvcc, device properties);
2. build of K1 (qp_fused3d) and K2 (kron_blocked) with nvcc for sm_90a;
3. each kernel against its plain PyTorch version on the card, on random
   per-element inputs in f32 and f64 (f32 to 1e-5, f64 to 1e-12 relative to
   the largest output), at ragged and main-path shapes, plus the f64 golden
   norm of the benchmark data at nq=8^3, nelmt=128;
4. the headline (`python -m tpu_bench_torch.bench`): both kernels' launch
   counters must rise during it, and the three columns' norms must agree
   with each other and with the f64 oracle to 5e-4;
5. a short benchmark05 CLI sweep whose log must parse with
   postprocess/common.py.

The line before the last is a JSON object with each kernel's launches,
error and time beside its plain version's; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import ast
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_NQ8_NELMT128 = 189.3141665  # reference benchmark05/nq8x8x8.log
RTOL = {"float32": 1e-5, "float64": 1e-12}
HEADLINE_NELMT = 131072


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
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())


def event_ms(torch, fn, reps: int = 20) -> float:
    """Least device time of one call, by CUDA events, L2 flushed before
    each call."""
    from tpu_bench_torch.core.timing import L2Flush

    flush = L2Flush(torch.device("cuda"))
    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop))
    return best


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


def kernels_vs_plain(torch) -> dict:
    """Phase 3.  Returns, per kernel, the error and times at the main
    path's shapes (nq=8^3, E=131072, f32)."""
    from tpu_bench_torch.kernels import bwdtrans2d as k2
    from tpu_bench_torch.kernels import bwdtrans3d as k1

    gen = torch.Generator(device="cuda").manual_seed(5)

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    main_path = {}
    for dtype in (torch.float32, torch.float64):
        for nq0, nq1, nq2 in ((4, 4, 4), (8, 8, 8), (10, 10, 10), (3, 4, 5)):
            nm0, nrq, nkj = nq0 - 1, (nq2 - 1) * (nq1 - 1), nq2 * nq1
            nm_tot, nq_tot = nm0 * nrq, nq0 * nkj
            b0 = rnd(nm0, nq0, dtype=dtype)
            c12t = rnd(nkj, nrq, dtype=dtype)
            c_coa = rnd(nq_tot, nm_tot, dtype=dtype)
            for e in (1000, HEADLINE_NELMT):
                tag = f"{str(dtype)[6:]} nq=({nq0},{nq1},{nq2}) E={e}"
                x = rnd(nm0, nrq, e, dtype=dtype)
                compare(torch, f"K1 qp_shared3d {tag}",
                        k1.qp_shared3d(x, b0, c12t),
                        k1.qp_shared3d_plain(x, b0, c12t), dtype)
                xf = x.reshape(nm_tot, e)
                out = k1.qp_shared3d_flat(xf, b0, c12t, nrq=nrq)
                ref = k1.qp_shared3d_flat_plain(xf, b0, c12t, nrq=nrq)
                err1 = compare(torch, f"K1 qp_shared3d_flat {tag}", out, ref,
                               dtype)
                ce = 1000 if e == 1000 else 8192
                xb = rnd(e // ce, nm_tot, ce, dtype=dtype)
                err2 = compare(torch, f"K2 kron_blocked {tag} ce={ce}",
                               k2.kron_blocked(xb, c_coa),
                               k2.kron_blocked_plain(xb, c_coa), dtype)
                if (dtype == torch.float32 and nq0 == nq1 == nq2 == 8
                        and e == HEADLINE_NELMT):
                    main_path["qp_fused3d"] = dict(
                        max_abs_err=err1,
                        ms=event_ms(torch, lambda: k1.qp_shared3d_flat(
                            xf, b0, c12t, nrq=nrq)),
                        plain_ms=event_ms(torch, lambda: (
                            k1.qp_shared3d_flat_plain(xf, b0, c12t,
                                                      nrq=nrq))))
                    main_path["kron_blocked"] = dict(
                        max_abs_err=err2,
                        ms=event_ms(torch, lambda: k2.kron_blocked(xb, c_coa)),
                        plain_ms=event_ms(torch, lambda: (
                            k2.kron_blocked_plain(xb, c_coa))))
    return main_path


def golden_norm(torch) -> None:
    """Phase 3, benchmark data: the reference log's f64 norm."""
    from tpu_bench_torch.benchmarks import benchmark05 as b05
    from tpu_bench_torch.core.config import Config
    from tpu_bench_torch.core.validate import l2norm

    cfg = Config(dtype=torch.float64, device="cuda")
    data = b05.prepare(8, 8, 8, 128, cfg)
    for label, fn, args in b05.build_variants(data, cfg):
        if label in ("Pallas(Coales)", "Pallas(QP/Shared)"):
            norm = l2norm(fn(*args))
            torch.cuda.synchronize()
            rel = abs(norm - GOLDEN_NQ8_NELMT128) / GOLDEN_NQ8_NELMT128
            print(f"  golden f64 nq=8^3 nelmt=128 {label}: {norm!r} "
                  f"(rel {rel:.2e})")
            assert rel <= 1e-8, (label, norm)


def headline(torch, kernels: dict) -> None:
    """Phase 4: the port's main path, through its entry point."""
    from tpu_bench_torch import bench
    from tpu_bench_torch.core.validate import check_norm_agreement
    from tpu_bench_torch.kernels import bwdtrans2d as k2
    from tpu_bench_torch.kernels import bwdtrans3d as k1
    from tpu_bench_torch.ops import bwdtrans

    k1.launches = 0
    k2.launches = 0
    result, columns = bench.main(["--nelmt", str(HEADLINE_NELMT)])
    torch.cuda.synchronize()
    kernels["qp_fused3d"]["launches"] = k1.launches
    kernels["kron_blocked"]["launches"] = k2.launches
    assert k1.launches > 0 and k2.launches > 0, (k1.launches, k2.launches)

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
    for name, k in kernels.items():
        print(f"  {name}: kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} "
              f"ms, {k['launches']} launches in the headline")
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


def cli_sweep() -> None:
    """Phase 5: `python -m tpu_bench_torch.benchmarks.benchmark05 8 8 8
    --max-size 131072 --ntests 10`, its log parsed as postprocess does."""
    from tpu_bench_torch.benchmarks import benchmark05 as b05

    cmd = [sys.executable, "-m", "tpu_bench_torch.benchmarks.benchmark05",
           "8", "8", "8", "--max-size", str(HEADLINE_NELMT), "--ntests", "10"]
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "nq8x8x8.log")
        with open(log, "w") as out:
            proc = subprocess.run(cmd, cwd=ROOT, stdout=out,
                                  stderr=subprocess.PIPE, text=True,
                                  timeout=900)
        assert proc.returncode == 0, proc.stderr[-4000:]
        sizes, series, labels, title = parse_log_fn()(log, "nelmt", "DOF/s")
    notes = [line for line in proc.stderr.splitlines() if line.strip()]
    print(f"  {title}: {len(sizes)} rows, nelmt {int(sizes[0])}.."
          f"{int(sizes[-1])}")
    assert labels == b05.LABELS, labels
    assert sizes == [float(128 << i) for i in range(11)], sizes
    live = {"Pallas(Coales)", "Pallas(QP/Shared)", "XLA(Uncoales)",
            "XLA(Coales)", "XLA(QP)", "XLA(QP/DG)", "XLA(GEMM)"}
    for row in series:
        for label, v in zip(labels, row):
            assert (v > 0) == (label in live), (label, v)
    last = dict(zip(labels, series[-1]))
    print("  nelmt 131072 GDOF/s: " + ", ".join(
        f"{k} {v:.4f}" for k, v in last.items() if k in live))
    bad = [n for n in notes if ("WARNING" in n or "failed" in n)
           and "not yet ported" not in n
           and "suppressing identical repeats" not in n]
    assert not bad, bad


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
    kernels = kernels_vs_plain(torch)
    golden_norm(torch)
    print("== 4. headline", flush=True)
    headline(torch, kernels)
    print("== 5. benchmark05 CLI sweep", flush=True)
    cli_sweep()

    routes = {
        "qp_fused3d": ("tpu_bench_torch/csrc/bwdtrans3d.cu",
                       "tpu_bench/kernels/bwdtrans3d.py:137"),
        "kron_blocked": ("tpu_bench_torch/csrc/bwdtrans2d.cu",
                         "tpu_bench/kernels/bwdtrans2d.py:113"),
    }
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=routes[name][0],
             replaces=routes[name][1], launches=k["launches"],
             max_abs_err=k["max_abs_err"], ms=k["ms"],
             plain_ms=k["plain_ms"])
        for name, k in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
