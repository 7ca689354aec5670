"""Headline benchmark of the port: one JSON line.

Metric: benchmark05 (3D BwdTrans hex, nq=8^3, f32) best-column throughput in
GDOF/s at nelmt=131072, taking the best of the three headline columns:
Pallas(QP/Shared) (hand kernel K1), Pallas(Coales) (hand kernel K2) and
XLA(GEMM) (torch.matmul).  vs_baseline compares against the reference CUDA
suite's best committed number for this configuration, 28.91 GDOF/s
(BASELINE.md: an A100-class GPU in f64).

    python -m tpu_bench_torch.bench [--device cuda] [--nelmt 131072]

Prints exactly one JSON line on stdout; per-column lines go to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

BASELINE_GDOFS = 28.91  # reference b05 nq=8^3 peak (BASELINE.md)
HEADLINE = ("Pallas(QP/Shared)", "Pallas(Coales)", "XLA(GEMM)")


def headline_columns(cfg, nelmt: int) -> list:
    """[{label, seconds, gdofs, norm}] of the headline columns at nq=8^3."""
    from tpu_bench_torch.benchmarks import benchmark05 as b05
    from tpu_bench_torch.core.timing import measure
    from tpu_bench_torch.core.validate import l2norm

    data = b05.prepare(8, 8, 8, nelmt, cfg)
    nm = data["basis"].nm_tot
    columns = []
    with cfg.library_precision():
        for label, fn, keys in b05.variant_specs(data, cfg):
            if label not in HEADLINE:
                continue
            args = tuple(data[k] for k in keys)
            t = measure(fn, args, cfg)
            columns.append(dict(label=label, seconds=t,
                                gdofs=1e-9 * nelmt * nm / t,
                                norm=l2norm(fn(*args))))
            del args
    return columns


def main(argv=None):
    from tpu_bench_torch.core.config import Config

    parser = argparse.ArgumentParser(prog="tpu_bench_torch.bench")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--nelmt", type=int, default=131072)
    parser.add_argument("--ntests", type=int, default=40)
    args = parser.parse_args(argv)
    cfg = Config(dtype=torch.float32, n_tests=args.ntests, device=args.device)
    columns = headline_columns(cfg, args.nelmt)
    for c in columns:
        print(f"{c['label']}: {c['gdofs']:.2f} GDOF/s, norm {c['norm']:.10g}",
              file=sys.stderr)
    best = max(columns, key=lambda c: c["gdofs"])
    result = {
        "metric": (f"b05 3D BwdTrans nq=8^3 nelmt={args.nelmt} f32 "
                   f"({best['label']})"),
        "value": round(best["gdofs"], 2),
        "unit": "GDOF/s",
        "vs_baseline": round(best["gdofs"] / BASELINE_GDOFS, 3),
    }
    print(json.dumps(result), flush=True)
    return result, columns


if __name__ == "__main__":
    main()
