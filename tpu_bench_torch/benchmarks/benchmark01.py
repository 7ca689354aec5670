"""Benchmark 01: L2-norm reduction sqrt(sum x_i^2), port of
tpu_bench/benchmarks/benchmark01.py.

Reference: benchmark01/benchmark01.cc (harness :183-335, sweep :343).  Five
columns; GB/s counts one read of x, itemsize*1e-9*size/t (:330-334).
Sweep: size = 1024 .. 536,870,912 (x2).  Each column returns the sum of
squares; the printed norm is its square root.

    Kokkos parallel_reduce     XLA              torch.sum (baselines)
    thrust::transform_reduce   XLA(dot)         torch.dot
    CUDA scalar two kernels    Pallas           K6 two-pass
    CUDA float4 / double2      Pallas(vl)       K6 one-pass, 16-byte loads
    CUDA functor reduceSum     Pallas(functor)  K6 one-pass, square_eps

f32 and f64 run the same columns, K6 built in float or double
(kernels/reduction.py, csrc/reduction.cu); the JAX package's f64 pair
kernels (df2stream) and its chained timing are not carried over.

    python -m tpu_bench_torch.benchmarks.benchmark01 [--dtype f64] [--device cuda]
"""

from __future__ import annotations

import math

from tpu_bench_torch.baselines import reduction as lib_red
from tpu_bench_torch.core.config import Config
from tpu_bench_torch.core.reporting import Reporter
from tpu_bench_torch.core.validate import measure_row
from tpu_bench_torch.core.variants import Layouts, materialize
from tpu_bench_torch.kernels import reduction as k6
from tpu_bench_torch.ops import initdata

LABELS = ["XLA", "XLA(dot)", "Pallas", "Pallas(vl)", "Pallas(functor)"]


def variant_specs(data, cfg):
    """Ordered (label, fn, operand keys): one streaming operand."""
    del data, cfg
    return [
        ("XLA", lib_red.sumsq, ("x",)),
        ("XLA(dot)", lib_red.sumsq_dot, ("x",)),
        ("Pallas", k6.sumsq_two_pass, ("x",)),
        ("Pallas(vl)", k6.sumsq_wide, ("x",)),
        ("Pallas(functor)", k6.sumsq_functor, ("x",)),
    ]


def build_variants(data, cfg):
    return materialize(variant_specs(data, cfg), data)


def prepare(size: int, cfg: Config) -> Layouts:
    return Layouts(base={"x": initdata.device_x(size, cfg.dtype, cfg.device)},
                   derived={})


def sumsq_norm(out) -> float:
    """The printed norm of a column's output, the sum of squares."""
    return math.sqrt(float(out))


def run_test(size: int, cfg: Config, reporter: Reporter) -> None:
    data = prepare(size, cfg)
    measure_row("b01", LABELS, variant_specs(data, cfg), data, cfg, reporter,
                key="Size", size=size, work=cfg.itemsize * size, unit="GB/s",
                norm=sumsq_norm)


def main(argv=None):
    from tpu_bench_torch.benchmarks import cli

    args = cli.build_parser("benchmark01").parse_args(argv)
    cfg = cli.stream_config(args, "benchmark01")
    reporter = Reporter("Benchmark01 : L2 norm reduction")
    cap = cfg.mem_cap_bytes
    with cli.profiled(args):
        for size in cli.sweep(1024, 536870912, args):
            # x and the XLA column's squared copy
            if 2 * size * cfg.itemsize > cap:
                reporter.note(f"b01: stopping sweep at size {size} "
                              "(memory cap)")
                break
            cli.guarded(reporter, "b01", size, run_test, size, cfg, reporter)


if __name__ == "__main__":
    main()
