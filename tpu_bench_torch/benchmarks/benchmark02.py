"""Benchmark 02: streaming vector addition x += y, port of
tpu_bench/benchmarks/benchmark02.py.

Reference: benchmark02/benchmark02.cc (harness :73-260, sweep like b01).
Five columns; GB/s counts two reads and one write, 3*itemsize*1e-9*size/t
(:255-259).  The reference computes its norm after the 40 timed
repetitions, so it prints ||x0 + 40*y|| (:161-164): each column runs
exactly n_tests timed accumulating additions on a fresh x
(core/timing.accumulating) and prints the norm of the result.

    Kokkos parallel_for      XLA(donate)      x.add_(y), in place
    thrust::transform        XLA              x + y, a fresh tensor
    CUDA scalar              Pallas           K7, scalar loads
    CUDA float4 / double2    Pallas(vl)       K7, 16-byte loads
                                              (the TPU's manual DMA ring)
    CUDA functor kernel      Pallas(functor)  K7, add functor

f32 and f64 run the same columns, K7 built in float or double
(kernels/axpy.py, kernels/stream.py, csrc/stream.cu); the JAX package's f64
pair kernels (df2stream) are not carried over.

    python -m tpu_bench_torch.benchmarks.benchmark02 [--dtype f64] [--device cuda]
"""

from __future__ import annotations

from tpu_bench_torch.baselines import axpy as lib_axpy
from tpu_bench_torch.core import timing
from tpu_bench_torch.core.config import Config
from tpu_bench_torch.core.reporting import Reporter
from tpu_bench_torch.core.validate import measure_row
from tpu_bench_torch.core.variants import Layouts, materialize
from tpu_bench_torch.kernels import axpy as k7
from tpu_bench_torch.kernels import stream
from tpu_bench_torch.ops import initdata

LABELS = ["XLA(donate)", "XLA", "Pallas", "Pallas(vl)", "Pallas(functor)"]


def variant_specs(data, cfg):
    """Ordered (label, fn, operand keys).  "x" is a derived layout, fresh
    on each access: the in-place columns consume it."""
    del data, cfg
    return [
        ("XLA(donate)", lib_axpy.add_donated, ("x", "y")),
        ("XLA", lib_axpy.add, ("x", "y")),
        ("Pallas", k7.add_inplace, ("x", "y")),
        ("Pallas(vl)", stream.add_inplace_manual, ("x", "y")),
        ("Pallas(functor)", k7.map2_inplace, ("x", "y")),
    ]


def build_variants(data, cfg):
    return materialize(variant_specs(data, cfg), data)


def prepare(size: int, cfg: Config) -> Layouts:
    return Layouts(
        base={"y": initdata.device_y(size, cfg.dtype, cfg.device)},
        derived={"x": lambda: initdata.device_x(size, cfg.dtype, cfg.device)})


def run_test(size: int, cfg: Config, reporter: Reporter) -> None:
    data = prepare(size, cfg)
    measure_row("b02", LABELS, variant_specs(data, cfg), data, cfg, reporter,
                key="Size", size=size, work=3 * cfg.itemsize * size,
                unit="GB/s", run=timing.accumulating)


def main(argv=None):
    from tpu_bench_torch.benchmarks import cli

    args = cli.build_parser("benchmark02").parse_args(argv)
    cfg = cli.stream_config(args, "benchmark02")
    reporter = Reporter("Benchmark02 : Vector Addition")
    cap = cfg.mem_cap_bytes
    with cli.profiled(args):
        for size in cli.sweep(1024, 536870912, args):
            # y, x, the warm-up's scratch x and the XLA column's fresh sum
            if 4 * size * cfg.itemsize > cap:
                reporter.note(f"b02: stopping sweep at size {size} "
                              "(memory cap)")
                break
            cli.guarded(reporter, "b02", size, run_test, size, cfg, reporter)


if __name__ == "__main__":
    main()
