"""Benchmark 03: dense matrix-vector multiply y = A.x, port of
tpu_bench/benchmarks/benchmark03.py.

Reference: benchmark03/benchmark03.cc (harness :106-350).  Five columns;
GB/s counts the matrix traffic only, itemsize*1e-9*M*N/t (:331-336).
Sweep: M = N = 128 .. 16384 (x2, :345).  Data: A[i, j] = sin(i*N + j + 1),
x[j] = j (:161-167), evaluated in f64 on the host.

    Kokkos TeamPolicy row-reduce  XLA(rowsum)   (A * x).sum(1)
    cuBLAS gemv 'T' (row-major)   XLA(gemv-rm)  torch.mv(A, x)
    cuBLAS gemv 'N' (col-major)   XLA(gemv-cm)  torch.mv on A^T's copy
    CUDA block-per-row dot        Pallas(vpu)   K8 matvec_rm
    CUDA vectorized dot           Pallas(mxu)   K9 matvec_cm, on A^T's copy

f32 and f64 run the same columns, K8 and K9 built in float or double
(kernels/matvec.py, csrc/matvec.cu); the JAX package's f64 pair kernels
(df2stream) are not carried over, and nothing is padded.

    python -m tpu_bench_torch.benchmarks.benchmark03 [--dtype f64] [--device cuda]
"""

from __future__ import annotations

from tpu_bench_torch.baselines import matvec as lib_mv
from tpu_bench_torch.core.config import Config
from tpu_bench_torch.core.reporting import Reporter
from tpu_bench_torch.core.validate import measure_row
from tpu_bench_torch.core.variants import Layouts, materialize
from tpu_bench_torch.kernels import matvec as kmv
from tpu_bench_torch.ops import initdata

LABELS = ["XLA(rowsum)", "XLA(gemv-rm)", "XLA(gemv-cm)", "Pallas(vpu)",
          "Pallas(mxu)"]


def variant_specs(data, cfg):
    """Ordered (label, fn, operand keys); "a_rm" is A row-major, "a_cm"
    its column-major copy A^T."""
    del data, cfg
    return [
        ("XLA(rowsum)", lib_mv.rowsum, ("a_rm", "x")),
        ("XLA(gemv-rm)", lib_mv.gemv_rm, ("a_rm", "x")),
        ("XLA(gemv-cm)", lib_mv.gemv_cm, ("a_cm", "x")),
        ("Pallas(vpu)", kmv.matvec_rm, ("a_rm", "x")),
        ("Pallas(mxu)", kmv.matvec_cm, ("a_cm", "x")),
    ]


def build_variants(data, cfg):
    return materialize(variant_specs(data, cfg), data)


def prepare(size: int, cfg: Config) -> Layouts:
    a = initdata.host_matrix_sin1((size, size), cfg.dtype, cfg.device)
    return Layouts(
        base={"a_rm": a, "a_cm": a.t().contiguous(),
              "x": initdata.host_x_linear(size, cfg.dtype, cfg.device)},
        derived={})


def run_test(size: int, cfg: Config, reporter: Reporter) -> None:
    data = prepare(size, cfg)
    measure_row("b03", LABELS, variant_specs(data, cfg), data, cfg, reporter,
                key="Size", size=size, work=cfg.itemsize * size * size,
                unit="GB/s")


def main(argv=None):
    from tpu_bench_torch.benchmarks import cli

    args = cli.build_parser("benchmark03").parse_args(argv)
    cfg = cli.stream_config(args, "benchmark03")
    reporter = Reporter("Benchmark03 : Matrix-Vector Mult")
    cap = cfg.mem_cap_bytes
    with cli.profiled(args):
        for size in cli.sweep(128, 16384, args):
            # A, its copy A^T and the XLA(rowsum) column's product
            if 3 * size * size * cfg.itemsize > cap:
                reporter.note(f"b03: stopping sweep at size {size} "
                              "(memory cap)")
                break
            cli.guarded(reporter, "b03", size, run_test, size, cfg, reporter)


if __name__ == "__main__":
    main()
