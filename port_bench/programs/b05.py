"""How the program runs benchmark05's columns: its basis and derived
operators (ops/bwdtrans.operators3d) over the seeded bases, and a column's
callable resolved by its label through benchmarks/benchmark05.variant_specs,
the program's own binding of labels to kernels."""

from tpu_bench_torch.benchmarks import benchmark05
from tpu_bench_torch.core.config import Config
from tpu_bench_torch.ops import bwdtrans


def operators(config, inputs) -> tuple:
    """(the program's Basis3D, its operators by name) from the seeded
    bases."""
    nq0, nq1, nq2 = (int(n) for n in config["nq"])
    basis = bwdtrans.Basis3D(nq0, nq1, nq2, inputs["b0"], inputs["b1"],
                             inputs["b2"])
    names = ("c_em3", "c12t", "s1_em", "s2_em", "s3_em")
    ops = dict(zip(names, bwdtrans.operators3d(basis)))
    ops.update(b0=basis.b0, b1=basis.b1, b2=basis.b2)
    return basis, ops


def column(label: str, basis, dtype, device) -> tuple:
    """(callable, operand keys) of column `label` as benchmark05 binds it
    under Config(dtype, device).  variant_specs reads the basis and the QP
    element tile; the tile is the program's default, as
    benchmark05.prepare leaves it without --epb."""
    cfg = Config(dtype=dtype, device=device)
    data = {"basis": basis, "epb_qp": cfg.epb}
    for spec in benchmark05.variant_specs(data, cfg):
        if spec[0] == label:
            return spec[1], spec[2]
    raise ValueError(f"benchmark05 has no column {label!r}")
