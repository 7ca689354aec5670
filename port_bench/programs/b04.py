"""How the program runs benchmark04's columns: its basis and derived
operators (ops/bwdtrans.operators2d) over the seeded bases, and a column's
callable resolved by its label through benchmarks/benchmark04.variant_specs,
the program's own binding of labels to kernels."""

from tpu_bench_torch.benchmarks import benchmark04
from tpu_bench_torch.core.config import Config
from tpu_bench_torch.ops import bwdtrans


def operators(config, inputs) -> tuple:
    """(the program's Basis2D, its operators by name) from the seeded
    bases."""
    nq0, nq1 = (int(n) for n in config["nq"])
    basis = bwdtrans.Basis2D(nq0, nq1, inputs["b0"], inputs["b1"])
    ops = dict(zip(("c_em", "s1_em", "s2_em"), bwdtrans.operators2d(basis)))
    ops.update(b0=basis.b0, b1=basis.b1)
    return basis, ops


def column(label: str, basis, dtype, device) -> tuple:
    """(callable, operand keys) of column `label` as benchmark04 binds it
    under Config(dtype, device).  variant_specs reads the QP element tile;
    the tile is the program's default, as benchmark04.prepare leaves it
    without --epb."""
    cfg = Config(dtype=dtype, device=device)
    data = {"basis": basis, "epb_qp": cfg.epb}
    for spec in benchmark04.variant_specs(data, cfg):
        if spec[0] == label:
            return spec[1], spec[2]
    raise ValueError(f"benchmark04 has no column {label!r}")
