"""Benchmark 04: 2D tensor-product sum-factorization (BwdTrans quad), port of
tpu_bench/benchmarks/benchmark04.py.

Reference: benchmark04/benchmark04.cc (harness :428-1056, CLI :1058-1075:
`nq0 nq1 threads elblocks`).  Eleven columns, the labels of benchmark05;
GDOF/s counts input DOFs: 1e-9*nelmt*nm0*nm1/t (:1043-1054).  Sweep:
nelmt = 128 .. 1,048,576.

All eleven columns are live at every order: the five library columns
(torch.einsum / matmul) and six hand columns, one kernel path each
(kernels/bwdtrans2d.py, kernels/bwdtrans3d.py): Pallas(Uncoales) K3,
Pallas(Coales) K2 on the 4D chunk layout, Pallas(QP) K2 + K4,
Pallas(QP/Shared) K1, Pallas(QP-1D) two K3 launches and
Pallas(QP-1D/Shared) K5 with two stages.  The JAX
package's per-order choice of TPU kernel for a column (VMEM, sublane and
MXU-tile thresholds) is not carried over: on the card each column is one
kernel built in f32 or f64.  The JAX package's f64 Pallas(Coales), the
split-mantissa slice GEMM, is K14 under `--dtype f64 --f64-coales ozaki`
(kernels/ozaki.py); the default, `native`, is K2 built in double.

    python -m tpu_bench_torch.benchmarks.benchmark04 8 8 [--device cuda]
        [--dtype f64 --f64-coales ozaki]
"""

from __future__ import annotations

import functools

from tpu_bench_torch.baselines import bwdtrans2d as lib_bt
from tpu_bench_torch.core.config import Config
from tpu_bench_torch.core.reporting import Reporter
from tpu_bench_torch.core.validate import measure_row
from tpu_bench_torch.core.variants import LABELS, Layouts, materialize
from tpu_bench_torch.kernels import bwdtrans2d as k2
from tpu_bench_torch.kernels import bwdtrans3d as k1
from tpu_bench_torch.kernels import ozaki
from tpu_bench_torch.ops import bwdtrans, initdata


def variant_specs(data, cfg):
    """Ordered (label, fn, operand keys); keys resolve lazily (Layouts).
    The 2D fused sum-factorization is K1's contraction with nrq = nm1 and
    C12T = B1^T, so the QP columns call the 3D kernels' wrappers."""
    qp = functools.partial(k1.qp_shared3d, epb=data["epb_qp"])
    return [
        ("XLA(Uncoales)", lib_bt.einsum_em, ("in_em3", "b0", "b1")),
        ("XLA(Coales)", lib_bt.einsum_coa, ("in_coa3", "b0", "b1")),
        ("XLA(QP)", lib_bt.staged_em, ("in_em3", "b0", "b1")),
        ("XLA(QP/DG)", lib_bt.staged_dotgeneral, ("in_em3", "b0", "b1")),
        ("XLA(GEMM)", lib_bt.gemm_kron, ("in_coa", "c_coa")),
        ("Pallas(Uncoales)", k2.kron_elem_major, ("in_em2", "c_em")),
        ozaki.coales_pair_spec(data) if cfg.f64_coales == "ozaki" else
        ("Pallas(Coales)", k2.kron_wide4, ("in_blk_w4", "c_coa")),
        ("Pallas(QP)", k1.qp_global3d, ("in_pcoa3", "b0", "b1t")),
        ("Pallas(QP/Shared)", qp, ("in_pcoa3", "b0", "b1t")),
        ("Pallas(QP-1D)", k2.qp1d_global, ("in_em2", "s1_em", "s2_em")),
        ("Pallas(QP-1D/Shared)", k1.qp1d_fused, ("in_em2", "s1_em", "s2_em")),
    ]


def build_variants(data, cfg):
    """(label, fn, args) with every operand materialized: test-suite and
    small-size convenience; sweeps use variant_specs + lazy resolution."""
    return materialize(variant_specs(data, cfg), data)


def prepare(nq0: int, nq1: int, nelmt: int, cfg: Config) -> Layouts:
    basis = bwdtrans.make_basis2d(nq0, nq1, cfg.dtype, cfg.device)
    e_pad = initdata.round_up(nelmt, 128)
    nm0, nm1, nm_tot = basis.nm0, basis.nm1, basis.nm_tot
    elem = bwdtrans.element_data2d(basis, cfg.dtype)
    src = bwdtrans.stream_sources(elem, (nm1, nm0), nelmt, e_pad, cfg.dtype)
    c_em, s1_em, s2_em = bwdtrans.operators2d(basis)
    ce = bwdtrans.kron_chunk(e_pad)
    data = Layouts(
        base=dict(
            basis=basis,
            nelmt=nelmt,
            e_pad=e_pad,
            epb_qp=cfg.epb or k1.EPB,
            b0=basis.b0, b1=basis.b1,
            b1t=basis.b1.T.contiguous(),
            c_em=c_em,
            c_coa=c_em.T.contiguous(),
            s1_em=s1_em, s2_em=s2_em,
        ),
        # every layout of the element stream is built fresh from the
        # coefficient vector, one at a time
        derived=dict(
            in_em2=src["em2"],
            in_coa=src["coa"],
            in_em3=lambda: src["em2"]().reshape(e_pad, nm1, nm0),
            in_coa3=lambda: src["coa"]().reshape(nm1, nm0, e_pad),
            in_pcoa3=src["pcoa3"],
            # the chunk layout (E/ce, nmTot, ce) in the JAX package's 4D
            # form, 128 elements on the minor axis
            in_blk_w4=lambda: src["blk"](ce).reshape(e_pad // ce, nm_tot,
                                                     ce // 128, 128),
        ),
    )
    if cfg.f64_coales == "ozaki":
        ozaki.prepare_f64_tier(data, data["c_coa"], elem, nelmt, e_pad)
    return data


def run_test(nelmt: int, nq0: int, nq1: int, cfg: Config,
             reporter: Reporter) -> None:
    data = prepare(nq0, nq1, nelmt, cfg)
    measure_row("b04", LABELS, variant_specs(data, cfg), data, cfg, reporter,
                key="nelmt", size=nelmt, work=nelmt * (nq0 - 1) * (nq1 - 1),
                unit="DOF/s")


def main(argv=None):
    from tpu_bench_torch.benchmarks import cli

    parser = cli.build_parser(
        "benchmark04",
        positionals=[("nq0", 8), ("nq1", 8), ("threads", None),
                     ("elblocks", None)],
        f64_coales=True,
    )
    args = parser.parse_args(argv)
    cfg = Config.from_flags(args)
    if cfg.epb is None and args.threads and args.elblocks:
        cfg.epb = args.threads * args.elblocks
    nq0, nq1 = args.nq0, args.nq1
    nm_tot = (nq0 - 1) * (nq1 - 1)
    nq_tot = nq0 * nq1
    reporter = Reporter("Benchmark04 : BwdTrans (2D)")
    reporter.sweep_title(f"BwdTrans (NQ = {nq0}, {nq1})")
    cap = cfg.mem_cap_bytes
    # residency: one input layout, two outputs (the timed one and the one
    # being normed) and two stage workspaces, as in benchmark05.  Every
    # column holds at most one workspace per element: nm1*nq0 (the staged
    # library columns, Pallas(QP-1D)) or nm0*nq1 (Pallas(QP)); the second
    # covers a copy torch.einsum may make of a permuted operand.
    # Under --f64-coales ozaki the Pallas(Coales) column holds the bf16
    # element slices and the (hi, lo) pairs instead (ozaki.bytes_per_elem).
    wsp = max((nq1 - 1) * nq0, (nq0 - 1) * nq1)
    per_elem = (nm_tot + 2 * nq_tot + 2 * wsp) * cfg.itemsize
    if cfg.f64_coales == "ozaki":
        per_elem = max(per_elem, ozaki.bytes_per_elem(nm_tot, nq_tot))
    with cli.profiled(args):
        for nelmt in cli.sweep(128, 1048576, args):
            need = per_elem * nelmt
            if need > cap:
                reporter.note(f"b04: stopping sweep at nelmt {nelmt} "
                              "(memory cap)")
                break
            cli.guarded(reporter, "b04", nelmt, run_test, nelmt, nq0, nq1,
                        cfg, reporter)


if __name__ == "__main__":
    main()
