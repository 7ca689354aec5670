"""Benchmark 05: 3D tensor-product sum-factorization (BwdTrans hex), port of
tpu_bench/benchmarks/benchmark05.py.

Reference: benchmark05/benchmark05.cc (harness :619-1421, CLI :1423-1442:
`nq0 nq1 nq2 threads elblocks`).  Eleven columns; GDOF/s counts input DOFs:
1e-9*nelmt*nm0*nm1*nm2/t (:1407-1419).  Sweep: nelmt = 128 .. 1,048,576.

All eleven columns are live: the five library columns (torch.einsum /
matmul) and six hand columns through the port's CUDA kernels:
Pallas(Uncoales) K3, Pallas(Coales) K2, Pallas(QP) K2 + K4,
Pallas(QP/Shared) K1, Pallas(QP-1D) three K3 launches and
Pallas(QP-1D/Shared) K5 (kernels/bwdtrans2d.py, kernels/bwdtrans3d.py).
The f64 Pallas(Coales) column is K2 built in double, or under
`--f64-coales ozaki` the JAX package's split-mantissa slice GEMM through
K14 (kernels/ozaki.py).  The column labels keep the reference names so
postprocess/ reads the log unchanged.

    python -m tpu_bench_torch.benchmarks.benchmark05 8 8 8 [--device cuda]
        [--dtype f64 --f64-coales ozaki]
"""

from __future__ import annotations

import functools

from tpu_bench_torch.baselines import bwdtrans3d as lib_bt
from tpu_bench_torch.core.config import Config
from tpu_bench_torch.core.reporting import Reporter
from tpu_bench_torch.core.validate import measure_row
from tpu_bench_torch.core.variants import LABELS, Layouts, materialize
from tpu_bench_torch.kernels import bwdtrans2d as k2
from tpu_bench_torch.kernels import bwdtrans3d as k1
from tpu_bench_torch.kernels import ozaki
from tpu_bench_torch.ops import bwdtrans, initdata


def variant_specs(data, cfg):
    """Ordered (label, fn, operand keys); keys resolve lazily (Layouts)."""
    basis = data["basis"]
    # One kernel serves the plane and flat QP layouts (same bytes); the JAX
    # package's choice between them was TPU sublane geometry.
    qp = functools.partial(k1.qp_shared3d_flat, nrq=basis.nm2 * basis.nm1,
                           epb=data["epb_qp"])
    return [
        ("XLA(Uncoales)", lib_bt.einsum_em, ("in_em4", "b0", "b1", "b2")),
        ("XLA(Coales)", lib_bt.einsum_coa, ("in_coa4", "b0", "b1", "b2")),
        ("XLA(QP)", lib_bt.staged_em, ("in_em4", "b0", "b1", "b2")),
        ("XLA(QP/DG)", lib_bt.staged_dotgeneral, ("in_em4", "b0", "b1", "b2")),
        ("XLA(GEMM)", lib_bt.gemm_kron, ("in_coa", "c_coa3")),
        ("Pallas(Uncoales)", k2.kron_elem_major, ("in_em2", "c_em3")),
        ozaki.coales_pair_spec(data) if cfg.f64_coales == "ozaki" else
        ("Pallas(Coales)", k2.kron_blocked, ("in_blk", "c_coa3")),
        ("Pallas(QP)", k1.qp_global3d, ("in_pcoa3", "b0", "c12t")),
        ("Pallas(QP/Shared)", qp, ("in_pflat", "b0", "c12t")),
        ("Pallas(QP-1D)", k1.qp1d_global3d,
         ("in_em2", "s1_em", "s2_em", "s3_em")),
        ("Pallas(QP-1D/Shared)", k1.qp1d_shared3d,
         ("in_em2", "s1_em", "s2_em", "s3_em")),
    ]


def build_variants(data, cfg):
    """(label, fn, args) with every operand materialized: test-suite and
    small-size convenience; sweeps use variant_specs + lazy resolution."""
    return materialize(variant_specs(data, cfg), data)


def prepare(nq0: int, nq1: int, nq2: int, nelmt: int, cfg: Config) -> Layouts:
    basis = bwdtrans.make_basis3d(nq0, nq1, nq2, cfg.dtype, cfg.device)
    e_pad = initdata.round_up(nelmt, 128)
    nm0, nm1, nm2 = basis.nm0, basis.nm1, basis.nm2
    nm_tot = basis.nm_tot
    elem = bwdtrans.element_data3d(basis, cfg.dtype)
    src = bwdtrans.stream_sources(elem, (nm2, nm1, nm0), nelmt, e_pad,
                                  cfg.dtype)
    c_em3, c12t, s1_em, s2_em, s3_em = bwdtrans.operators3d(basis)
    ce = bwdtrans.kron_chunk(e_pad)
    data = Layouts(
        base=dict(
            basis=basis,
            nelmt=nelmt,
            e_pad=e_pad,
            epb_qp=cfg.epb or k1.EPB,
            ce=ce,
            b0=basis.b0, b1=basis.b1, b2=basis.b2,
            c12t=c12t,
            c_em3=c_em3,
            c_coa3=c_em3.T.contiguous(),
            s1_em=s1_em, s2_em=s2_em, s3_em=s3_em,
        ),
        # every layout of the element stream is built fresh from the
        # coefficient vector, one at a time
        derived=dict(
            in_em2=src["em2"],
            in_coa=src["coa"],
            in_em4=lambda: src["em2"]().reshape(e_pad, nm2, nm1, nm0),
            in_coa4=lambda: src["coa"]().reshape(nm2, nm1, nm0, e_pad),
            in_pcoa3=src["pcoa3"],
            # the same bytes as pcoa3, viewed (nmTot, E)
            in_pflat=lambda: src["pcoa3"]().reshape(nm_tot, e_pad),
            in_blk=lambda: src["blk"](ce),
        ),
    )
    if cfg.f64_coales == "ozaki":
        ozaki.prepare_f64_tier(data, data["c_coa3"], elem, nelmt, e_pad)
    return data


def run_test(nelmt: int, nq0: int, nq1: int, nq2: int, cfg: Config,
             reporter: Reporter) -> None:
    data = prepare(nq0, nq1, nq2, nelmt, cfg)
    measure_row("b05", LABELS, variant_specs(data, cfg), data, cfg, reporter,
                key="nelmt", size=nelmt,
                work=nelmt * (nq0 - 1) * (nq1 - 1) * (nq2 - 1),
                unit="DOF/s")


def main(argv=None):
    from tpu_bench_torch.benchmarks import cli

    parser = cli.build_parser(
        "benchmark05",
        positionals=[("nq0", 8), ("nq1", 8), ("nq2", 8), ("threads", None),
                     ("elblocks", None)],
        f64_coales=True,
    )
    args = parser.parse_args(argv)
    cfg = Config.from_flags(args)
    if cfg.epb is None and args.threads and args.elblocks:
        cfg.epb = args.threads * args.elblocks
    nq0, nq1, nq2 = args.nq0, args.nq1, args.nq2
    nm_tot = (nq0 - 1) * (nq1 - 1) * (nq2 - 1)
    nq_tot = nq0 * nq1 * nq2
    reporter = Reporter("Benchmark05 : BwdTrans (3D)")
    reporter.sweep_title(f"BwdTrans (NQ = {nq0}, {nq1}, {nq2})")
    cap = cfg.mem_cap_bytes
    # residency: one input layout, two outputs (the timed one and the one
    # being normed) and two stage workspaces.  That bounds every column:
    # the staged library columns and Pallas(QP-1D) hold two workspaces
    # (Pallas(QP-1D) nm2*nm1*nq0 and nm2*nq1*nq0 per element, at most wsp
    # each) beside one output; Pallas(QP) holds one, nm0*nq1*nq2 < nqTot.
    # Under --f64-coales ozaki the Pallas(Coales) column holds the bf16
    # element slices and the (hi, lo) pairs instead (ozaki.bytes_per_elem).
    wsp = max((nq2 - 1) * (nq1 - 1) * nq0, (nq2 - 1) * nq1 * nq0)
    per_elem = (nm_tot + 2 * nq_tot + 2 * wsp) * cfg.itemsize
    if cfg.f64_coales == "ozaki":
        per_elem = max(per_elem, ozaki.bytes_per_elem(nm_tot, nq_tot))
    with cli.profiled(args):
        for nelmt in cli.sweep(128, 1048576, args):
            need = per_elem * nelmt
            if need > cap:
                reporter.note(f"b05: stopping sweep at nelmt {nelmt} "
                              "(memory cap)")
                break
            cli.guarded(reporter, "b05", nelmt, run_test, nelmt, nq0, nq1,
                        nq2, cfg, reporter)


if __name__ == "__main__":
    main()
