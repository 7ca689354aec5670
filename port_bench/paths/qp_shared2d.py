"""Pallas(QP/Shared) of benchmark04: K1, the fused QP sum factorization, on
the 2D plane view (kernels/bwdtrans3d.qp_shared3d with nrq = nm1 and
C12T = B1^T, through kernels/build.py into csrc/bwdtrans3d.cu).

    in_pcoa3 (nm0, nm1, E), in[p, q, e]
    out      (nq0, nq1, E), out[i, j, e]
"""

# The column's label in benchmarks/benchmark04.variant_specs.
LABEL = "Pallas(QP/Shared)"
# The kernels a call launches, as kernels/build.launches counts them.
LAUNCHES = ("qp_fused3d",)


def layout(coef, basis, ops) -> dict:
    """The operands of the column's spec: coef (E, nmTot), p fastest, laid
    out p-major with the element index fastest, and B1^T as
    benchmark04.prepare makes it."""
    e = coef.shape[0]
    in_pcoa3 = coef.reshape(e, basis.nm1, basis.nm0).permute(2, 1, 0)
    return dict(in_pcoa3=in_pcoa3.contiguous(), b0=basis.b0,
                b1t=basis.b1.T.contiguous())


def rows(out, nq, e0: int, e1: int):
    """Elements e0..e1 of the output as (e1 - e0, nqTot), i fastest; nq
    is (nq0, nq1)."""
    return out[:, :, e0:e1].permute(2, 1, 0).reshape(e1 - e0, -1)
