"""Pallas(QP/Shared): K1, the fused QP sum factorization, on the flat
p-major coalesced layout (kernels/bwdtrans3d.qp_shared3d_flat through
kernels/build.py into csrc/bwdtrans3d.cu).

    in_pflat (nm0*nrq, E), row p*nrq + (r*nm1 + q)
    out      (nq0*nkj, E), row i*nkj + (k*nq1 + j)
"""

# The column's label in benchmarks/benchmark05.variant_specs.
LABEL = "Pallas(QP/Shared)"
# The kernels a call launches, as kernels/build.launches counts them.
LAUNCHES = ("qp_fused3d",)


def layout(coef, basis, ops) -> dict:
    """The operands of the column's spec: coef (E, nmTot), p fastest, laid
    out p-major with the element index fastest."""
    e = coef.shape[0]
    in_pflat = coef.reshape(e, -1, basis.nm0).permute(2, 1, 0)
    return dict(in_pflat=in_pflat.contiguous().reshape(-1, e),
                b0=basis.b0, c12t=ops["c12t"])


def rows(out, nq, e0: int, e1: int):
    """Elements e0..e1 of the output as (e1 - e0, nqTot), i fastest; nq
    is (nq0, nq1, nq2)."""
    block = out[:, e0:e1].reshape(nq[0], -1, e1 - e0)
    return block.permute(2, 1, 0).reshape(e1 - e0, -1)
