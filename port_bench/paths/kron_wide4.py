"""Pallas(Coales) of benchmark04: K2, the kron GEMM out[b] = C @ in[b]
over chunks of ce elements, on the JAX package's 4D chunk layout
(kernels/bwdtrans2d.kron_wide4, a view for kron_blocked, through
kernels/build.py into csrc/bwdtrans2d.cu; at b04 8^2 its C-resident
configuration).

    in_blk_w4 (E/ce, nmTot, ce/128, 128), C = c_coa (nqTot, nmTot)
    out       (E/ce, nqTot, ce/128, 128)
"""

from tpu_bench_torch.ops import bwdtrans

LABEL = "Pallas(Coales)"
LAUNCHES = ("kron_blocked",)


def layout(coef, basis, ops) -> dict:
    """The operands of the column's spec: coef (E, nmTot) in chunks of the
    program's width (bwdtrans.kron_chunk), each chunk's modes contiguous
    and its elements in rows of 128, and C as benchmark04.prepare makes
    it."""
    e, nm_tot = coef.shape
    ce = bwdtrans.kron_chunk(e)
    in_blk = coef.reshape(e // ce, ce, nm_tot).permute(0, 2, 1).contiguous()
    return dict(in_blk_w4=in_blk.view(e // ce, nm_tot, ce // 128, 128),
                c_coa=ops["c_em"].T.contiguous())


def rows(out, nq, e0: int, e1: int):
    """Elements e0..e1 of the output as (e1 - e0, nqTot), i fastest."""
    nq_tot = out.shape[1]
    ce = out.shape[2] * out.shape[3]
    first, last = e0 // ce, -(-e1 // ce)
    block = out[first:last].reshape(-1, nq_tot, ce).permute(0, 2, 1)
    return block.reshape(-1, nq_tot)[e0 - first * ce:e1 - first * ce]
