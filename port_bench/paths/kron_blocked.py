"""Pallas(Coales): K2, the kron GEMM out[b] = C @ in[b] over chunks of
ce elements (kernels/bwdtrans2d.kron_blocked through kernels/build.py
into csrc/bwdtrans2d.cu; at b05 8^3 its dense configuration on the
tensor cores).

    in_blk (E/ce, nmTot, ce), C = c_coa3 (nqTot, nmTot)
    out    (E/ce, nqTot, ce)
"""

from tpu_bench_torch.ops import bwdtrans

LABEL = "Pallas(Coales)"
LAUNCHES = ("kron_blocked",)


def layout(coef, basis, ops) -> dict:
    """The operands of the column's spec: coef (E, nmTot) in chunks of the
    program's width (bwdtrans.kron_chunk), each chunk's modes contiguous,
    and C as benchmark05.prepare makes it."""
    e, nm_tot = coef.shape
    ce = bwdtrans.kron_chunk(e)
    in_blk = coef.reshape(e // ce, ce, nm_tot).permute(0, 2, 1)
    return dict(in_blk=in_blk.contiguous(),
                c_coa3=ops["c_em3"].T.contiguous())


def rows(out, nq, e0: int, e1: int):
    """Elements e0..e1 of the output as (e1 - e0, nqTot), i fastest."""
    ce = out.shape[2]
    first, last = e0 // ce, -(-e1 // ce)
    block = out[first:last].permute(0, 2, 1).reshape(-1, out.shape[1])
    return block[e0 - first * ce:e1 - first * ce]
