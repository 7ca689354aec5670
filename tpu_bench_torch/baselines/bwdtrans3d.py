"""Library-tier 3D BwdTrans variants for benchmark05 (port of
tpu_bench/baselines/bwdtrans3d.py).

These are the reference's library columns (four Kokkos hex formulations and
the cuBLAS GEMM path, benchmark05/benchmark05.cc:693-1158) as torch.einsum /
torch.matmul calls, which go to cuBLAS on the card.  They are not ports of a
hand kernel.  TF32, and whether cuBLAS may sum bf16 products in bf16, is
governed by Config.library_precision.  In bf16 each call's result is bf16,
so the staged columns keep bf16 workspaces, as the JAX package's einsum
chains do.
"""

from __future__ import annotations

import torch


def einsum_em(in_em4, b0, b1, b2):
    """Element-major einsum (Kokkos uncoalesced hex analog)."""
    return torch.einsum("erqp,pi,qj,rk->ekji", in_em4, b0, b1, b2)


def einsum_coa(in_coa4, b0, b1, b2):
    """Coalesced-layout einsum (Kokkos coalesced hex analog)."""
    return torch.einsum("rqpe,pi,qj,rk->kjie", in_coa4, b0, b1, b2)


def staged_em(in_em4, b0, b1, b2):
    """Explicit 3-stage contraction with materialized workspaces
    (Kokkos QP hex analog)."""
    w1 = torch.einsum("erqp,pi->erqi", in_em4, b0)
    w2 = torch.einsum("erqi,qj->erji", w1, b1)
    return torch.einsum("erji,rk->ekji", w2, b2)


def staged_dotgeneral(in_em4, b0, b1, b2):
    """3-stage via tensordot + transpose (Kokkos QP/shared analog)."""
    w1 = torch.tensordot(in_em4, b0, dims=([3], [0]))  # (E, nm2, nm1, nq0)
    w2 = torch.tensordot(w1, b1, dims=([2], [0]))      # (E, nm2, nq0, nq1)
    w3 = torch.tensordot(w2, b2, dims=([1], [0]))      # (E, nq0, nq1, nq2)
    return w3.permute(0, 3, 2, 1)                      # (E, nq2, nq1, nq0)


def gemm_kron(in_coa, c_coa3):
    """Single library GEMM on the full 3D kron operator (cuBLAS tier):
    out_coa = C3_coa @ in_coa."""
    return torch.matmul(c_coa3, in_coa)
