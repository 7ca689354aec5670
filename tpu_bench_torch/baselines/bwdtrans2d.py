"""Library-tier 2D BwdTrans variants for benchmark04 (port of
tpu_bench/baselines/bwdtrans2d.py).

These are the reference's library columns (four Kokkos quad formulations
and the cuBLAS gemm path, benchmark04/benchmark04.cc:489-825) as
torch.einsum / torch.matmul calls, which go to cuBLAS on the card.  They are
not ports of a hand kernel.  TF32, and whether cuBLAS may sum bf16
products in bf16, is governed by Config.library_precision.  In bf16 each
call's result is bf16, so the staged columns keep bf16 workspaces, as the
JAX package's einsum chains do.
The JAX package's chunk_elems (element chunking of these columns) is not
ported: benchmark04's residency model fits every order's largest sweep
size on the card without it.
"""

from __future__ import annotations

import torch


def einsum_em(in_em3, b0, b1):
    """Element-major einsum (Kokkos uncoalesced analog)."""
    return torch.einsum("eqp,pi,qj->eji", in_em3, b0, b1)


def einsum_coa(in_coa3, b0, b1):
    """Coalesced-layout einsum (Kokkos coalesced analog)."""
    return torch.einsum("qpe,pi,qj->jie", in_coa3, b0, b1)


def staged_em(in_em3, b0, b1):
    """Explicit two-stage contraction with a materialized workspace
    (Kokkos QP analog)."""
    w = torch.einsum("eqp,pi->eqi", in_em3, b0)
    return torch.einsum("eqi,qj->eji", w, b1)


def staged_dotgeneral(in_em3, b0, b1):
    """Two-stage via tensordot + transpose (Kokkos QP/shared analog)."""
    w = torch.tensordot(in_em3, b0, dims=([2], [0]))  # (E, nm1, nq0)
    out = torch.tensordot(w, b1, dims=([1], [0]))      # (E, nq0, nq1)
    return out.transpose(1, 2)                         # (E, nq1, nq0)


def gemm_kron(in_coa, c_coa):
    """Single library GEMM on the kron operator (cuBLAS tier):
    out_coa = C_coa @ in_coa."""
    return torch.matmul(c_coa, in_coa)
