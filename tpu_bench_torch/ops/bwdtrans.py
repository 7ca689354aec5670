"""2D and 3D tensor-product sum-factorization ("BwdTrans") machinery for
benchmark04 and benchmark05 (port of tpu_bench/ops/bwdtrans.py without its
TPU block-sizing helpers).

Math (reference benchmark04/benchmark04.cc:489-523 and
benchmark05/benchmark05.cc:695-740):

    2D: out[e, j, i]    = sum_{q, p} in[e, q, p] * B0[p, i] * B1[q, j]
    3D: out[e, k, j, i] = sum_{r, q, p} in[e, r, q, p] * B0[p, i] * B1[q, j] * B2[r, k]

with nm_d = nq_d - 1 modes per direction, element data
in[e, flat] = sin(flat + 1) with p the fastest mode (the same for every
element) and basis B_d[m, n] = cos(m*nq_d + n).  Array layouts are the JAX
package's, so the two packages' functions take and return the same shapes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_bench_torch.ops import initdata
from tpu_bench_torch.utils import native


@dataclasses.dataclass
class Basis2D:
    nq0: int
    nq1: int
    b0: torch.Tensor  # (nm0, nq0)
    b1: torch.Tensor  # (nm1, nq1)

    @property
    def nm0(self):
        return self.nq0 - 1

    @property
    def nm1(self):
        return self.nq1 - 1

    @property
    def nm_tot(self):
        return self.nm0 * self.nm1

    @property
    def nq_tot(self):
        return self.nq0 * self.nq1


def make_basis2d(nq0: int, nq1: int, dtype, device) -> Basis2D:
    return Basis2D(
        nq0=nq0, nq1=nq1,
        b0=initdata.host_basis_cos(nq0 - 1, nq0, dtype, device),
        b1=initdata.host_basis_cos(nq1 - 1, nq1, dtype, device),
    )


def element_data2d(basis: Basis2D, dtype) -> torch.Tensor:
    """One element's mode coefficients, flat (nmTot,) with rows (q, p)
    p-minor: sin(flat + 1), on the basis's device."""
    elem = native.init_sin1(basis.nm_tot)
    return torch.from_numpy(elem).to(device=basis.b0.device, dtype=dtype)


def operators2d(basis: Basis2D):
    """Operator matrices of the benchmark04 columns.

    c_em:  kron(B1, B0)      (nmTot, nqTot)      single-GEMM form
    s1_em: kron(I_nm1, B0)   (nmTot, nm1*nq0)    element-major QP-1D stage 1
    s2_em: kron(B1, I_nq0)   (nm1*nq0, nqTot)    element-major QP-1D stage 2
    """
    b0, b1 = basis.b0, basis.b1

    def eye(n):
        return torch.eye(n, dtype=b0.dtype, device=b0.device)

    return (torch.kron(b1, b0), torch.kron(eye(basis.nm1), b0),
            torch.kron(b1, eye(basis.nq0)))


@dataclasses.dataclass
class Basis3D:
    nq0: int
    nq1: int
    nq2: int
    b0: torch.Tensor  # (nm0, nq0)
    b1: torch.Tensor  # (nm1, nq1)
    b2: torch.Tensor  # (nm2, nq2)

    @property
    def nm0(self):
        return self.nq0 - 1

    @property
    def nm1(self):
        return self.nq1 - 1

    @property
    def nm2(self):
        return self.nq2 - 1

    @property
    def nm_tot(self):
        return self.nm0 * self.nm1 * self.nm2

    @property
    def nq_tot(self):
        return self.nq0 * self.nq1 * self.nq2


def make_basis3d(nq0: int, nq1: int, nq2: int, dtype, device) -> Basis3D:
    return Basis3D(
        nq0=nq0, nq1=nq1, nq2=nq2,
        b0=initdata.host_basis_cos(nq0 - 1, nq0, dtype, device),
        b1=initdata.host_basis_cos(nq1 - 1, nq1, dtype, device),
        b2=initdata.host_basis_cos(nq2 - 1, nq2, dtype, device),
    )


def element_data3d(basis: Basis3D, dtype) -> torch.Tensor:
    """One element's mode coefficients, flat (nmTot,) with rows (r, q, p)
    p-minor: sin(flat + 1), on the basis's device."""
    elem = native.init_sin1(basis.nm_tot)
    return torch.from_numpy(elem).to(device=basis.b0.device, dtype=dtype)


def operators3d(basis: Basis3D):
    """Operator matrices of the benchmark05 columns.

    c_em3:  kron(B2, B1, B0)   (nmTot, nqTot)      single-GEMM form
    c12t:   kron(B2^T, B1^T)   (nq2*nq1, nm2*nm1)  pair stage of the QP
                                                   kernels (contract q, r)
    s1/s2/s3_em: the dense, mostly-zero per-stage operators of the
                 element-major QP-1D columns, (nmTot, nm2*nm1*nq0),
                 (nm2*nm1*nq0, nm2*nq1*nq0), (nm2*nq1*nq0, nqTot)
    """
    b0, b1, b2 = basis.b0, basis.b1, basis.b2

    def eye(n):
        return torch.eye(n, dtype=b0.dtype, device=b0.device)

    c_em3 = torch.kron(b2, torch.kron(b1, b0))
    c12t = torch.kron(b2.T.contiguous(), b1.T.contiguous())
    s1_em = torch.kron(eye(basis.nm2 * basis.nm1), b0)
    s2_em = torch.kron(eye(basis.nm2), torch.kron(b1, eye(basis.nq0)))
    s3_em = torch.kron(b2, eye(basis.nq1 * basis.nq0))
    return c_em3, c12t, s1_em, s2_em, s3_em


def stream_sources(elem_flat, nm_shape, nelmt: int, e_pad: int, dtype):
    """Builders of the element stream in each layout, each materializing a
    fresh contiguous tensor from the per-element coefficient vector, so a
    sweep holds one layout at a time.  Elements past nelmt are zero.

    nm_shape is (nm1, nm0) in 2D or (nm2, nm1, nm0) in 3D.  Builders:
      em2        (E, nmTot)           element-major
      coa        (nmTot, E)           coalesced (element index fastest)
      pcoa3      (nm0, rest, E)       p-major coalesced (fused QP kernel)
      blk(ce)    (E/ce, nmTot, ce)    chunk-interleaved coalesced
    The padding holds +0.0, as the JAX package's jnp.where gives, so every
    layout is its bytes.
    """
    nm_shape = tuple(int(n) for n in nm_shape)
    nm0 = nm_shape[-1]
    nm_tot = int(np.prod(nm_shape))
    elem = elem_flat.to(dtype)
    live = torch.arange(e_pad, device=elem.device) < nelmt
    zero = torch.zeros((), dtype=dtype, device=elem.device)

    def em2():
        return torch.where(live[:, None], elem[None, :], zero)

    def coa():
        return torch.where(live[None, :], elem[:, None], zero)

    def pcoa3():
        ep = elem.reshape(nm_tot // nm0, nm0).T.contiguous()  # (nm0, rest)
        return torch.where(live, ep[:, :, None], zero)

    def blk(ce):
        return torch.where(live.reshape(e_pad // ce, 1, ce),
                           elem[None, :, None], zero)

    return dict(em2=em2, coa=coa, pcoa3=pcoa3, blk=blk)


# Widest element chunk of the Pallas(Coales) layout.  K2 tiles each chunk
# into 128-wide output tiles and runs all chunks in one launch, so the
# width only splits the batch: any multiple of 128 gives the same blocks
# (on an NVIDIA H100 80GB HBM3 at 700 W, 1024 to 32768 timed within 4% of
# each other; PERF.md).
# 8192 keeps the chunk count within CUDA's grid limit up to 512Mi elements.
KRON_CHUNK = 8192


def kron_chunk(e_pad: int) -> int:
    """Largest power-of-two chunk width <= KRON_CHUNK dividing e_pad."""
    ce = 128
    while ce * 2 <= min(e_pad, KRON_CHUNK) and e_pad % (ce * 2) == 0:
        ce *= 2
    return ce


def blocked_coa(in_coa: torch.Tensor, ce: int) -> torch.Tensor:
    """Chunk-interleave the coalesced layout: (nmTot, E) -> (E/ce, nmTot, ce),
    so each ce-element chunk's modes are one contiguous region."""
    nm_tot, e = in_coa.shape
    return in_coa.reshape(nm_tot, e // ce, ce).permute(1, 0, 2).contiguous()


def reference2d(basis: Basis2D, nelmt: int) -> np.ndarray:
    """f64 oracle out (nelmt, nq1, nq0), from the host formulas."""
    elem = native.init_sin1(basis.nm_tot)
    inp = np.broadcast_to(elem, (nelmt, basis.nm_tot)).reshape(
        nelmt, basis.nm1, basis.nm0)
    b0 = native.init_cos(basis.nm0 * basis.nq0).reshape(basis.nm0, basis.nq0)
    b1 = native.init_cos(basis.nm1 * basis.nq1).reshape(basis.nm1, basis.nq1)
    return native.bwdtrans2d_ref(inp, b0, b1)


def reference3d(basis: Basis3D, nelmt: int) -> np.ndarray:
    """f64 oracle out (nelmt, nq2, nq1, nq0), from the host formulas."""
    elem = native.init_sin1(basis.nm_tot)
    inp = np.broadcast_to(elem, (nelmt, basis.nm_tot)).reshape(
        nelmt, basis.nm2, basis.nm1, basis.nm0)
    b0 = native.init_cos(basis.nm0 * basis.nq0).reshape(basis.nm0, basis.nq0)
    b1 = native.init_cos(basis.nm1 * basis.nq1).reshape(basis.nm1, basis.nq1)
    b2 = native.init_cos(basis.nm2 * basis.nq2).reshape(basis.nm2, basis.nq2)
    return native.bwdtrans3d_ref(inp, b0, b1, b2)
