"""K2 and K3: the dense GEMMs over the element stream.

K2, benchmark05's Pallas(Coales) column and stage 1 of Pallas(QP), is the
port of tpu_bench/kernels/bwdtrans2d.py:kron_blocked:

    out[b] = C @ in[b]    in (nblk, nmTot, ce), C (nqTot, nmTot)
                          -> out (nblk, nqTot, ce)

K3 (em_gemm), benchmark05's Pallas(Uncoales) column and the three stages
of Pallas(QP-1D), is the port of kron_elem_major and _one_stage_em, the
element-major product with elements on rows:

    out (E, N) = in (E, K) @ S (K, N)

The rest of tpu_bench/kernels/bwdtrans2d.py, benchmark04's 2D kernels, is
served by kernels that already compute each function on the same bytes;
the TPU kernels' differences were DMA, sublane or MXU-tile geometry:

    kron_coalesced                   kron_coalesced below: K2 on the
                                     (1, nmTot, E) view of the flat layout
    kron_wide4, kron_vpu_blocked     kron_wide4 below: K2 on a view of
                                     the 4D chunk layout
    qp_shared, qp_w, qp_w_flat,      K1, kernels/bwdtrans3d.qp_shared3d
    qp_mxu_grouped                   with nrq = nm1 and C12T = B1^T
    qp_global                        bwdtrans3d.qp_global3d: K2, then K4
    qp1d_shared                      bwdtrans3d.qp1d_fused: K5, two stages
    qp1d_global                      qp1d_global below: K3 twice

A tensor on the CPU goes to the plain PyTorch version; a tensor on a CUDA
device goes to the kernel (csrc/), which raises rather than fall back when
it cannot run.
"""

from __future__ import annotations

import torch

from tpu_bench_torch.kernels import build

_GRID_YZ_MAX = 65535  # CUDA's limit on gridDim.y and gridDim.z
_BN = 128             # output tile width of the kernel (csrc/bwdtrans2d.cu)
EM_TILE = 128         # K3's element rows per block: the tile height BM


def kron_blocked_plain(in_blk, c_coa):
    """Plain PyTorch version of kron_blocked."""
    return torch.matmul(c_coa, in_blk)


def kron_blocked(in_blk, c_coa):
    """out (nblk, nqTot, ce) = C (nqTot, nmTot) @ in (nblk, nmTot, ce)."""
    _check(in_blk, c_coa)
    if in_blk.device.type == "cpu":
        return kron_blocked_plain(in_blk, c_coa)
    if in_blk.device.type != "cuda":
        raise ValueError(f"kron_blocked: no kernel for device {in_blk.device}")
    return _launch(in_blk, c_coa)


def _check(x, c):
    if x.dtype == torch.bfloat16:
        raise NotImplementedError("kron_blocked: bf16 is not ported yet "
                                  "(ROADMAP Queue 1 item 2)")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kron_blocked: dtype {x.dtype} is not supported")
    if c.dtype != x.dtype:
        raise TypeError("kron_blocked: in and C must share one dtype")
    if c.device != x.device:
        raise ValueError("kron_blocked: in and C must share one device")
    if x.dim() != 3 or c.dim() != 2 or c.shape[1] != x.shape[1]:
        raise ValueError(f"kron_blocked: in {tuple(x.shape)} and C "
                         f"{tuple(c.shape)} are not (nblk, nmTot, ce) and "
                         "(nqTot, nmTot)")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError("kron_blocked: in and C must be contiguous")


def _launch(x, c):
    nblk, nm_tot, ce = x.shape
    nq_tot = c.shape[0]
    if nblk > _GRID_YZ_MAX or -(-ce // _BN) > _GRID_YZ_MAX:
        raise ValueError(f"kron_blocked: {nblk} chunks of {ce} elements "
                         "exceed the kernel's grid")
    out = torch.empty((nblk, nq_tot, ce), dtype=x.dtype, device=x.device)
    lib = build.library()
    fn = (lib.tbt_kron_blocked_f32 if x.dtype == torch.float32
          else lib.tbt_kron_blocked_f64)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(c.data_ptr(), x.data_ptr(), out.data_ptr(), nq_tot, nm_tot,
                 ce, nblk, stream)
    build.launched(err, "kron_blocked")
    return out


def kron_coalesced_plain(in_coa, c_coa):
    """Plain PyTorch version of kron_coalesced."""
    return torch.matmul(c_coa, in_coa)


def kron_coalesced(in_coa, c_coa, *, epb=None):
    """out (nqTot, E) = C (nqTot, nmTot) @ in (nmTot, E), the flat
    coalesced layout: K2 on the (1, nmTot, E) view, whose grid takes E up
    to 65535 output tiles of 128.  `epb`, the TPU kernel's element block,
    is accepted and ignored."""
    if in_coa.dim() != 2:
        raise ValueError(f"kron_coalesced: in {tuple(in_coa.shape)} is not "
                         "(nmTot, E)")
    nm_tot, e = in_coa.shape
    out = kron_blocked(in_coa.view(1, nm_tot, e), c_coa)
    return out.view(c_coa.shape[0], e)


def kron_elem_major_plain(in_em2, c_em):
    """Plain PyTorch version of kron_elem_major and one_stage_em."""
    return torch.matmul(in_em2, c_em)


def kron_elem_major(in_em2, c_em, *, epb=None):
    """out (E, nqTot) = in (E, nmTot) @ C_em (nmTot, nqTot).  `epb`, the
    elements per block, is the kernel's tile height: None or EM_TILE."""
    return _em_gemm("kron_elem_major", in_em2, c_em, epb)


def one_stage_em(x, s, *, epb=None):
    """One element-major stage, out (E, N) = x (E, K) @ s (K, N)."""
    return _em_gemm("one_stage_em", x, s, epb)


def _em_gemm(name, x, s, epb):
    build.check_operands(name, (x, s))
    if x.dim() != 2 or s.dim() != 2 or s.shape[0] != x.shape[1]:
        raise ValueError(f"{name}: in {tuple(x.shape)} and S "
                         f"{tuple(s.shape)} are not (E, K) and (K, N)")
    if epb not in (None, EM_TILE):
        raise ValueError(f"{name}: the kernel tiles {EM_TILE} elements per "
                         f"block, not epb={epb}")
    if x.device.type == "cpu":
        return kron_elem_major_plain(x, s)
    e, k = x.shape
    n = s.shape[1]
    if max(e, k, n) >= 2**31:
        raise ValueError(f"{name}: {tuple(x.shape)} @ {tuple(s.shape)} "
                         "exceeds the kernel's 32-bit extents")
    out = torch.empty((e, n), dtype=x.dtype, device=x.device)
    build.run("em_gemm", x, x.data_ptr(), s.data_ptr(), out.data_ptr(), e, k,
              n)
    return out


# ---- benchmark04 (2D) ------------------------------------------------------


def kron_wide4_plain(in_blk4, c_coa):
    """Plain PyTorch version of kron_wide4."""
    nblk, nm, cr, lanes = in_blk4.shape
    out = torch.matmul(c_coa, in_blk4.reshape(nblk, nm, cr * lanes))
    return out.reshape(nblk, c_coa.shape[0], cr, lanes)


def kron_wide4(in_blk4, c_coa):
    """out (nblk, nqTot, cr, lanes) = C (nqTot, nmTot) @ in (nblk, nmTot,
    cr, lanes) per chunk: K2 on the contiguous bytes viewed (nblk, nmTot,
    cr*lanes)."""
    if in_blk4.dim() != 4 or not in_blk4.is_contiguous():
        raise ValueError(f"kron_wide4: in {tuple(in_blk4.shape)} is not a "
                         "contiguous (nblk, nmTot, cr, lanes) tensor")
    nblk, nm, cr, lanes = in_blk4.shape
    out = kron_blocked(in_blk4.view(nblk, nm, cr * lanes), c_coa)
    return out.view(nblk, c_coa.shape[0], cr, lanes)


def qp1d_plain(in_em2, s1_em, s2_em):
    """Plain PyTorch version of the two-stage chain (qp1d_global and
    bwdtrans3d.qp1d_fused with two operators)."""
    return torch.matmul(torch.matmul(in_em2, s1_em), s2_em)


def qp1d_global(in_em2, s1_em, s2_em, *, epb=None):
    """The chain as two K3 launches, the workspace in device memory."""
    return one_stage_em(one_stage_em(in_em2, s1_em, epb=epb), s2_em, epb=epb)
