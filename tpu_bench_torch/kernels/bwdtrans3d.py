"""K1: the fused 3D sum-factorization, benchmark05's Pallas(QP/Shared) column.

Port of tpu_bench/kernels/bwdtrans3d.py:qp_shared3d and qp_shared3d_flat.
Both compute, for every element e and output plane i,

    out[i] = C12T @ (sum_p B0[p, i] * in[p])

with the p-major coalesced input (nm0, nrq, E), nrq = nm2*nm1, and the
i-major output (nq0, nkj, E), nkj = nq2*nq1.  The flat wrapper takes the
same bytes viewed as (nm0*nrq, E) and returns (nq0*nkj, E), so one CUDA
kernel (csrc/bwdtrans3d.cu) serves both.

A tensor on the CPU goes to the plain PyTorch version in this module; a
tensor on a CUDA device goes to the kernel, which raises rather than fall
back when it cannot run.
"""

from __future__ import annotations

import torch

from tpu_bench_torch.kernels import build

# Elements (= threads) per block.  A tuning knob only: the kernel masks the
# ragged edge, so any E works.  On the H100 at E=131072, 128 timed within
# 1.1% of the best of 32/64/128/256 at nq=8^3 and nq=10^3 in f32 and f64,
# while 64 lost 35% at nq=10^3 and 32 and 256 lost 15-25% at nq=8^3
# (NVIDIA H100 80GB HBM3 at 700 W; PERF.md).
EPB = 128
# Largest nm2*nm1 the kernel keeps in registers (nq=10 isotropic).
MAX_NRQ = 81

launches = 0  # K1 launches on a CUDA device


def qp_shared3d_plain(in_pcoa3, b0, c12t):
    """Plain PyTorch version of qp_shared3d."""
    v = torch.einsum("pi,pre->ire", b0, in_pcoa3)  # (nq0, nrq, E)
    return torch.matmul(c12t, v)                    # (nq0, nkj, E)


def qp_shared3d_flat_plain(in_pflat, b0, c12t, *, nrq):
    """Plain PyTorch version of qp_shared3d_flat."""
    nm_tot, e = in_pflat.shape
    out = qp_shared3d_plain(in_pflat.reshape(nm_tot // nrq, nrq, e), b0, c12t)
    return out.reshape(-1, e)


def qp_shared3d(in_pcoa3, b0, c12t, *, epb=EPB):
    """out (nq0, nkj, E) from in (nm0, nrq, E), b0 (nm0, nq0),
    c12t (nkj, nrq)."""
    if in_pcoa3.dim() != 3:
        raise ValueError(f"in_pcoa3 must be (nm0, nrq, E), got "
                         f"{tuple(in_pcoa3.shape)}")
    nm0, nrq, e = in_pcoa3.shape
    out = qp_shared3d_flat(in_pcoa3.reshape(nm0 * nrq, e), b0, c12t, nrq=nrq,
                           epb=epb)
    return out.reshape(-1, c12t.shape[0], e)


def qp_shared3d_flat(in_pflat, b0, c12t, *, nrq, epb=EPB):
    """out (nq0*nkj, E) from in (nm0*nrq, E), rows p*nrq + rq."""
    _check(in_pflat, b0, c12t, nrq)
    if in_pflat.device.type == "cpu":
        return qp_shared3d_flat_plain(in_pflat, b0, c12t, nrq=nrq)
    if in_pflat.device.type != "cuda":
        raise ValueError(f"qp_shared3d: no kernel for device {in_pflat.device}")
    return _launch(in_pflat, b0, c12t, nrq, epb)


def _check(x, b0, c12t, nrq):
    tensors = (x, b0, c12t)
    if x.dtype == torch.bfloat16:
        raise NotImplementedError("qp_shared3d: bf16 is not ported yet "
                                  "(ROADMAP Queue 1 item 5)")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"qp_shared3d: dtype {x.dtype} is not supported")
    if any(t.dtype != x.dtype for t in tensors):
        raise TypeError("qp_shared3d: in, b0 and c12t must share one dtype")
    if any(t.device != x.device for t in tensors):
        raise ValueError("qp_shared3d: in, b0 and c12t must share one device")
    if any(t.dim() != 2 for t in tensors):
        raise ValueError("qp_shared3d: in, b0 and c12t must be 2D")
    if x.shape[0] != b0.shape[0] * nrq or c12t.shape[1] != nrq:
        raise ValueError(f"qp_shared3d: shapes in {tuple(x.shape)}, b0 "
                         f"{tuple(b0.shape)}, c12t {tuple(c12t.shape)} do not "
                         f"agree with nrq={nrq}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("qp_shared3d: in, b0 and c12t must be contiguous")


def _launch(x, b0, c12t, nrq, epb):
    global launches
    nm0, nq0 = b0.shape
    nkj = c12t.shape[0]
    e = x.shape[1]
    if nrq > MAX_NRQ:
        raise ValueError(f"qp_shared3d: nrq={nrq} exceeds the kernel's "
                         f"register bucket of {MAX_NRQ}")
    if not 0 < epb <= 1024:
        raise ValueError(f"qp_shared3d: epb={epb} is not a CUDA block size")
    smem = (nm0 * nq0 + nkj * nrq) * x.element_size()
    props = torch.cuda.get_device_properties(x.device)
    limit = getattr(props, "shared_memory_per_block_optin", 232448)
    if smem > limit:
        raise ValueError(f"qp_shared3d: operators need {smem} B of shared "
                         f"memory, the device allows {limit}")
    out = torch.empty((nq0 * nkj, e), dtype=x.dtype, device=x.device)
    lib = build.library()
    fn = (lib.tbt_qp_fused3d_f32 if x.dtype == torch.float32
          else lib.tbt_qp_fused3d_f64)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), b0.data_ptr(), c12t.data_ptr(), out.data_ptr(),
                 nm0, nrq, nq0, nkj, e, epb, stream)
    build.check(err, "qp_fused3d")
    launches += 1
    return out
