"""K14: the split-mantissa ("Ozaki scheme") f64 GEMM, port of
tpu_bench/kernels/ozaki.py with the same names.

The JAX package built its f64 Pallas(Coales) column this way because its
chip has no f64 units.  The card has them, so benchmarks 04 and 05 keep
native f64 (K2 built in double) by default and run this route under
`--f64-coales ozaki`:

  1. Split (f64, untimed for the columns): x = s * sum_t v_t 2^(-w(t+1)),
     s a power-of-two scale, each slice v_t a signed integer with
     |v_t| <= 2^w, exact in bf16.  T slices cover wT >= 53 bits.
  2. Multiply (K14, csrc/ozaki.cu): for each band u = s+t, the sum of the
     slice products C_s @ X_t, exact in f32 because slice_params keeps
     every partial sum an integer below 2^24.  Products with
     s+t >= max(T_c, T_x) are dropped.
  3. Combine (K14): the bands, scaled by 2^-w(u+2), are folded largest
     first into an f32 (hi, lo) pair by two-sum; the f64 value is
     scale_c * scale_x * (hi + lo), formed on the device in f64.

End-to-end relative error is about 1e-14 against native f64.

A tensor on the CPU goes to the plain PyTorch version; a CUDA tensor goes
to K14, which raises rather than fall back when it cannot run.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from tpu_bench_torch.kernels import build

# K14's element count is a 64-bit int; its rows and depth are 32-bit.
_INT_MAX = 2**31 - 1
# Elements of the f64 temporaries pair_norm forms at a time.
_NORM_CHUNK = 1 << 26


def slice_params(k: int) -> tuple:
    """(w, T) such that every band sum is integer-exact in f32: the widest
    slice width w with (T)·K·2^(2w) < 2^24 at T = ceil(53 / w) + 1."""
    for w in (7, 6, 5, 4):
        t = -(-53 // w)  # wT >= 53: the dropped remainder is < 2^-(wT+1)
        if t * k * (1 << (2 * w)) < (1 << 24):
            return w, t
    raise ValueError(f"contraction depth {k} too deep for exact slicing")


def split_f64_np(x, w: int, t_slices: int):
    """x (f64) -> (slices (T, *x.shape) float32 holding integers with
    |v| <= 2^w, power-of-two scale as a Python float), in NumPy."""
    x = np.asarray(x, np.float64)
    ax = float(np.max(np.abs(x))) if x.size else 0.0
    scale = float(2.0 ** math.ceil(math.log2(ax))) if ax > 0 else 1.0
    r = x / scale
    slices = []
    for t in range(t_slices):
        v = np.round(r * 2.0 ** (w * (t + 1)))
        slices.append(v.astype(np.float32))
        r = r - v * 2.0 ** (-w * (t + 1))
    return np.stack(slices), scale


def split_f64(x: torch.Tensor, w: int, t_slices: int):
    """x (f64 tensor) -> (slices (T, *x.shape) bf16 on x's device, scale as
    a Python float): split_f64_np's values.  torch.round rounds half to
    even, as np.round does."""
    ax = float(x.abs().max()) if x.numel() else 0.0
    scale = float(2.0 ** math.ceil(math.log2(ax))) if ax > 0 else 1.0
    r = x / scale
    slices = []
    for t in range(t_slices):
        v = torch.round(r * 2.0 ** (w * (t + 1)))
        slices.append(v.to(torch.bfloat16))
        r = r - v * 2.0 ** (-w * (t + 1))
    return torch.stack(slices), scale


def _two_sum(a, b):
    """Error-free f32 addition: a + b = s + e exactly (Knuth two-sum)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def bands(t_c: int, t_x: int):
    """(u, the slice indices s of band u) for every band, band 0 first:
    s in [max(0, u - T_x + 1), min(u, T_c - 1)]."""
    return [(u, range(max(0, u - t_x + 1), min(u, t_c - 1) + 1))
            for u in range(max(t_c, t_x))]


def kron_ozaki_pair_plain(in_slices, c_slices):
    """Plain PyTorch version of kron_ozaki_pair and kron_ozaki_band."""
    t_c, _, nm_tot = c_slices.shape
    w, _ = slice_params(nm_tot)
    c, x = c_slices.float(), in_slices.float()
    hi = lo = None
    for u, ss in bands(t_c, in_slices.shape[0]):
        band = sum(torch.matmul(c[s], x[u - s]) for s in ss)
        scaled = band * 2.0 ** (-w * (u + 2))
        if hi is None:
            hi, lo = scaled, torch.zeros_like(scaled)
        else:
            hi, e = _two_sum(hi, scaled)
            lo = lo + e
    return hi, lo


def kron_ozaki_pair(in_slices, c_slices, *, epb=None):
    """(hi, lo) f32 (nqTot, E) = (C @ X) / (scale_c * scale_in) for the
    pre-split operands in_slices (T_x, nmTot, E) and c_slices (T_c, nqTot,
    nmTot), bf16: every band in one launch of K14.  `epb`, the TPU
    kernel's element block, is accepted and ignored."""
    return _ozaki("kron_ozaki_pair", in_slices, c_slices, band_form=False)


def kron_ozaki_band(in_slices, c_slices, *, epb=None):
    """kron_ozaki_pair's result with one launch of K14 per band, each
    folding its band into the (hi, lo) the earlier ones left.  `epb` is
    accepted and ignored."""
    return _ozaki("kron_ozaki_band", in_slices, c_slices, band_form=True)


def _ozaki(name, x, c, band_form):
    if x.dtype != torch.bfloat16 or c.dtype != torch.bfloat16:
        raise TypeError(f"{name}: slices must be bf16, not {x.dtype} and "
                        f"{c.dtype}")
    if x.dim() != 3 or c.dim() != 3 or c.shape[2] != x.shape[1]:
        raise ValueError(f"{name}: in {tuple(x.shape)} and C "
                         f"{tuple(c.shape)} are not (T_x, nmTot, E) and "
                         "(T_c, nqTot, nmTot)")
    if c.device != x.device:
        raise ValueError(f"{name}: in and C must share one device")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError(f"{name}: in and C must be contiguous")
    if x.is_cpu:
        return kron_ozaki_pair_plain(x, c)
    if not x.is_cuda:
        raise ValueError(f"{name}: no kernel for device {x.device}")
    t_c, nq_tot, nm_tot = c.shape
    t_x, _, e = x.shape
    if max(nq_tot, nm_tot) > _INT_MAX:
        raise ValueError(f"{name}: C {tuple(c.shape)} exceeds the kernel's "
                         "32-bit extents")
    w, _ = slice_params(nm_tot)
    hi = torch.empty((nq_tot, e), dtype=torch.float32, device=x.device)
    lo = torch.empty_like(hi)
    lib = build.library()
    # K14 copies C's rows in 16-byte pieces: they are padded with zeros to
    # a multiple of its k step (nmTot = 343 is 686 bytes), in the call
    step = _k_step()
    k_pad = -(-nm_tot // step) * step
    c = torch.nn.functional.pad(c, (0, k_pad - nm_tot))
    args = (c.data_ptr(), x.data_ptr(), hi.data_ptr(), lo.data_ptr(), t_c,
            t_x, nq_tot, nm_tot, e, w)
    if band_form:
        for u in range(max(t_c, t_x)):
            build.launched(build.call(lib.tbt_ozaki_band, x, *args, u),
                           "ozaki_slices")
    else:
        build.launched(build.call(lib.tbt_ozaki_pair, x, *args),
                       "ozaki_slices")
    return hi, lo


@functools.cache
def _k_step() -> int:
    """K14's k step, to which C's rows are padded (asked of the library
    once)."""
    return build.library().tbt_ozaki_k_pad()


def kron_ozaki(in_slices, c_slices, scale_in, scale_c, *, epb=None):
    """out f64 (nqTot, E) = C @ X for operands split by split_f64 or
    split_f64_np: the slice GEMM, then scale * (hi + lo) in f64."""
    hi, lo = kron_ozaki_pair(in_slices, c_slices)
    return (scale_c * scale_in) * (hi.double() + lo.double())


def kron_coalesced_f64(in_coa, c_coa, *, epb=None, c_split=None):
    """The f64 Coales product through the slices: the element stream
    in_coa (nmTot, E) is split in the call, as it is per-element work; the
    operator's split may be passed (c_split), since every column treats
    the operator as untimed set-up.  `epb` is accepted and ignored."""
    w, t = slice_params(in_coa.shape[0])
    c_slices, scale_c = c_split or split_f64(c_coa, w, t)
    in_slices, scale_in = split_f64(in_coa, w, t)
    return kron_ozaki(in_slices, c_slices, scale_in, scale_c)


def pair_norm(out, scale: float) -> float:
    """L2 norm of scale * (hi + lo), the pair formed in f64 on its device a
    block of rows at a time."""
    hi, lo = out
    rows = max(1, _NORM_CHUNK // max(1, hi.shape[-1]))
    total = 0.0
    for h, l in zip(hi.split(rows), lo.split(rows)):
        total += float(torch.linalg.vector_norm(h.double() + l.double())) ** 2
    return math.sqrt(total) * scale


def coales_pair_variant():
    """The f64 Pallas(Coales) column's timed function under --f64-coales
    ozaki: (in_slices, c_slices) bf16 -> (hi, lo) f32.  Both operands are
    split in prepare (prepare_f64_tier), untimed, as in the JAX package:
    the element stream is a broadcast of one coefficient vector, so its
    split is untimed layout work like every other column's."""
    return kron_ozaki_pair


def coales_pair_spec(data):
    """The f64 Pallas(Coales) spec of benchmarks 04/05 under --f64-coales
    ozaki: coales_pair_variant on the operands of prepare_f64_tier, the
    column normed through its (hi, lo) pair and oz_scale."""
    return ("Pallas(Coales)", coales_pair_variant(),
            ("in_slices", "c_slices"),
            functools.partial(pair_norm, scale=data["oz_scale"]))


def bytes_per_elem(nm_tot: int, nq_tot: int) -> int:
    """Device bytes per element of that column: the bf16 element slices
    and two (hi, lo) f32 pairs (the timed output and the one being
    normed), as the benchmarks count two outputs for the other columns."""
    _, t = slice_params(nm_tot)
    return 2 * t * nm_tot + 2 * 8 * nq_tot


def prepare_f64_tier(data, c_coa, elem, nelmt: int, e_pad: int) -> None:
    """Attach the Ozaki operands of the f64 Pallas(Coales) column to a
    benchmark's Layouts: `c_slices` (T, nqTot, nmTot) bf16 on C's device,
    the lazy `in_slices` (T, nmTot, e_pad) bf16, the element vector's
    slices broadcast over the elements with the padding columns zero, and
    `oz_scale`, the product of the two power-of-two scales.  `elem` is the
    per-element coefficient vector the element stream broadcasts
    (ops/bwdtrans.element_data2d/3d).  The splits run in NumPy f64."""
    nm_tot = c_coa.shape[1]
    w, t = slice_params(nm_tot)
    device = c_coa.device
    c_sl, s_c = split_f64_np(c_coa.double().cpu().numpy(), w, t)
    x_sl, s_x = split_f64_np(elem.double().cpu().numpy(), w, t)
    data["c_slices"] = torch.from_numpy(c_sl).to(device, torch.bfloat16)
    data["oz_scale"] = s_c * s_x
    x_dev = torch.from_numpy(x_sl).to(device, torch.bfloat16)

    def in_slices():
        live = (torch.arange(e_pad, device=device) < nelmt).to(torch.bfloat16)
        return x_dev[:, :, None] * live

    data.add_derived("in_slices", in_slices)
