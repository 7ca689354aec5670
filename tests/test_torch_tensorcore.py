"""The arithmetic the port's tensor-core kernels rely on, checked on the CPU
against the JAX package's kernels in interpret mode.

K14 (csrc/ozaki.cu) sums bf16 slice products on the tensor cores in 16-deep
k steps, in whatever order and alignment the hardware's f32 accumulator
applies.  That gives the plain version's bits only if every band sum is an
integer below 2^24: checked here on worst-case slices (every value +-2^w)
at the deepest contraction of each benchmark's sweep, summed in 16-deep
chunks in several orders.

K5 (csrc/qp1d_fused3d.cu) runs its f32 chain as 3xTF32: each operand a
split into big, a rounded to TF32 to nearest with ties away from zero, and
small = a - big, which the tensor cores truncate to TF32, and small*big +
big*small + big*big accumulated in f32.  Emulated here on the port's own
stage operators, it stays within K5's tolerance of the f64 chain and of the
JAX kernel at precision HIGHEST, and a single TF32 pass does not.  K2's
dense configuration (csrc/bwdtrans2d.cu) runs the same 3xTF32 arithmetic
in 32-deep partial sums, on wgmma in f32, as K3's does on mma.sync:
emulated at the depths they run, they stay within 1e-5 of the f64
product too.  K1's f32 stage 2 on wgmma (csrc/qp_fused3d.cuh) sums its
3xTF32 products in one accumulator, every small product first: emulated
at the shapes it runs, it stays within 1e-6 of the f64 product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bench.kernels import bwdtrans2d as pl_bt2
from tpu_bench.kernels import bwdtrans3d as pl_bt3
from tpu_bench.kernels import ozaki as jax_ozaki
from tpu_bench_torch.kernels import bwdtrans2d as k2
from tpu_bench_torch.kernels import bwdtrans3d as k1
from tpu_bench_torch.kernels import ozaki
from tpu_bench_torch.ops import bwdtrans

# The deepest contraction of each sweep: benchmark05 at nq=10^3
# (scripts/run05.sh), benchmark04 at nq=32^2 (scripts/run04.sh).
DEEPEST_K = [9 ** 3, 31 ** 2]
K_STEP = 16  # K14's mma depth
K5_PART = 32  # the depth of K5's f32 partial sums (its k step)
# K5's tolerance against its plain version, relative to the largest output
K5_RTOL = 1e-5


def _worst_slices(k, signs, rng, rows, cols, t):
    """t slices (t, rows, cols) of K14's widest values, +-2^w, in f32."""
    w, _ = ozaki.slice_params(k)
    if signs == "positive":
        sign = np.ones((t, rows, cols))
    else:
        sign = rng.choice([-1.0, 1.0], size=(t, rows, cols))
    return (sign * 2.0 ** w).astype(np.float32)


def _fold(bands, w):
    """The plain version's fold of f32 band sums (band 0 first) into an
    f32 (hi, lo) pair by two-sum."""
    hi = lo = None
    for u, band in enumerate(bands):
        v = band * np.float32(2.0 ** (-w * (u + 2)))
        if hi is None:
            hi, lo = v, np.zeros_like(v)
            continue
        s = hi + v
        bb = s - hi
        lo = lo + ((hi - (s - bb)) + (v - bb))
        hi = s
    return hi, lo


@pytest.mark.parametrize("signs", ["positive", "mixed"])
@pytest.mark.parametrize("k", DEEPEST_K)
def test_worst_case_band_sums_are_exact_in_any_k_step_order(k, signs):
    """Every value +-2^w at the deepest k: each band sum stays below 2^24,
    the band summed in 16-deep k chunks in f32, in forward, reverse and
    shuffled chunk order, equals the exact integer sum, and the fold of
    those sums equals kron_ozaki_pair_plain and the JAX kernel bit for
    bit."""
    w, t = ozaki.slice_params(k)
    rng = np.random.default_rng(k)
    m, n = 16, 128
    c = _worst_slices(k, signs, rng, m, k, t)   # (T, nqTot, K)
    x = _worst_slices(k, signs, rng, k, n, t)   # (T, K, E)
    chunks = [slice(i, i + K_STEP) for i in range(0, k, K_STEP)]
    shuffled = [chunks[i] for i in rng.permutation(len(chunks))]
    folds = []
    for order in (chunks, chunks[::-1], shuffled):
        bands = []
        for u, ss in ozaki.bands(t, t):
            exact = sum(c[s].astype(np.int64) @ x[u - s].astype(np.int64)
                        for s in ss)
            bound = sum(np.abs(c[s]).astype(np.int64)
                        @ np.abs(x[u - s]).astype(np.int64) for s in ss)
            assert bound.max() < 2 ** 24
            acc = np.zeros((m, n), np.float32)
            for s in ss:
                for ch in order:
                    acc += c[s][:, ch] @ x[u - s][ch, :]
            np.testing.assert_array_equal(acc, exact.astype(np.float32))
            assert np.array_equal(acc.astype(np.int64), exact)
            bands.append(acc)
        folds.append(_fold(bands, w))
    hi, lo = ozaki.kron_ozaki_pair_plain(torch.from_numpy(x).bfloat16(),
                                         torch.from_numpy(c).bfloat16())
    jhi, jlo = jax_ozaki.kron_ozaki_pair(
        jnp.asarray(x).astype(jnp.bfloat16),
        jnp.asarray(c).astype(jnp.bfloat16), epb=128, interpret=True)
    for got_hi, got_lo in (*folds, (np.asarray(jhi), np.asarray(jlo))):
        np.testing.assert_array_equal(got_hi, hi.numpy())
        np.testing.assert_array_equal(got_lo, lo.numpy())


def tf32_rna(a):
    """a (f32) rounded to TF32, 10 stored mantissa bits, to nearest with
    ties away from zero (cvt.rna.tf32.f32): half of the dropped 13 bits'
    range is added to the magnitude and the 13 bits cleared."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    mag = ((u & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)) \
        & np.uint32(0xFFFFE000)
    return ((u & np.uint32(0x80000000)) | mag).view(np.float32)


def tf32_rz(a):
    """a (f32) truncated to TF32: what the tensor cores read of an f32
    operand whose low 13 bits are not clear."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a):
    """K5's split: big rounded to TF32, small = a - big (exact) as the
    tensor cores read it."""
    big = tf32_rna(a)
    return big, tf32_rz(a - big)


def matmul_3xtf32(a, b):
    """a @ b as K5's f32 entries compute it: small*big + big*small +
    big*big, products of TF32 values (exact in f32), sums in f32."""
    (ab, asm), (bb, bs) = _split(a), _split(b)
    out = asm @ bb
    out += ab @ bs
    out += ab @ bb
    return out


def matmul_1xtf32(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)   # TF32's spacing at 1
    half = np.float32(2.0 ** -11)
    below = np.float32(2.0 ** -12)
    cases = np.array([one + half, -(one + half), one + below,
                      one + half + np.float32(2.0 ** -20), one + ulp,
                      np.float32(3.0)], np.float32)
    want = np.array([one + ulp, -(one + ulp), one, one + ulp, one + ulp,
                     3.0], np.float32)
    np.testing.assert_array_equal(tf32_rna(cases), want)
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    big, small = _split(x)
    assert not np.any(big.view(np.uint32) & np.uint32(0x1FFF))
    assert not np.any(small.view(np.uint32) & np.uint32(0x1FFF))
    # two TF32 pieces hold 22 of f32's 24 bits
    assert np.abs(big + small - x).max() <= 2.0 ** -21 * np.abs(x).max()


def _chain_operators(nq):
    """The port's stage operators of benchmark05 (three) or benchmark04
    (two) at order nq, f32."""
    if len(nq) == 3:
        basis = bwdtrans.make_basis3d(*nq, torch.float32, "cpu")
        ops = bwdtrans.operators3d(basis)[2:]
    else:
        basis = bwdtrans.make_basis2d(*nq, torch.float32, "cpu")
        ops = bwdtrans.operators2d(basis)[1:]
    return [o.numpy() for o in ops]


def _rel(out, ref):
    return float(np.abs(out - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("nq", [(4, 4, 4), (8, 8, 8), (10, 10, 10), (8, 8),
                                (16, 16), (32, 32)])
def test_3xtf32_chain_within_k5_tolerance(nq):
    """At benchmark05's 4^3, 8^3, 10^3 and benchmark04's 8^2, 16^2, 32^2,
    the 3xTF32 stage-order chain is within K5's 1e-5 of the f64 chain and
    of the JAX kernel (precision HIGHEST, interpret mode), and of the
    port's plain version; one TF32 pass is not."""
    ops = _chain_operators(nq)
    e = 64
    x = np.random.default_rng(sum(nq)).standard_normal(
        (e, ops[0].shape[0])).astype(np.float32)
    ref = x.astype(np.float64)
    tc3 = tc1 = x
    for s in ops:
        ref = ref @ s.astype(np.float64)
        tc3 = matmul_3xtf32(tc3, s)
        tc1 = matmul_1xtf32(tc1, s)
    fn = pl_bt3.qp1d_shared3d if len(nq) == 3 else pl_bt2.qp1d_shared
    jax_out = np.asarray(fn(jnp.asarray(x), *map(jnp.asarray, ops), epb=e,
                            interpret=True,
                            precision=jax.lax.Precision.HIGHEST))
    plain = k1.qp1d_fused(torch.from_numpy(x),
                          *map(torch.from_numpy, ops)).numpy()
    assert _rel(tc3, ref) <= K5_RTOL
    assert _rel(tc3, jax_out) <= K5_RTOL
    assert _rel(tc3, plain) <= K5_RTOL
    assert _rel(tc1, ref) > K5_RTOL


def _round_toward_zero(x64):
    """f64 values rounded to f32 toward zero, as the tensor cores' f32
    accumulation truncates."""
    f = x64.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x64)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def matmul_3xtf32_truncating(a, b, part_depth):
    """matmul_3xtf32 with each m16n8k8 mma emulated: its eight exact
    products and the accumulator summed, then truncated to f32.
    part_depth None: one accumulator over the whole depth; else sums of
    part_depth-deep slices of k, each started from zero and added to the
    result in f32 round-to-nearest (K5's design)."""
    (ab, asm), (bb, bs) = _split(a), _split(b)
    k = a.shape[1]
    step = part_depth or k
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, k, step):
        part = np.zeros_like(out)
        for k8 in range(k0, min(k0 + step, k), 8):
            ks = slice(k8, min(k8 + 8, k))
            for x, y in ((asm, bb), (ab, bs), (ab, bb)):
                part = _round_toward_zero(
                    part.astype(np.float64)
                    + x[:, ks].astype(np.float64) @ y[ks].astype(np.float64))
        out = out + part if part_depth else part
    return out


def test_truncating_accumulation_needs_k5s_partial_sums():
    """Why K5 sums each 32-deep slice of k alone: on random dense
    operators at nq=10^3, the 3xTF32 chain with one truncating
    accumulator over the whole depth misses 1e-5 of the f64 chain, and
    with 32-deep partial sums added in round-to-nearest it holds it
    with a margin."""
    rng = np.random.default_rng(10)
    widths = [9 ** 3, 9 * 9 * 10, 9 * 10 * 10, 10 ** 3]
    x = rng.standard_normal((16, widths[0])).astype(np.float32)
    ops = [rng.standard_normal(s).astype(np.float32)
           for s in zip(widths, widths[1:])]
    ref, whole, parts = x.astype(np.float64), x, x
    for s in ops:
        ref = ref @ s.astype(np.float64)
        whole = matmul_3xtf32_truncating(whole, s, None)
        parts = matmul_3xtf32_truncating(parts, s, K5_PART)
    assert _rel(whole, ref) > K5_RTOL
    assert _rel(parts, ref) <= K5_RTOL / 4


@pytest.mark.parametrize("size", [4, 8])
def test_qp1d_tiles_are_whole_mma_tiles(size):
    """K5's element tiles per element size, largest first: whole multiples
    of the mma tile's M side (16 rows in TF32, 8 in f64) that split the
    block's 8 warps evenly."""
    tiles = k1.QP1D_TILES[size]
    mma_m = 16 if size == 4 else 8
    assert list(tiles) == sorted(tiles, reverse=True)
    for et in tiles:
        assert et % mma_m == 0 and 8 % (et // mma_m) == 0


# K2's dense configuration (csrc/bwdtrans2d.cu) sums 3xTF32 products over
# k steps, each step alone, added in round-to-nearest: its f32 body on
# wgmma a ring stage deep (WGMMA_F32.bk); K3's dense configuration, on the
# mma.sync body, 32 deep (its BK in f32).
K2_PART = k2.WGMMA_F32.bk
K3_PART = 32


@pytest.mark.parametrize("label,m,k", [
    ("b05 nq=8^3", 512, 343), ("b04 nq=16^2", 256, 225),
    ("b04 nq=32^2", 1024, 961),
    ("K3 b05 nq=8^3 QP-1D stage 2", 448, 392),
    ("K3 b05 nq=8^3 QP-1D stage 3", 512, 448),
    ("K3 b04 nq=32^2 QP-1D stage 2", 1024, 992)])
def test_k2_3xtf32_within_1e5_at_its_depths(label, m, k):
    """The dense f32 product that K2 and K3 share, C (M x K) @ X (K x E),
    at the depths it runs (K2: b05 nq=8^3 K = 343; b04 nq=16^2 225, nq=32^2
    961; K3, X @ S with S's N columns as M: 392 and 448 at b05 nq=8^3, 992
    at b04 nq=32^2), in the partial sums of each (K2_PART, K3_PART),
    emulated with the tensor cores' truncating f32 sums:
    within 1e-5 of the f64 product, relative to its largest output, on
    random dense operands (a slice of C's rows: the error of an output
    depends on its own row only)."""
    rng = np.random.default_rng(k)
    c = rng.standard_normal((min(m, 64), k)).astype(np.float32)
    x = rng.standard_normal((k, 32)).astype(np.float32)
    ref = c.astype(np.float64) @ x.astype(np.float64)
    part = K3_PART if label.startswith("K3") else K2_PART
    out = matmul_3xtf32_truncating(c, x, part)
    assert _rel(out, ref) <= K5_RTOL
    assert _rel(matmul_1xtf32(c, x), ref) > K5_RTOL


# K1's f32 stage 2 on wgmma (csrc/qp_fused3d.cuh qp_stage2_tf32): C12T (nkj
# x nrq, held in registers) @ V (nrq x the plane group's 128 columns), k
# padded to whole 8-deep steps with zeros, 3xTF32 with the units'
# truncating f32 sums in one accumulator: the two small products of every
# k step first, then the big ones.
K1_TF32_RTOL = 1e-6


def k1_tf32_body(c12t, v, small_first=True):
    """C12T @ V as K1's TF32 body sums it: each wgmma k8 product's eight
    exact products added to the accumulator and truncated to f32; k steps
    of 8 over nrq padded with zeros to whole steps; small*big and
    big*small of every step, then big*big of every step (small_first),
    or K2's order, a step's three products together."""
    k = -(-c12t.shape[1] // 8) * 8
    a = np.zeros((c12t.shape[0], k), np.float32)
    b = np.zeros((k, v.shape[1]), np.float32)
    a[:, :c12t.shape[1]], b[:v.shape[0]] = c12t, v
    (ab, asm), (bb, bs) = _split(a), _split(b)
    steps = [slice(k8, k8 + 8) for k8 in range(0, k, 8)]
    if small_first:
        order = [(x, y, s) for s in steps for x, y in ((asm, bb), (ab, bs))]
        order += [(ab, bb, s) for s in steps]
    else:
        order = [(x, y, s) for s in steps
                 for x, y in ((asm, bb), (ab, bs), (ab, bb))]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for x, y, s in order:
        acc = _round_toward_zero(acc.astype(np.float64)
                                 + x[:, s].astype(np.float64)
                                 @ y[s].astype(np.float64))
    return acc


# (nkj, nrq) of K1's 64 x 56 @ 56 x 128 at b05 nq=8^3 and of every shape
# QP_MEASURED gives the TF32 body
K1_TF32_SHAPES = sorted({(64, 49)} | {
    (key[4], key[2]) for key, cfg in k1.QP_MEASURED.items()
    if cfg.body == "tf32"})


@pytest.mark.parametrize("nkj,nrq", K1_TF32_SHAPES)
def test_k1_tf32_body_within_1e6_of_f64(nkj, nrq):
    """K1's TF32 body on random dense C12T and V (the plane group's 128
    columns) stays within 1e-6 of the f64 product, relative to its largest
    output, at each shape it runs; one TF32 pass does not."""
    assert nkj <= k1.QP_TF32_M and nrq <= k1.QP_TF32_K * k1.QP_TF32_STEPS
    rng = np.random.default_rng(nkj * 100 + nrq)
    c12t = rng.standard_normal((nkj, nrq)).astype(np.float32)
    v = rng.standard_normal((nrq, k1.QP_TF32_COLUMNS)).astype(np.float32)
    ref = c12t.astype(np.float64) @ v.astype(np.float64)
    assert _rel(k1_tf32_body(c12t, v), ref) <= K1_TF32_RTOL
    assert _rel(matmul_1xtf32(c12t, v), ref) > K1_TF32_RTOL


def test_k1_tf32_body_adds_small_products_first():
    """Why the body issues every small product before the big ones: at b05
    nq=8^3 (seven k steps) K2's order, a step's three products together,
    truncates the full running sum three times a step and lands more than
    twice as far from f64 as the small-first order, which truncates it
    once a step."""
    rng = np.random.default_rng(8)
    c12t = rng.standard_normal((64, 49)).astype(np.float32)
    v = rng.standard_normal((49, k1.QP_TF32_COLUMNS)).astype(np.float32)
    ref = c12t.astype(np.float64) @ v.astype(np.float64)
    first = _rel(k1_tf32_body(c12t, v), ref)
    together = _rel(k1_tf32_body(c12t, v, small_first=False), ref)
    assert first < together / 2
