"""The port's stream kernels (kernels/reduction.py, axpy.py, stream.py,
matvec.py: K6-K9) against the JAX package's Pallas kernels in interpret
mode, in f32, and against its f64 (hi, lo) pair kernels (df2stream), on
numpy-seeded random inputs; the port's initializers, oracle and operand
conversion against the JAX package's.

Tolerances and why:
- sums (K6), f32: 1e-5 relative.  Both sides add up to 65,536 positive
  f32 terms in f32, in other orders; each is within about 16 * 2**-24
  (1e-6) of the exact sum (blocked and pairwise sums).
- x += y (K7): exact.  One rounded add per element on both sides.
- matvec (K8, K9), f32: 1e-5 of the largest output.  Both sides take 512
  or 1024 products per output in f32, in other orders.
- df2 pair kernels against the port's f64: 1e-12 (of the largest output
  where outputs cancel).  The pairs carry about 2**-48 relative
  (tpu_bench/kernels/df2stream.py), f64 2**-53.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bench.kernels import axpy as pl_axpy
from tpu_bench.kernels import df2stream as df2s
from tpu_bench.kernels import matvec as pl_mv
from tpu_bench.kernels import reduction as pl_red
from tpu_bench.kernels import stream as pl_stream
from tpu_bench.ops import initdata as jax_init
from tpu_bench.utils import native as jax_native
from tpu_bench_torch import convert
from tpu_bench_torch.kernels import axpy as k7
from tpu_bench_torch.kernels import matvec as kmv
from tpu_bench_torch.kernels import reduction as k6
from tpu_bench_torch.kernels import stream
from tpu_bench_torch.ops import initdata
from tpu_bench_torch.utils import native

SUMS = [(pl_red.sumsq_two_pass, k6.sumsq_two_pass),
        (pl_red.sumsq_wide, k6.sumsq_wide),
        (pl_red.sumsq_functor, k6.sumsq_functor)]
ADDS = [(pl_axpy.add_inplace, k7.add_inplace),
        (pl_axpy.add_inplace_wide, k7.add_inplace_wide),
        (pl_axpy.map2_inplace, k7.map2_inplace)]


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("eps", [0.0, 0.5])
@pytest.mark.parametrize("n", [8192, 65536])
@pytest.mark.parametrize("jax_fn,port_fn", SUMS,
                         ids=[p.__name__ for _, p in SUMS])
def test_sumsq_matches_jax(jax_fn, port_fn, n, eps):
    x = _rand(n, n)
    ref = float(jax_fn(jnp.asarray(x), eps, interpret=True))
    out = port_fn(torch.from_numpy(x), eps)
    assert out.dim() == 0 and out.dtype == torch.float32
    assert float(out) == pytest.approx(ref, rel=1e-5)


@pytest.mark.parametrize("n", [1024, 8192])
@pytest.mark.parametrize("jax_fn,port_fn", ADDS,
                         ids=[p.__name__ for _, p in ADDS])
def test_add_inplace_matches_jax(jax_fn, port_fn, n):
    x, y = _rand(n, 1), _rand(n, 2)
    ref = np.asarray(jax_fn(jnp.asarray(x), jnp.asarray(y), interpret=True))
    xt = torch.from_numpy(x.copy())
    out = port_fn(xt, torch.from_numpy(y))
    assert out.data_ptr() == xt.data_ptr()  # in place, as the JAX alias
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("n,chunk_bytes", [(128 * 8, 1 << 20),
                                           (128 * 64, 8 * 128 * 4)])
def test_add_inplace_manual_matches_jax(n, chunk_bytes):
    """The TPU ring at a small chunk (several chunks in flight) against
    K7's 16-byte form."""
    x, y = _rand(n, 3), _rand(n, 4)
    ref = np.asarray(pl_stream.add_inplace_manual(
        jnp.asarray(x), jnp.asarray(y), chunk_bytes=chunk_bytes,
        interpret=True))
    out = stream.add_inplace_manual(torch.from_numpy(x.copy()),
                                    torch.from_numpy(y))
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("m,n", [(512, 512), (256, 1024), (1024, 256)])
def test_matvec_matches_jax(m, n):
    a, x = _rand((m, n), m + n), _rand(n, 5)
    a_cm = np.ascontiguousarray(a.T)
    for ref, out in (
            (pl_mv.matvec_vpu(jnp.asarray(a), jnp.asarray(x),
                              interpret=True),
             kmv.matvec_rm(torch.from_numpy(a), torch.from_numpy(x))),
            (pl_mv.matvec_mxu(jnp.asarray(a_cm), jnp.asarray(x),
                              interpret=True),
             kmv.matvec_cm(torch.from_numpy(a_cm), torch.from_numpy(x)))):
        ref = np.asarray(ref)
        assert out.shape == (m,)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def _pair(x64):
    return df2s.split_pair(jnp.asarray(x64))


def _unpair(pair):
    return np.asarray(pair[0], np.float64) + np.asarray(pair[1], np.float64)


@pytest.mark.parametrize("n", [8192, 65536])
@pytest.mark.parametrize("jax_fn,port_fn", [
    (df2s.sumsq_pair_two_pass, k6.sumsq_two_pass),
    (df2s.sumsq_pair_wide, k6.sumsq_wide),
    (df2s.sumsq_pair_one_pass, k6.sumsq_functor)],
    ids=["two_pass", "wide", "one_pass"])
def test_sumsq_pair_matches_port_f64(jax_fn, port_fn, n):
    """At the benchmark's eps = 0: the pair kernels add eps to the f32
    high part alone (hi + eps rounds to f32), so for eps != 0 they are not
    f64 sums."""
    x = _rand(n, 6, np.float64)
    ref = float(np.sum(_unpair(jax_fn(_pair(x), 0.0, interpret=True))))
    out = port_fn(torch.from_numpy(x))
    assert out.dtype == torch.float64
    assert float(out) == pytest.approx(ref, rel=1e-12)


@pytest.mark.parametrize("jax_fn,port_fn", [
    (df2s.add_pair, k7.add_inplace),
    (df2s.add_pair_wide, stream.add_inplace_manual),
    (df2s.map2_pair, k7.map2_inplace)],
    ids=["add_pair", "add_pair_wide", "map2_pair"])
def test_add_pair_matches_port_f64(jax_fn, port_fn):
    x, y = _rand(8192, 7, np.float64), _rand(8192, 8, np.float64)
    ref = _unpair(jax_fn(_pair(x), _pair(y), interpret=True))
    out = port_fn(torch.from_numpy(x.copy()), torch.from_numpy(y)).numpy()
    # relative to the largest sum: x + y cancels where y is near -x
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def test_matvec_pair_matches_port_f64():
    a, x = _rand((256, 512), 9, np.float64), _rand(512, 10, np.float64)
    a_cm = np.ascontiguousarray(a.T)
    for ref, out in (
            (df2s.matvec_pair_rm(_pair(a), _pair(x), interpret=True),
             kmv.matvec_rm(torch.from_numpy(a), torch.from_numpy(x))),
            (df2s.matvec_pair_cm(_pair(a_cm), _pair(x), interpret=True),
             kmv.matvec_cm(torch.from_numpy(a_cm), torch.from_numpy(x)))):
        ref = _unpair(ref)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("n", [1000, 300007])
def test_device_streams_are_the_formula_op_by_op(n):
    """f64: utils/native.py's bytes; f32: NumPy's op-by-op f32 bytes."""
    i = np.arange(n, dtype=np.int64)
    for build, ref64, (p, s, o, q) in (
            (initdata.device_x, native.init_mod13, (13, 1e-5, 0.2, 100191)),
            (initdata.device_y, native.init_mod8, (8, 3e-5, 0.4, 100721))):
        np.testing.assert_array_equal(
            build(n, torch.float64, "cpu").numpy(), ref64(n))
        f32 = np.float32
        ref32 = (i % p).astype(f32) + (
            f32(o) + f32(s) * (i % q).astype(f32))
        np.testing.assert_array_equal(build(n, torch.float32, "cpu").numpy(),
                                      ref32)


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.float64, jnp.float64)])
def test_device_streams_match_jax_to_one_ulp(dtype, jdtype):
    """The JAX package's XLA (f32) and its native library (f64, built
    -march=native) fuse offset + scale*v into one FMA, the port rounds the
    product and the sum apart: the bytes differ by at most one ulp."""
    n = 300007
    for jax_fn, port_fn in ((jax_init.device_x, initdata.device_x),
                            (jax_init.device_y, initdata.device_y)):
        ref = np.asarray(jax_fn(n, jdtype))
        out = port_fn(n, dtype, "cpu").numpy()
        assert out.dtype == ref.dtype
        assert np.all(np.abs(out - ref) <= np.spacing(np.abs(ref)))
    np.testing.assert_allclose(native.init_mod13(n),
                               jax_native.init_mod13(n), rtol=2**-52)
    np.testing.assert_allclose(native.init_mod8(n),
                               jax_native.init_mod8(n), rtol=2**-52)


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.float64, jnp.float64)])
def test_b03_operands_match_jax(dtype, jdtype):
    a = initdata.host_matrix_sin1((96, 160), dtype, "cpu")
    np.testing.assert_array_equal(
        a.numpy(), np.asarray(jax_init.host_matrix_sin1((96, 160), jdtype)))
    np.testing.assert_array_equal(
        initdata.host_x_linear(160, dtype, "cpu").numpy(),
        np.asarray(jax_init.host_x_linear(160, jdtype)))
    x = np.linspace(-1.0, 1.0, 160)
    ref = jax_native.matvec_ref(a.numpy(), x)
    np.testing.assert_allclose(native.matvec_ref(a.numpy(), x), ref,
                               rtol=0, atol=1e-13 * np.abs(ref).max())


def test_convert_carries_stream_operands():
    arrays = {"x": np.asarray(jax_init.device_x(1000, jnp.float64)),
              "y": np.asarray(jax_init.device_y(1000, jnp.float64)),
              "a_rm": np.asarray(jax_init.host_matrix_sin1((8, 16),
                                                          jnp.float64))}
    arrays["a_cm"] = np.ascontiguousarray(arrays["a_rm"].T)
    assert set(arrays) == set(convert.B01_KEYS + convert.B02_KEYS
                              + convert.B03_KEYS)
    t = convert.data_from_numpy(arrays, device="cpu", dtype=torch.float64)
    for k, a in arrays.items():
        assert t[k].is_contiguous() and np.array_equal(t[k].numpy(), a), k
    with pytest.raises(KeyError, match="no port layout"):
        convert.data_from_numpy({"z": arrays["x"]}, device="cpu",
                                dtype=torch.float64)


def test_wrappers_reject_bad_input():
    x = torch.zeros(64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        k6.sumsq_wide(x.bfloat16())
    with pytest.raises(ValueError, match="no kernel for device"):
        k6.sumsq_two_pass(x.to("meta"))
    with pytest.raises(ValueError, match="differ in shape"):
        k7.add_inplace(x, torch.zeros(32))
    with pytest.raises(TypeError, match="one dtype"):
        stream.add_inplace_manual(x, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        k7.map2_inplace(torch.zeros(8, 8).t(), torch.zeros(8, 8))
    with pytest.raises(ValueError, match="do not multiply"):
        kmv.matvec_rm(torch.zeros(4, 8), torch.zeros(4))
    with pytest.raises(ValueError, match="do not multiply"):
        kmv.matvec_cm(torch.zeros(4, 8), torch.zeros(8))


# ---- K9's row shares (kernels/matvec.cm_splits, cm_rows) -------------------

@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n,m", [(1000, 777), (4096, 16384), (16384, 4096),
                                 (16384, 16384), (7, 3), (65, 128)])
@pytest.mark.parametrize("blocks", [528, 1056, 132])
def test_cm_splits_cover_every_row_once_in_one_wave(n, m, itemsize, blocks):
    """Every row of A_cm falls in exactly one share, the shares differ by
    at most one row, and the column blocks times the shares fit the
    blocks the card holds at once (one wave) wherever the column blocks
    alone do."""
    splits = kmv.cm_splits(n, m, itemsize, blocks)
    bounds = kmv.cm_rows(n, splits)
    covered = np.zeros(n, int)
    for start, end in bounds:
        covered[start:end] += 1
    assert (covered == 1).all()
    sizes = [end - start for start, end in bounds]
    assert max(sizes) - min(sizes) <= 1
    col_blocks = -(-m // kmv.cm_columns(itemsize))
    assert splits == 1 or col_blocks * splits <= blocks
    assert splits == 1 or min(sizes) >= kmv.CM_WARPS * kmv.CM_UNROLL


def test_matvec_cm_rejects_bad_knobs():
    a_cm, x = torch.zeros(8, 4), torch.zeros(8)
    with pytest.raises(ValueError, match="unroll=5"):
        kmv.matvec_cm(a_cm, x, unroll=5)
    with pytest.raises(ValueError, match="splits=0"):
        kmv.matvec_cm(a_cm, x, splits=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_matvec_cm_on_card(dtype):
    """K9 against its plain version at the smoke's shapes (1000, 777) ..
    16384^2 (A's (m, n); scalar loads where m * itemsize is not a multiple
    of 16, and on an A_cm one element off a 16-byte boundary), at every
    rows-in-flight setting; two calls give the same bits; on all-ones
    operands every column sums to N exactly whatever the shares (each row
    counted once); 1e-5 (f32), 1e-12 (f64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    tol = 1e-5 if dt == torch.float32 else 1e-12
    gen = torch.Generator(device="cuda").manual_seed(3)
    for m, n, off in ((1000, 777, 0), (777, 1000, 0), (1000, 777, 1),
                      (4096, 16384, 0), (16384, 4096, 0),
                      (16384, 16384, 0)):
        a_cm = torch.randn(n * m + off, generator=gen, device="cuda",
                           dtype=dt)[off:].view(n, m)
        x = torch.randn(n, generator=gen, device="cuda", dtype=dt)
        ref = kmv.matvec_cm_plain(a_cm, x)
        for unroll in kmv.CM_UNROLLS:
            out = kmv.matvec_cm(a_cm, x, unroll=unroll)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max() / ref.abs().max())
            assert err <= tol, (m, n, unroll, err)
        assert torch.equal(kmv.matvec_cm(a_cm, x), kmv.matvec_cm(a_cm, x))
        ones, xo = torch.ones_like(a_cm), torch.ones_like(x)
        for splits in (None, 1, 3, 7):
            y = kmv.matvec_cm(ones, xo, splits=splits)
            assert torch.equal(y, torch.full_like(y, n)), (m, n, splits)


# ---- K8's row groups (kernels/matvec.rm_lanes, rm_grid, rm_groups) ---------

MATVEC_SHAPES = [(1000, 777), (777, 1000), (4096, 16384), (16384, 4096),
                 (16384, 16384)]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("rows", [2, 4])
@pytest.mark.parametrize("m,n", MATVEC_SHAPES)
def test_rm_groups_cover_every_row_once_in_one_wave(m, n, rows, itemsize):
    """At every unroll, in the vector form where the rows are whole
    16-byte vectors and in the scalar form, and at 1, 3 and 8 blocks an
    SM of 132: every row of A falls to exactly one team, the teams' row
    groups differ in number by at most one (so their rows by at most
    `rows`), and the grid is one wave."""
    assert rows in kmv.RM_ROWS
    forms = [n] + ([n * itemsize // 16] if n * itemsize % 16 == 0 else [])
    for units in forms:
        for unroll in kmv.RM_UNROLLS:
            lanes = kmv.rm_lanes(units, unroll)
            for wave in (132, 396, 1056):
                blocks = kmv.rm_grid(m, rows, lanes, wave)
                teams = kmv.rm_groups(m, rows, lanes, blocks)
                assert 1 <= blocks <= wave
                assert len(teams) == blocks * kmv.RM_THREADS // lanes
                assert sorted(r for t in teams for r in t) == list(range(m))
                counts = [-(-len(t) // rows) for t in teams]
                assert max(counts) - min(counts) <= 1
                sizes = [len(t) for t in teams]
                assert max(sizes) - min(sizes) <= rows


@pytest.mark.parametrize("units,unroll,lanes", [
    (4096, 2, 256), (1024, 2, 256), (511, 2, 128), (250, 2, 64),
    (777, 1, 256), (32, 2, 16), (31, 2, 8), (1, 1, 8), (20, 1, 16),
    (8192, 4, 256)])
def test_rm_lanes_fit_the_team_to_the_row(units, unroll, lanes):
    """The largest power of two from 8 to a block's 256 lanes that leaves
    each lane at least `unroll` units of a row."""
    assert kmv.rm_lanes(units, unroll) == lanes


def test_rm_grid_balances_rounds_within_one_wave():
    """16384 rows in groups of 2, a team a block, on 792 blocks a wave:
    11 rounds, so 745 blocks, each team 10 or 11 row groups."""
    assert kmv.rm_grid(16384, 2, 256, 792) == 745
    assert kmv.rm_grid(1000, 2, 256, 792) == 500
    assert kmv.rm_grid(1000, 2, 16, 792) == 32


@pytest.mark.parametrize("kwargs,error", [
    (dict(rows=3), "rows=3"), (dict(unroll=3), "unroll=3"),
    (dict(rows=1), "rows=1"), (dict(unroll=8), "unroll=8")])
def test_matvec_rm_rejects_bad_knobs(kwargs, error):
    a, x = torch.zeros(4, 8), torch.zeros(8)
    with pytest.raises(ValueError, match=error):
        kmv.matvec_rm(a, x, **kwargs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_matvec_rm_on_card(dtype):
    """K8 against its plain version at (1000, 777) .. 16384^2, (1001,
    1001) and (4096, 4096), at every (rows, unroll), also on an x one
    element off a 16-byte boundary (the scalar form); two calls at each
    setting give the same bits; 1e-5 (f32), 1e-12 (f64), relative to the
    largest output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    tol = 1e-5 if dt == torch.float32 else 1e-12
    gen = torch.Generator(device="cuda").manual_seed(4)
    for m, n in MATVEC_SHAPES + [(1001, 1001), (4096, 4096)]:
        a = torch.randn(m, n, generator=gen, device="cuda", dtype=dt)
        x = torch.randn(n + 1, generator=gen, device="cuda", dtype=dt)
        for xv in (x[:n], x[1:]):
            ref = kmv.matvec_rm_plain(a, xv)
            for rows in kmv.RM_ROWS:
                for unroll in kmv.RM_UNROLLS:
                    out = kmv.matvec_rm(a, xv, rows=rows, unroll=unroll)
                    torch.cuda.synchronize()
                    err = float((out - ref).abs().max() / ref.abs().max())
                    assert err <= tol, (m, n, rows, unroll, err)
                    assert torch.equal(out, kmv.matvec_rm(
                        a, xv, rows=rows, unroll=unroll)), (m, n, rows,
                                                            unroll)
            assert torch.equal(kmv.matvec_rm(a, xv), kmv.matvec_rm(a, xv))
