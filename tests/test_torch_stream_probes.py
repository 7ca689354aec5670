"""The port's ceiling probes (kernels/stream.py: K10-K13's copy, scale,
triad, fill, fill_manual, expand and read) against the JAX package's
Pallas probes in interpret mode, on numpy-seeded inputs, in f32 and f64,
at the shapes of tests/test_stream.py: one chunk, more chunks than the
ring's depth, and exactly depth chunks.

Tolerances and why:
- copy, fill, expand and read's token: exact.  Each output element is an
  input element, the seed, or one rounded add of the bias on both sides.
- scale and triad: rtol 1e-6 (f32) and 1e-15 (f64).  Each side rounds once
  per operation, and the triad's multiply and add may fuse into one FMA on
  one side and not the other.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bench.kernels import stream as pl_stream
from tpu_bench_torch.kernels import stream

DTYPES = [(np.float32, 1e-6), (np.float64, 1e-15)]
# (n, chunk rows): one chunk (the chunk capped at the rows), 8 chunks >
# depth 3, and 3 chunks == depth (tests/test_stream.py)
SHAPES = [(128 * 8, None), (128 * 64, 8), (128 * 24, 8)]


def _rand(shape, seed, dtype):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _chunk_bytes(rows, dtype):
    return 1 << 20 if rows is None else rows * 128 * np.dtype(dtype).itemsize


def _scalar(value, dtype):
    return np.full((1, 1), value, dtype)


@pytest.mark.parametrize("dtype,rtol", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("n,rows", SHAPES)
def test_copy_manual_matches_jax(n, rows, dtype, rtol):
    x = _rand(n, n, dtype)
    ref = np.asarray(pl_stream.copy_manual(
        jnp.asarray(x), chunk_bytes=_chunk_bytes(rows, dtype),
        interpret=True))
    xt = torch.from_numpy(x)
    out = stream.copy_manual(xt)
    assert out.data_ptr() != xt.data_ptr() and out.shape == (n,)
    np.testing.assert_array_equal(out.numpy(), ref)
    into = torch.empty_like(xt)
    assert stream.copy_manual(xt, out=into) is into
    np.testing.assert_array_equal(into.numpy(), ref)


@pytest.mark.parametrize("dtype,rtol", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("n,rows", SHAPES)
def test_scale_manual_matches_jax(n, rows, dtype, rtol):
    x, c = _rand(n, n + 1, dtype), _scalar(1.0000001, dtype)
    ref = np.asarray(pl_stream.scale_manual(
        jnp.asarray(x), jnp.asarray(c),
        chunk_bytes=_chunk_bytes(rows, dtype), interpret=True))
    xt = torch.from_numpy(x.copy())
    out = stream.scale_manual(xt, torch.from_numpy(c))
    assert out.data_ptr() == xt.data_ptr()  # in place, as the JAX alias
    np.testing.assert_allclose(out.numpy(), ref, rtol=rtol, atol=0)


@pytest.mark.parametrize("dtype,rtol", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("n,rows", SHAPES)
def test_triad_manual_matches_jax(n, rows, dtype, rtol):
    x, y = _rand(n, n + 2, dtype), _rand(n, n + 3, dtype)
    c = _scalar(3.0, dtype)
    ref = np.asarray(pl_stream.triad_manual(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(c),
        chunk_bytes=_chunk_bytes(rows, dtype), interpret=True))
    xt = torch.from_numpy(x.copy())
    out = stream.triad_manual(xt, torch.from_numpy(y), torch.from_numpy(c))
    assert out.data_ptr() == xt.data_ptr()
    # relative to the largest output: x + 3y cancels where y is near -x/3
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", ["fill", "fill_manual"])
def test_fill_matches_jax(name, dtype):
    seed = _scalar(-2.75, dtype)
    jdtype = jnp.dtype(dtype)
    kwargs = ({"chunk_bytes": 8 * 128 * np.dtype(dtype).itemsize}
              if name == "fill_manual" else {})
    ref = np.asarray(getattr(pl_stream, name)(
        64, jnp.asarray(seed), dtype=jdtype, interpret=True, **kwargs))
    tdtype = torch.from_numpy(seed).dtype
    out = getattr(stream, name)(64, torch.from_numpy(seed), dtype=tdtype)
    assert out.shape == ref.shape == (64, 128) and out.dtype == tdtype
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("n,rows", SHAPES)
def test_expand_manual_matches_jax(n, rows, dtype, m, with_bias):
    """Output chunk j*m + t is input chunk j + bias: not m contiguous
    copies of x once x has more than one chunk."""
    x = _rand(n, n + 4, dtype)
    cb = _chunk_bytes(rows, dtype)
    bias = _scalar(0.625, dtype) if with_bias else None
    ref = np.asarray(pl_stream.expand_manual(
        jnp.asarray(x), m, None if bias is None else jnp.asarray(bias),
        chunk_bytes=cb, interpret=True))
    out = stream.expand_manual(
        torch.from_numpy(x), m, None if bias is None else
        torch.from_numpy(bias), chunk_bytes=cb)
    assert out.shape == ref.shape == (m * n // 128, 128)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("n,rows", SHAPES)
def test_read_manual_token_matches_jax(n, rows, dtype, with_bias):
    """The token: the first 8 rows of the last chunk the ring cycled into
    slot 0, + bias."""
    x = _rand(n, n + 5, dtype)
    cb = _chunk_bytes(rows, dtype)
    bias = _scalar(2.5, dtype) if with_bias else None
    ref = np.asarray(pl_stream.read_manual(
        jnp.asarray(x), None if bias is None else jnp.asarray(bias),
        chunk_bytes=cb, interpret=True))
    out = stream.read_manual(
        torch.from_numpy(x), None if bias is None else
        torch.from_numpy(bias), chunk_bytes=cb)
    assert out.shape == ref.shape == (8, 128)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_read_manual_token_rows():
    """At 8 chunks of 8 rows and depth 3, slot 0 last holds chunk 6: the
    token is rows 48..55."""
    x = torch.arange(128 * 64, dtype=torch.float64)
    tok = stream.read_manual(x, chunk_bytes=8 * 128 * 8)
    assert torch.equal(tok, x.view(64, 128)[48:56])
    tok = stream.read_manual(x, chunk_bytes=8 * 128 * 8, depth=8)
    assert torch.equal(tok, x.view(64, 128)[:8])


def test_probes_reject_bad_input():
    x = torch.zeros(256)
    c = torch.ones((1, 1))
    with pytest.raises(ValueError, match="multiple of 128"):
        stream.scale_manual(torch.zeros(100), c)
    with pytest.raises(ValueError, match="scalar operand"):
        stream.scale_manual(x, torch.ones(2))
    with pytest.raises(TypeError, match="one dtype"):
        stream.triad_manual(x, x.clone(), c.double())
    with pytest.raises(ValueError, match="differ in shape"):
        stream.triad_manual(x, torch.zeros(128), c)
    with pytest.raises(ValueError, match="differ in shape"):
        stream.copy_manual(x, out=torch.zeros(128))
    with pytest.raises(TypeError, match="one dtype"):
        stream.fill(8, c, dtype=torch.float64)
    with pytest.raises(ValueError, match="copies"):
        stream.expand_manual(x, 0)
    # 12 rows: chunks of 4 rows cannot hold the 8-row token
    with pytest.raises(ValueError, match="token"):
        stream.read_manual(torch.zeros(128 * 12))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        stream.read_manual(torch.zeros(128 * 8).bfloat16())
