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


# ---- the cp.async.bulk ring of K12 and K7's 16-byte form (kernels/ring.py)

# (n, itemsize, address offset in bytes, chunk, wave): the main sizes (K12
# at the ceilings' 134,217,728 f32 elements, K7 at benchmark02's
# 536,870,912), n = 1000 and 1,048,579, several placements against 16
# bytes, one partial chunk, and a wave smaller and larger than the chunks
RING_PLANS = [
    (134217728, 4, 0, 16384, 396), (134217728, 8, 8, 8192, 264),
    (536870912, 4, 0, 8192, 132), (536870912, 8, 0, 16384, 264),
    (1000, 4, 0, 4096, 396), (1000, 4, 4, 4096, 396), (1000, 8, 8, 512, 3),
    (1048579, 4, 4, 16384, 396), (1048579, 4, 8, 8192, 7),
    (1048579, 4, 12, 32768, 132), (1048579, 8, 8, 4096, 264),
    (3, 4, 4, 16, 10), (4, 4, 0, 16, 10), (7, 8, 0, 32, 1), (0, 4, 0, 16, 4),
]


@pytest.mark.parametrize("n,itemsize,offset,chunk,wave", RING_PLANS)
def test_ring_plan_covers_every_vector_once(n, itemsize, offset, chunk,
                                            wave):
    """The ring's plan (the arithmetic csrc/ring.cuh mirrors): every
    element in the head, the middle's whole 16-byte vectors or the tail,
    the middle in chunks of whole vectors with only the last one partial,
    and one wave of no more blocks than chunks.  That the counter hands
    each chunk to one block is held on the card, by
    test_ring_matches_plain_on_card."""
    from tpu_bench_torch.kernels import ring

    address = 4096 + offset
    plan = ring.ring_plan(n, itemsize, address, chunk, wave)
    assert (address + plan.head * itemsize) % 16 == 0 or plan.nbytes == 0
    assert 0 <= plan.head < 16 // itemsize or plan.head == n
    assert 0 <= plan.tail < 16 // itemsize
    assert plan.head + plan.nbytes // itemsize + plan.tail == n
    assert plan.nbytes % 16 == 0 and plan.chunk % 16 == 0
    assert (plan.chunks - 1) * chunk < plan.nbytes <= plan.chunks * chunk \
        or plan.nbytes == plan.chunks == 0
    assert 1 <= plan.blocks <= max(wave, 1)
    assert plan.blocks <= max(plan.chunks, 1)


def test_ring_plan_cuts_whole_chunks_and_a_partial_last():
    """1000 f32 elements on a 16-byte boundary in chunks of 256 bytes: 15
    whole chunks and one of 160 bytes, on 3 blocks of a wave of 3."""
    from tpu_bench_torch.kernels import ring

    plan = ring.ring_plan(1000, 4, 0, 256, 3)
    assert (plan.nbytes, plan.chunks, plan.blocks) == (4000, 16, 3)
    assert plan.nbytes - (plan.chunks - 1) * plan.chunk == 160
    assert (plan.head, plan.tail) == (0, 0)
    assert ring.ring_plan(1000, 4, 0, 256, 99).blocks == 16


@pytest.mark.parametrize("use", ["copy", "scale", "triad", "add"])
def test_ring_settings_fit_one_block(use):
    """The default and every swept setting: chunks of whole 16-byte
    vectors, MIN_DEPTH..MAX_DEPTH slots, within one block's shared memory;
    the default is one of the swept settings, with room for two blocks an
    SM."""
    from tpu_bench_torch.kernels import ring

    swept = ring.settings(use)
    assert ring.RING[use] in swept
    chunk, depth = ring.RING[use]
    assert 2 * ring.smem_bytes(use, chunk, depth) <= ring.SMEM_BLOCK
    for chunk, depth in swept:
        assert chunk % 16 == 0
        assert ring.MIN_DEPTH <= depth <= ring.MAX_DEPTH
        assert ring.smem_bytes(use, chunk, depth) <= ring.SMEM_BLOCK


def test_ring_wrappers_refuse_bad_operands():
    """K12's and K7's wrappers keep their checks with the ring: dtype,
    device, shape, contiguity and the scalar operand."""
    from tpu_bench_torch.kernels import axpy

    x, c = torch.zeros(256), torch.ones((1, 1))
    with pytest.raises(ValueError, match="scalar"):
        stream.triad_manual(x, x.clone(), torch.ones((2, 1)))
    with pytest.raises(ValueError, match="differ in shape"):
        stream.copy_manual(x, out=torch.zeros(384))
    with pytest.raises(ValueError, match="multiple of"):
        stream.scale_manual(torch.zeros(200), c)
    with pytest.raises(TypeError, match="one dtype"):
        stream.add_inplace_manual(x, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        stream.scale_manual(torch.zeros(512)[::2], c)
    with pytest.raises(ValueError, match="differ in shape"):
        axpy.add_inplace_wide(x, torch.zeros(128))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        stream.copy_manual(x.bfloat16())
    # tensors on the CPU take the plain versions
    y = torch.arange(256.0)
    assert torch.equal(stream.copy_manual(y), y)
    assert torch.equal(axpy.add_inplace_wide(y.clone(), y), 2 * y)
    assert torch.equal(stream.scale_manual(y.clone(), 2 * c), 2 * y)


# The ring's cases on the card: (label, elements, x's and y's offsets in
# elements into their buffers); a chunk and "blocks x depth" are set from
# the use's ring and wave.  n = None: the case's size comes from the ring.
RING_CASES = ["one chunk", "partial last chunk", "more than blocks x depth",
              "n=1000", "n=1048579", "off 16 B alike", "placed apart",
              "on a second stream", "main size"]


def _ring_case_n(case, use, itemsize, wave):
    from tpu_bench_torch.kernels import ring

    chunk, depth = ring.RING[use]
    per_chunk = chunk // itemsize
    return {"one chunk": per_chunk,
            "partial last chunk": 5 * per_chunk + 128,
            "more than blocks x depth": (wave * depth + 3) * per_chunk + 640,
            "n=1000": 1000,
            "main size": 536870912 if use == "add" else 134217728}.get(
                case, 1048579)


@pytest.mark.cuda
@pytest.mark.parametrize("case", RING_CASES)
@pytest.mark.parametrize("use", ["copy", "scale", "triad", "add"])
def test_ring_matches_plain_on_card(use, case):
    """K12 (copy, scale, triad) and K7's 16-byte form (add) through the
    ring against their plain versions, f32 and f64: copy, scale and add
    bit for bit, triad to 1e-5 / 1e-12 (the kernel may fuse).  Calls on a
    second stream take chunks from that stream's counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_bench_torch.kernels import axpy, build, ring

    gen = torch.Generator(device="cuda").manual_seed(11)
    offsets = {"off 16 B alike": (1, 1), "placed apart": (1, 2)}.get(case,
                                                                    (0, 0))
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        size = dtype.itemsize
        chunk, depth = ring.RING[use]
        wave = ring.ring_wave(0, size, use, chunk, depth)
        n = _ring_case_n(case, use, size, wave)

        def rnd(offset):
            return torch.randn(n + 4, generator=gen, device="cuda",
                               dtype=dtype)[offset:offset + n]

        x, y, c = rnd(offsets[0]), rnd(offsets[1]), torch.randn(
            1, 1, generator=gen, device="cuda", dtype=dtype)
        # the case is what its label says, by the ring's plan
        plan = ring.ring_plan(n, size, x.data_ptr(), chunk, wave)
        assert {"one chunk": plan.chunks == 1,
                "partial last chunk": plan.nbytes % chunk != 0,
                "more than blocks x depth":
                    plan.chunks > plan.blocks * depth}.get(case, True), plan
        xs, xp = x.clone(), x.clone()
        if offsets[0]:  # keep x's placement in the in-place copy
            xs = torch.empty(n + 4, dtype=dtype, device="cuda")[
                offsets[0]:offsets[0] + n].copy_(x)
        kernel = {"copy": "stream_map", "scale": "stream_map",
                  "triad": "stream_map", "add": "map2_inplace"}[use]
        before = build.launches[kernel]
        # K12 through its C entry (n need not be whole 128-wide rows), in
        # place but for copy, whose output is placed as y
        if use == "copy":
            got = torch.empty(n + 4, dtype=dtype, device="cuda")[
                offsets[1]:offsets[1] + n]
            src, ref = x, x.clone()
        else:
            got = src = xs
            ref = {"scale": lambda: stream.scale_plain(xp, c),
                   "triad": lambda: stream.triad_plain(xp, y, c),
                   "add": lambda: axpy.map2_inplace_plain(xp, y)}[use]()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side if case == "on a second stream"
                               else torch.cuda.current_stream()):
            if use == "add":
                axpy.add_inplace_wide(xs, y)
            else:
                chunk, depth = ring.RING[use]
                build.run("stream_map", x, got.data_ptr(), src.data_ptr(),
                          y.data_ptr(), c.data_ptr(), n, ring.MAP_OPS[use],
                          chunk, depth)
        torch.cuda.synchronize()
        assert build.launches[kernel] == before + 1
        if use == "triad":
            err = (got - ref).abs().max() / ref.abs().max()
            assert float(err) <= tol, (case, dtype, float(err))
        else:
            assert torch.equal(got, ref), (case, dtype)
        del x, y, xs, xp, got, ref, src
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("handle", [1, 2])
def test_ring_refuses_shared_stream_handles_on_card(handle):
    """The ring's counter belongs to one stream, so the handles that stand
    for a different stream in each host thread, cudaStreamLegacy (1) and
    cudaStreamPerThread (2), are refused with an error, not launched on;
    the operands are left as they were."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_bench_torch.kernels import build, ring

    x = torch.arange(4096.0, device="cuda")
    y = torch.ones_like(x)
    torch.cuda.synchronize()
    err = build.entry("map2_inplace", x.dtype)(
        x.data_ptr(), y.data_ptr(), x.numel(), 1, *ring.RING["add"], handle)
    torch.cuda.synchronize()
    assert err != 0
    assert torch.equal(x, torch.arange(4096.0, device="cuda"))
