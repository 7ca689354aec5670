"""benchmark02's hand-pipelined add and the bandwidth-ceiling probes (port
of tpu_bench/kernels/stream.py).

On the TPU these functions stream through rings of 16 MB VMEM slots with
manual DMA (fill through Mosaic's block pipeline), so the copies overlap
the compute.  On the card K12 and K7's 16-byte form stream through its
analog, a ring of shared-memory slots filled and drained by
cp.async.bulk (kernels/ring.py, csrc/ring.cuh); the other probes'
resident warps keep the loads in flight.

    add_inplace_manual(x, y)     x += y              K7, 16-byte form
    copy_manual(x, out=)         out = x             K12 stream_map
    scale_manual(x, c)           x *= c              K12
    triad_manual(x, y, c)        x += c*y            K12
    fill(rows, seed)             (rows, 128) of seed K11, scalar stores
    fill_manual(rows, seed)      the same            K11, 16-byte stores
    expand_manual(x, m, bias)    m interleaved copies of x's chunks + bias
                                                     K13 stream_expand
    read_manual(x, bias)         reads all of x; an (8, 128) token
                                                     K10 stream_read

x and y are 1-D with a length that is a multiple of 128 (the TPU's lane
width, kept so the chunking below is the JAX package's); c, seed and bias
are (1, 1) tensors on x's device, read by the kernel from device memory,
so no call syncs with the host.  The JAX package's copy aliases its output
to x for its chained timing; a self-copy is no 1R+1W measurement on the
card, so copy_manual writes a second buffer.

chunk_bytes and depth stay where they fix the output: expand_manual's
output chunk j*m + t is input chunk j, and read_manual's token holds the
first 8 rows of the last chunk that the ring cycled into slot 0.  A chunk
is the largest power-of-two number of 128-wide rows that divides the rows
and fits chunk_bytes (`chunk_rows`; depth plays no part there).

A tensor on the CPU goes to the plain PyTorch version; a tensor on a CUDA
device goes to the kernel, which raises rather than fall back when it
cannot run.
"""

from __future__ import annotations

import torch

from tpu_bench_torch.kernels import axpy, build, ring

LANES = 128  # the TPU's lane width: x is viewed as (rows, LANES)
TOKEN_ROWS = 8  # rows of read_manual's token
CHUNK_BYTES = 16 * 1024 * 1024
DEPTH = 3
# stream_map's ops (csrc/stream_probes.cu)
_COPY, _SCALE, _TRIAD = 0, 1, 2


def pow2_rows(total_rows: int, target: int) -> int:
    """Largest power-of-two divisor of total_rows that is <= target."""
    r = 1
    while r * 2 <= target and total_rows % (r * 2) == 0:
        r *= 2
    return r


def as_2d(x, lanes: int = LANES):
    """View a 1-D tensor whose length is a multiple of lanes as (rows,
    lanes)."""
    if x.dim() != 1 or x.shape[0] % lanes:
        raise ValueError(f"expected a 1-D tensor whose length is a multiple "
                         f"of {lanes}, got shape {tuple(x.shape)}")
    return x.view(x.shape[0] // lanes, lanes)


def chunk_rows(rows: int, itemsize: int, chunk_bytes: int) -> int:
    """Largest power-of-2 row chunk <= chunk_bytes that divides rows."""
    target = max(chunk_bytes // (LANES * itemsize), 1)
    return pow2_rows(rows, target)


def _check_scalar(name: str, x, s) -> None:
    """Raise unless s can be the (1, 1) scalar operand of x's kernel."""
    build.check_operands(name, (x, s))
    if s.numel() != 1:
        raise ValueError(f"{name}: expected a (1, 1) scalar operand, got "
                         f"shape {tuple(s.shape)}")


def _zeros_like_scalar(x):
    return torch.zeros((1, 1), dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# benchmark02's add (K7)
# ---------------------------------------------------------------------------


def add_inplace_manual(x, y):
    """x += y in place (b02 Pallas(vl)); returns x."""
    return axpy.map2(x, y, vector=True, name="add_inplace_manual")


# ---------------------------------------------------------------------------
# copy, scale, triad (K12)
# ---------------------------------------------------------------------------


def copy_plain(x, out):
    """Plain PyTorch version: out = x; returns out."""
    return out.copy_(x)


def scale_plain(x, c):
    """Plain PyTorch version: x *= c[0, 0]; returns x."""
    return x.mul_(c.reshape(()))


def triad_plain(x, y, c):
    """Plain PyTorch version: x += c[0, 0] * y; returns x."""
    return x.add_(c.reshape(()) * y)


def copy_manual(x, *, out=None):
    """out = x (1R+1W), the copy-mix ceiling probe; out (allocated when
    None) must not overlap x.  Returns out."""
    as_2d(x)
    if out is None:
        out = torch.empty_like(x)
    build.check_operands("copy_manual", (x, out))
    if out.shape != x.shape:
        raise ValueError(f"copy_manual: out {tuple(out.shape)} and x "
                         f"{tuple(x.shape)} differ in shape")
    if x.is_cpu:
        return copy_plain(x, out)
    build.run("stream_map", x, out.data_ptr(), x.data_ptr(), None, None,
              x.numel(), _COPY, *ring.RING["copy"])
    return out


def scale_manual(x, c):
    """x *= c[0, 0] in place (1R+1W with compute), STREAM-scale; returns
    x."""
    as_2d(x)
    _check_scalar("scale_manual", x, c)
    if x.is_cpu:
        return scale_plain(x, c)
    build.run("stream_map", x, x.data_ptr(), x.data_ptr(), None,
              c.data_ptr(), x.numel(), _SCALE, *ring.RING["scale"])
    return x


def triad_manual(x, y, c):
    """x = x + c[0, 0]*y in place (2R+1W), STREAM-triad; returns x.  The
    kernel may fuse the multiply and the add (one rounding), the plain
    version rounds both."""
    as_2d(x)
    build.check_operands("triad_manual", (x, y))
    if x.shape != y.shape:
        raise ValueError(f"triad_manual: x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)} differ in shape")
    _check_scalar("triad_manual", x, c)
    if x.is_cpu:
        return triad_plain(x, y, c)
    build.run("stream_map", x, x.data_ptr(), x.data_ptr(), y.data_ptr(),
              c.data_ptr(), x.numel(), _TRIAD, *ring.RING["triad"])
    return x


# ---------------------------------------------------------------------------
# write-only fill (K11)
# ---------------------------------------------------------------------------


def fill_plain(rows: int, seed, *, dtype=torch.float32):
    """Plain PyTorch version: a (rows, 128) tensor of seed[0, 0]."""
    out = torch.empty((rows, LANES), dtype=dtype, device=seed.device)
    return out.fill_(seed.reshape(()))


def fill(rows: int, seed, *, dtype=torch.float32):
    """Write a (rows, 128) tensor of seed[0, 0] by scalar stores:
    pure-write bandwidth."""
    return _fill("fill", rows, seed, dtype, vector=False)


def fill_manual(rows: int, seed, *, dtype=torch.float32):
    """The same by 16-byte stores, the TPU's DMA fan-out probe: the 1W
    direction probe of benchmarks/ceilings.py."""
    return _fill("fill_manual", rows, seed, dtype, vector=True)


def _fill(name, rows, seed, dtype, *, vector):
    out = torch.empty((rows, LANES), dtype=dtype, device=seed.device)
    _check_scalar(name, out, seed)
    if out.is_cpu:
        return fill_plain(rows, seed, dtype=dtype)
    build.run("stream_fill", out, out.data_ptr(), out.numel(),
              seed.data_ptr(), int(vector))
    return out


# ---------------------------------------------------------------------------
# 1R:mW expand (K13)
# ---------------------------------------------------------------------------


def expand_plain(x, m: int, bias=None, *, chunk_bytes: int = CHUNK_BYTES):
    """Plain PyTorch version: (m * rows, 128) whose chunk j*m + t is chunk
    j of x + bias[0, 0], t < m."""
    x2 = as_2d(x)
    cr = chunk_rows(x2.shape[0], x.element_size(), chunk_bytes)
    b = (_zeros_like_scalar(x) if bias is None else bias).reshape(())
    src = x.view(-1, 1, cr * LANES) + b
    return src.expand(-1, m, cr * LANES).reshape(-1, LANES)


def expand_manual(x, m: int, bias=None, *, chunk_bytes: int = CHUNK_BYTES):
    """Write m copies of x + bias[0, 0] (1R:mW): the write-heavy mix probes
    of benchmarks/ceilings.py, covering the BwdTrans benchmarks' regime
    (up to 1R:8W at 3D nq=2).  Output chunk j*m + t is input chunk j."""
    x2 = as_2d(x)
    if m < 1:
        raise ValueError(f"expand_manual: m = {m} copies")
    if bias is None:
        bias = _zeros_like_scalar(x)
    _check_scalar("expand_manual", x, bias)
    if x.is_cpu:
        return expand_plain(x, m, bias, chunk_bytes=chunk_bytes)
    cr = chunk_rows(x2.shape[0], x.element_size(), chunk_bytes)
    out = torch.empty((m * x2.shape[0], LANES), dtype=x.dtype,
                      device=x.device)
    build.run("stream_expand", x, x.data_ptr(), x.numel(), bias.data_ptr(),
              out.data_ptr(), m, (cr * LANES).bit_length() - 1)
    return out


# ---------------------------------------------------------------------------
# read-only probe (K10)
# ---------------------------------------------------------------------------


def _token_start(x2, chunk_bytes, depth) -> int:
    """First element of read_manual's token: chunk j0 = the last chunk
    index with j0 % depth == 0, the last one the TPU ring cycled into slot
    0."""
    rows = x2.shape[0]
    cr = chunk_rows(rows, x2.element_size(), chunk_bytes)
    if cr < TOKEN_ROWS:
        raise ValueError(f"read_manual: chunks of {cr} rows hold no "
                         f"({TOKEN_ROWS}, {LANES}) token")
    if depth < 1:
        raise ValueError(f"read_manual: depth {depth}")
    j0 = (rows // cr - 1) // depth * depth
    return j0 * cr * LANES


def read_plain(x, bias=None, *, chunk_bytes: int = CHUNK_BYTES,
               depth: int = DEPTH):
    """Plain PyTorch version: the token rows of x + bias[0, 0] (it reads
    only those rows)."""
    x2 = as_2d(x)
    t0 = _token_start(x2, chunk_bytes, depth) // LANES
    b = (_zeros_like_scalar(x) if bias is None else bias).reshape(())
    return x2[t0:t0 + TOKEN_ROWS] + b


def read_manual(x, bias=None, *, chunk_bytes: int = CHUNK_BYTES,
                depth: int = DEPTH):
    """Pure-read bandwidth probe: read all of x and return an (8, 128)
    token, rows of x + bias[0, 0] (the JAX package's chained-timing data
    dependence): the 1R direction probe of benchmarks/ceilings.py."""
    x2 = as_2d(x)
    tok0 = _token_start(x2, chunk_bytes, depth)
    if bias is None:
        bias = _zeros_like_scalar(x)
    _check_scalar("read_manual", x, bias)
    if x.is_cpu:
        return read_plain(x, bias, chunk_bytes=chunk_bytes, depth=depth)
    tok = torch.empty((TOKEN_ROWS, LANES), dtype=x.dtype, device=x.device)
    # one word the kernel XORs every loaded bit pattern into
    sink = torch.empty(1, dtype=torch.int64, device=x.device)
    build.run("stream_read", x, x.data_ptr(), x.numel(), bias.data_ptr(),
              tok.data_ptr(), tok0, sink.data_ptr())
    return tok
