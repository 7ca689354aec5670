"""Package rules of the PyTorch/CUDA port: no import of JAX or of the JAX
package, no silent move to the CPU, the nvcc build names only the package's
own sources for sm_90a, and (on a CUDA card only) each kernel against its
plain version."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_bench_torch.core.config import Config
from tpu_bench_torch.kernels import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import tpu_bench_torch
names = [m.name for m in pkgutil.walk_packages(tpu_bench_torch.__path__,
                                               "tpu_bench_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert len(names) >= 20, names
assert {"tpu_bench_torch.benchmarks.benchmark0" + i for i in "12345"} | {
    "tpu_bench_torch.baselines." + b
    for b in ("bwdtrans2d", "reduction", "axpy", "matvec")} | {
    "tpu_bench_torch.kernels." + k
    for k in ("reduction", "axpy", "stream", "matvec", "ozaki")} | {
    "tpu_bench_torch.benchmarks.ceilings",
    "tpu_bench_torch.core.roofline"} <= set(names), names
foreign = sorted(m for m in sys.modules
                 if m.startswith("jax") or m == "tpu_bench"
                 or m.startswith("tpu_bench."))
assert not foreign, foreign
print(len(names))
"""


def test_port_imports_no_jax():
    """Every module of the port and chip_smoke import neither jax* nor any
    module of the JAX package tpu_bench."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr


def test_cuda_config_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        Config(device="cuda")
    assert Config(device="cpu").device == torch.device("cpu")


def test_bf16_config_names_roadmap_item():
    """Config takes bf16; benchmarks 01-03 refuse it, naming ROADMAP Queue
    1 item 2c (their kernels, K6-K9, are built in f32 and f64 only)."""
    from tpu_bench_torch.benchmarks import benchmark01, benchmark02
    from tpu_bench_torch.benchmarks import benchmark03

    assert Config(dtype=torch.bfloat16, device="cpu").itemsize == 2
    for bench in (benchmark01, benchmark02, benchmark03):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue 1 item 2c"):
            bench.main(["--dtype", "bf16", "--device", "cpu"])


def test_nvcc_command_builds_package_sources_for_sm90a():
    """One nvcc per source, each for sm_90a, then one link of their
    objects into the library."""
    output = Path("/nonexistent/lib.so")
    compiles, link = build.nvcc_commands(output)
    sources = [Path(a) for cmd in compiles for a in cmd
               if a.endswith((".cu", ".cuh"))]
    assert {p.name for p in sources} == {"bwdtrans2d.cu", "bwdtrans3d.cu",
                                         "qp1d_fused3d.cu", "reduction.cu",
                                         "stream.cu", "matvec.cu",
                                         "stream_probes.cu", "ozaki.cu",
                                         "qp_fused3d_probe.cu"}
    assert len(compiles) == len(sources)
    assert all(p.parent == build.CSRC_DIR for p in sources)
    for cmd in (*compiles, link):
        assert "arch=compute_90a,code=sm_90a" in cmd
    objects = [cmd[cmd.index("-o") + 1] for cmd in compiles]
    assert "-shared" in link and link[link.index("-o") + 1] == str(output)
    assert link[-len(objects):] == objects
    assert build.library_path().parent == build.BUILD_DIR


def test_build_logs_seconds_of_each_compile_and_the_link(tmp_path,
                                                        monkeypatch):
    """build() keeps the compilers' output in build.log, then a line of
    each source's nvcc seconds and the link's; stand-in commands write
    the objects and the library."""
    write = [sys.executable, "-c",
             "import sys; open(sys.argv[1], 'w').close(); print('ptxas out')"]

    def commands(output):
        objects = build._objects(output)
        return [[*write, str(obj)] for obj in objects], [*write, str(output)]

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc_commands", commands)
    so = build.build()
    assert so.exists() and so.parent == tmp_path
    lines = (tmp_path / "build.log").read_text().splitlines()
    sources = build.sources()
    assert lines[:len(sources) + 1] == ["ptxas out"] * (len(sources) + 1)
    times = lines[len(sources) + 1:]
    assert [t.split()[:-2] for t in times] == [
        *(["time:", src.name, "nvcc"] for src in sources), ["time:", "link"]]
    for t in times:
        assert t.endswith(" s") and float(t.split()[-2]) > 0
    assert not list(tmp_path.glob("*.o"))


def test_chip_smoke_alone_fails(tmp_path):
    """Outside a checkout (or without a card) the smoke test exits non-zero
    and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def _kernel_cases(rnd):
    """{kernel: (wrapper call, plain call)} at nq=8^3 shapes (qp1d_fused2d:
    b04 nq=8^2), E=1000; the stream kernels at n = 1000 with x one element
    past a 16-byte boundary, and A (1000, 777); the ceiling probes at
    n = 128 * 64 in chunks of 8 rows, K12 as triad with x and y one element
    past a boundary, K13 with m = 4."""
    from tpu_bench_torch.kernels import axpy as k7
    from tpu_bench_torch.kernels import bwdtrans2d as k2
    from tpu_bench_torch.kernels import bwdtrans3d as k1
    from tpu_bench_torch.kernels import matvec as kmv
    from tpu_bench_torch.kernels import reduction as k6
    from tpu_bench_torch.kernels import stream

    x, b0, c12t, c = rnd(7, 49, 1000), rnd(7, 8), rnd(64, 49), rnd(512, 343)
    xb, w, em = rnd(2, 343, 1000), rnd(7, 64, 1000), rnd(1000, 343)
    s = (rnd(343, 392), rnd(392, 448), rnd(448, 512))
    c_em = rnd(343, 512)
    em2, s2d = rnd(1000, 49), (rnd(49, 56), rnd(56, 64))
    v, y, a = rnd(1001)[1:], rnd(1001)[1:], rnd(1000, 777)
    a_cm, xs, xp = a.t().contiguous(), v.clone(), v.clone()
    p, q, k, bias = rnd(8193)[1:], rnd(8193)[1:], rnd(1, 1), rnd(1, 1)
    ps, pp, cb = p.clone(), p.clone(), 8 * 128 * p.element_size()
    return {
        "qp_fused3d": (lambda: k1.qp_shared3d(x, b0, c12t),
                       lambda: k1.qp_shared3d_plain(x, b0, c12t)),
        "kron_blocked": (lambda: k2.kron_blocked(xb, c),
                         lambda: k2.kron_blocked_plain(xb, c)),
        "em_gemm": (lambda: k2.kron_elem_major(em, c_em),
                    lambda: k2.kron_elem_major_plain(em, c_em)),
        "qp_stage2_3d": (lambda: k1.qp_stage2_3d(w, b0),
                         lambda: k1.qp_stage2_3d_plain(w, b0)),
        "qp1d_fused3d": (lambda: k1.qp1d_shared3d(em, *s),
                         lambda: k1.qp1d3d_plain(em, *s)),
        "qp1d_fused2d": (lambda: k1.qp1d_fused(em2, *s2d),
                         lambda: k2.qp1d_plain(em2, *s2d)),
        "sumsq": (lambda: k6.sumsq_wide(v, 0.5),
                  lambda: k6.sumsq_plain(v, 0.5)),
        "map2_inplace": (lambda: k7.add_inplace_wide(xs, y),
                         lambda: k7.map2_inplace_plain(xp, y)),
        "matvec_rm": (lambda: kmv.matvec_rm(a, v[:777]),
                      lambda: kmv.matvec_rm_plain(a, v[:777])),
        "matvec_cm": (lambda: kmv.matvec_cm(a_cm, v[:777]),
                      lambda: kmv.matvec_cm_plain(a_cm, v[:777])),
        "stream_read": (
            lambda: stream.read_manual(p, bias, chunk_bytes=cb),
            lambda: stream.read_plain(p, bias, chunk_bytes=cb)),
        "stream_fill": (lambda: stream.fill_manual(64, k, dtype=k.dtype),
                        lambda: stream.fill_plain(64, k, dtype=k.dtype)),
        "stream_map": (lambda: stream.triad_manual(ps, q, k),
                       lambda: stream.triad_plain(pp, q, k)),
        "stream_expand": (
            lambda: stream.expand_manual(p, 4, bias, chunk_bytes=cb),
            lambda: stream.expand_plain(p, 4, bias, chunk_bytes=cb)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["qp_fused3d", "kron_blocked", "em_gemm",
                                    "qp_stage2_3d", "qp1d_fused3d",
                                    "qp1d_fused2d", "sumsq", "map2_inplace",
                                    "matvec_rm", "matvec_cm", "stream_read",
                                    "stream_fill", "stream_map",
                                    "stream_expand"])
def test_kernels_match_plain_on_card(kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device="cuda",
                               dtype=dtype)

        run, plain = _kernel_cases(rnd)[kernel]
        before = build.launches[kernel]
        out, ref = run(), plain()
        torch.cuda.synchronize()
        assert float((out - ref).abs().max() / ref.abs().max()) <= tol
        assert build.launches[kernel] == before + 1


# the benchmark's cells' K1 shape, b05 nq=8^3: (nm0, nrq, nq0, nkj)
CELL_SHAPE = (7, 49, 8, 64)


def _rel_err(out, ref) -> float:
    """The largest |out - ref| over the largest |ref|, in f64."""
    return float((out.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12),
                                       (torch.bfloat16, 2**-7)],
                         ids=["f32", "f64", "bf16"])
def test_qp_fused3d_ring_on_card(dtype, tol):
    """K1's depth-2 form (a one-wave grid of persistent blocks on the
    stream's tile counter) at b05 nq=8^3, at every tile, plane group and
    block size whose two slabs fit, against the plain version: on E =
    131071 (a ragged last tile, and thousands of tiles, so each block
    walks many) and E = 1001 (rows of no whole 16-byte words: the scalar
    copies and stores); then four launches back to back on one stream
    with no synchronisation between (each takes its tiles from the
    counter the one before set back to zero).  The cells' shape takes the
    depth qp_config records, counted once a launch in qp_depths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_bench_torch.kernels import bwdtrans3d as k1

    nm0, nrq, nq0, nkj = CELL_SHAPE
    size = dtype.itemsize
    gen = torch.Generator(device="cuda").manual_seed(15)

    def operands(e):
        return (torch.randn(*s, generator=gen, device="cuda", dtype=dtype)
                for s in ((nm0, nrq, e), (nm0, nq0), (nkj, nrq)))

    forms = [c for c in k1.qp_settings(size, *CELL_SHAPE) if c.depth == 2]
    assert forms
    for e in (131071, 1001):
        x, b0, c = operands(e)
        ref = k1.qp_shared3d_plain(x, b0, c)
        for et, g, d, t, body, where in forms:
            out = k1.qp_shared3d(x, b0, c, epb=et, planes=g, depth=d,
                                 threads=t, body=body, where=where)
            torch.cuda.synchronize()
            assert _rel_err(out, ref) <= tol, (e, et, g, d, t, body, where)
    et, g, d, t, body, where = forms[0]
    calls = [tuple(operands(1000)) for _ in range(4)]
    outs = [k1.qp_shared3d(*ops, epb=et, planes=g, depth=d, threads=t,
                           body=body, where=where)
            for ops in calls]
    torch.cuda.synchronize()
    for ops, out in zip(calls, outs):
        assert _rel_err(out, k1.qp_shared3d_plain(*ops)) <= tol
    depth = k1.qp_config(size, *CELL_SHAPE).depth
    before = k1.qp_depths.copy()
    x, b0, c = operands(4096)
    out = k1.qp_shared3d(x, b0, c)
    torch.cuda.synchronize()
    assert _rel_err(out, k1.qp_shared3d_plain(x, b0, c)) <= tol
    assert k1.qp_depths - before == {depth: 1}


def _measured_rings():
    """QP_MEASURED's depth-2 entries: ((itemsize, nm0, nrq, nq0, nkj),
    QPConfig), the rings qp_config takes."""
    from tpu_bench_torch.kernels import bwdtrans3d as k1

    return [(shape, cfg) for shape, cfg in k1.QP_MEASURED.items()
            if cfg.depth == 2]


RING_DTYPES = {2: (torch.bfloat16, 2**-7), 4: (torch.float32, 1e-5),
               8: (torch.float64, 1e-12)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cfg", _measured_rings(),
                         ids=lambda v: "-".join(map(str, v)))
def test_qp_fused3d_measured_rings_on_card(shape, cfg):
    """Each depth-2 setting qp_config records (QP_MEASURED) at its shape:
    on E = 131071 (a ragged last tile, and dozens of tiles a block),
    against the plain version and, where qp_settings offers the same
    (tile, planes, threads, body, C12T) at depth 1, bit for bit against
    it (each tile is computed by the same code whichever block takes it
    and whenever its index is read); then four launches of 1000, 20001,
    1001 and 4099 elements back to back on one stream with no
    synchronisation between (each takes its tiles from the counter the
    one before set back to zero)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_bench_torch.kernels import bwdtrans3d as k1

    size, nm0, nrq, nq0, nkj = shape
    dtype, tol = RING_DTYPES[size]
    gen = torch.Generator(device="cuda").manual_seed(25)
    knobs = dict(epb=cfg.et, planes=cfg.planes, depth=cfg.depth,
                 threads=cfg.threads, body=cfg.body, where=cfg.c12t)

    def operands(e):
        return tuple(torch.randn(*s, generator=gen, device="cuda",
                                 dtype=dtype)
                     for s in ((nm0, nrq, e), (nm0, nq0), (nkj, nrq)))

    ops = operands(131071)
    out = k1.qp_shared3d(*ops, **knobs)
    torch.cuda.synchronize()
    assert _rel_err(out, k1.qp_shared3d_plain(*ops)) <= tol
    flat = cfg._replace(depth=1)
    if flat in k1.qp_settings(*shape):
        assert torch.equal(out, k1.qp_shared3d(*ops, **dict(knobs, depth=1)))
    del ops, out
    calls = [operands(e) for e in (1000, 20001, 1001, 4099)]
    outs = [k1.qp_shared3d(*ops, **knobs) for ops in calls]
    torch.cuda.synchronize()
    for ops, out in zip(calls, outs):
        assert _rel_err(out, k1.qp_shared3d_plain(*ops)) <= tol, ops[0].shape


@pytest.mark.cuda
@pytest.mark.parametrize("form,t_c,t_x", [("pair", 9, 9), ("band", 9, 9),
                                          ("band", 7, 9), ("band", 9, 7)])
def test_ozaki_slices_match_plain_on_card(form, t_c, t_x):
    """K14: bf16 slices of the b05 nq=8^3 depth in, hi and lo equal to the
    plain version bit for bit; one launch for the pair form, one a band
    for the band form."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from tpu_bench_torch.kernels import ozaki

    rng = np.random.default_rng(t_c * 10 + t_x)
    w, _ = ozaki.slice_params(343)
    c_sl, _ = ozaki.split_f64_np(rng.standard_normal((512, 343)), w, t_c)
    x_sl, _ = ozaki.split_f64_np(rng.standard_normal((343, 1000)), w, t_x)
    c, x = (torch.from_numpy(a).to("cuda", torch.bfloat16)
            for a in (c_sl, x_sl))
    fn = ozaki.kron_ozaki_pair if form == "pair" else ozaki.kron_ozaki_band
    before = build.launches["ozaki_slices"]
    hi, lo = fn(x, c)
    torch.cuda.synchronize()
    hi_p, lo_p = ozaki.kron_ozaki_pair_plain(x, c)
    assert torch.equal(hi, hi_p) and torch.equal(lo, lo_p)
    n_launches = 1 if form == "pair" else max(t_c, t_x)
    assert build.launches["ozaki_slices"] == before + n_launches


@pytest.mark.cuda
@pytest.mark.parametrize("k,m,e,t_c,t_x", [
    (49, 64, 1000, None, None), (343, 512, 1000, None, None),
    (729, 1000, 1000, None, None), (49, 64, 1000, 6, 8),
    (343, 512, 1000, 9, 7), (729, 1000, 1000, 11, 9),
    (343, 512, 999, 9, 9)])
def test_ozaki_tensor_core_tile_edges_on_card(k, m, e, t_c, t_x):
    """K14 on the tensor cores at its tile edges: the depths of b04 nq=8^2,
    b05 nq=8^3 and nq=10^3 (k not a multiple of the mma depth), rows past
    the 64- and 128-row tiles, E = 1000 (a ragged column tile) and 999
    (rows of X that are not whole 16-byte chunks), T_c != T_x: both forms
    bit for bit in hi and lo."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from tpu_bench_torch.kernels import ozaki

    rng = np.random.default_rng(k + e)
    w, t = ozaki.slice_params(k)
    c_sl, _ = ozaki.split_f64_np(rng.standard_normal((m, k)), w, t_c or t)
    x_sl, _ = ozaki.split_f64_np(rng.standard_normal((k, e)), w, t_x or t)
    c, x = (torch.from_numpy(a).to("cuda", torch.bfloat16)
            for a in (c_sl, x_sl))
    hi_p, lo_p = ozaki.kron_ozaki_pair_plain(x, c)
    for fn in (ozaki.kron_ozaki_pair, ozaki.kron_ozaki_band):
        hi, lo = fn(x, c)
        torch.cuda.synchronize()
        assert torch.equal(hi, hi_p) and torch.equal(lo, lo_p), fn.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [(10, 10, 10), (32, 32)])
def test_qp1d_tensor_core_tiles_on_card(nq):
    """K5 (3xTF32 in f32, DMMA in f64, one bf16 pass in bf16) at every
    element tile that fits, at b05 nq=10^3 (an S1 whose rows are not whole
    16-byte chunks) and b04 nq=32^2 (the widest workspaces), E = 1000:
    within 1e-5 (f32), 1e-12 (f64) and 2^-7 (bf16) of the plain version,
    relative to the largest output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_bench_torch.kernels import bwdtrans2d as k2
    from tpu_bench_torch.kernels import bwdtrans3d as k1

    nm = [n - 1 for n in nq]
    widths = ([nm[0] * nm[1], nm[1] * nq[0], nq[0] * nq[1]] if len(nq) == 2
              else [nm[0] * nm[1] * nm[2], nm[2] * nm[1] * nq[0],
                    nm[2] * nq[1] * nq[0], nq[0] * nq[1] * nq[2]])
    gen = torch.Generator(device="cuda").manual_seed(len(nq))
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12),
                       (torch.bfloat16, 2**-7)):
        em, *ops = (torch.randn(a, b, generator=gen, device="cuda",
                                dtype=dtype)
                    for a, b in zip((1000, *widths), widths))
        ref = em
        for s in ops:
            ref = k2.mm(ref, s)  # each stage rounded to the dtype
        tiles = k1.qp1d_tiles(em, *ops)
        assert tiles
        for et in tiles:
            out = k1.qp1d_fused(em, *ops, epb=et)
            torch.cuda.synchronize()
            assert float((out.double() - ref.double()).abs().max()
                         / ref.double().abs().max()) <= tol


# ---- the launch path: what a kernel launch costs the host --------------


class _FakeLibrary:
    """Stands in for the kernels' library: counts the lookups of each
    entry, records each call and reports success."""

    def __init__(self):
        self.lookups, self.calls, self.code = {}, [], 0

    def __getattr__(self, name):
        if name == "tbt_error_string":
            return lambda err: b"invalid configuration"
        self.lookups[name] = self.lookups.get(name, 0) + 1

        def entry(*args):
            self.calls.append((name, args))
            return self.code

        return entry


@pytest.fixture
def fake_library(monkeypatch):
    """build.library() as a _FakeLibrary, the CPU tensors' device index
    (-1) as the current device and 77 as its stream; the entry cache and
    launch counts are restored afterwards."""
    fake = _FakeLibrary()
    monkeypatch.setattr(build, "library", lambda: fake)
    monkeypatch.setattr(build, "current_device", lambda: -1)
    monkeypatch.setattr(build, "raw_stream", lambda index: 77)
    counts = build.launches.copy()
    build.entry.cache_clear()
    yield fake
    build.entry.cache_clear()
    build.launches.clear()
    build.launches.update(counts)


@pytest.mark.parametrize("name", ["map2_inplace", "stream_map", "matvec_rm"])
def test_build_resolves_each_entry_once(fake_library, name):
    """build.run looks each C entry up once per (name, dtype), passes the
    current stream last and counts every launch."""
    x32, x64 = torch.zeros(4), torch.zeros(4, dtype=torch.float64)
    before = build.launches[name]
    for _ in range(3):
        build.run(name, x32, 1, 2)
        build.run(name, x64, 3)
    assert fake_library.lookups == {f"tbt_{name}_f32": 1,
                                    f"tbt_{name}_f64": 1}
    assert fake_library.calls[-2:] == [(f"tbt_{name}_f32", (1, 2, 77)),
                                       (f"tbt_{name}_f64", (3, 77))]
    assert build.launches[name] == before + 6


def test_build_enters_device_context_only_off_current(fake_library,
                                                      monkeypatch):
    """On the current device build.run takes the stream without a device
    context; on another device it enters that device's context."""
    entered = []

    class Context:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            entered.append(self.index)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "device", Context)
    x = torch.zeros(4)
    build.run("sumsq", x, 5)
    assert entered == []
    monkeypatch.setattr(build, "current_device", lambda: 3)
    build.run("sumsq", x, 5)
    assert entered == [-1]
    assert fake_library.lookups == {"tbt_sumsq_f32": 1}


def test_build_raises_on_a_launch_error(fake_library):
    """A non-zero CUDA code from an entry raises with its message and is
    not counted as a launch."""
    fake_library.code = 9
    before = build.launches["sumsq"]
    with pytest.raises(RuntimeError, match="sumsq: CUDA error 9: invalid"):
        build.run("sumsq", torch.zeros(4), 1)
    assert build.launches["sumsq"] == before


# The orders of benchmarks 05 and 04 whose configurations are cached: b05
# 2^3 .. 10^3 and (3, 4, 5); run04.sh's orders and (10, 12)
B05_ORDERS = [(n, n, n) for n in range(2, 11)] + [(3, 4, 5)]
B04_ORDERS = [(n, n) for n in (2, 4, 6, 8, 10, 12, 14, 16, 32)] + [(10, 12)]
MATVEC_SHAPES = [(1000, 777), (777, 1000), (4096, 16384), (16384, 4096),
                 (16384, 16384)]


def _order_products(nq):
    """K1's (nm0, nrq, nq0, nkj), K2's products (M, K) and K3's (K, N) at
    order nq."""
    nm = [n - 1 for n in nq]
    if len(nq) == 2:
        k1_shape = (nm[0], nm[1], nq[0], nq[1])
        kron = [(nq[1], nm[1]), (nq[0] * nq[1], nm[0] * nm[1])]
        widths = [nm[0] * nm[1], nm[1] * nq[0], nq[0] * nq[1]]
    else:
        k1_shape = (nm[0], nm[1] * nm[2], nq[0], nq[1] * nq[2])
        kron = [(nq[1] * nq[2], nm[1] * nm[2]),
                (nq[0] * nq[1] * nq[2], nm[0] * nm[1] * nm[2])]
        widths = [nm[0] * nm[1] * nm[2], nm[1] * nm[2] * nq[0],
                  nm[2] * nq[0] * nq[1], nq[0] * nq[1] * nq[2]]
    em = [(widths[0], widths[-1]), *zip(widths, widths[1:])]
    return k1_shape, kron, em


@pytest.mark.parametrize("itemsize", [2, 4, 8], ids=["bf16", "f32", "f64"])
@pytest.mark.parametrize("nq", B05_ORDERS + B04_ORDERS,
                         ids=lambda nq: "x".join(map(str, nq)))
def test_cached_bwdtrans_configs_equal_their_rules(nq, itemsize):
    """K1's launch configuration and K1's, K2's, K3's and K4's rules, each
    computed once per key, equal the rules computed afresh at every b05
    and b04 order; K1's ring depth among them: the rule's where no knob is
    given, depth 1 for a given tile unless the depth is given too."""
    from tpu_bench_torch.kernels import bwdtrans2d as k2
    from tpu_bench_torch.kernels import bwdtrans3d as k1

    (nm0, nrq, nq0, nkj), kron, em = _order_products(nq)
    rule = k1.qp_config.__wrapped__(itemsize, nm0, nrq, nq0, nkj)
    for _ in range(2):
        assert k1.qp_config(itemsize, nm0, nrq, nq0, nkj) == rule
    if rule is not None:
        assert (rule.depth, rule.threads) in k1.qp_forms(itemsize, rule.et)
        assert k1.qp_launch_config(itemsize, nm0, nrq, nq0, nkj, None,
                                   None) == rule
        assert k1.qp_launch_config(itemsize, nm0, nrq, nq0, nkj, None, None,
                                   depth=rule.depth) == rule
        tile = k1.QP_RING_TILES[-1]
        planes = k1.qp_planes(tile, nkj)
        assert k1.qp_launch_config(itemsize, nm0, nrq, nq0, nkj, tile,
                                   None) == (tile, planes, 1, k1.QP_THREADS,
                                             "simt", "smem")
        threads = k1.QP_FORMS[itemsize][-1][1]
        if k1.qp_smem(itemsize, tile, planes, nm0, nrq, nq0, nkj,
                      2) <= k1.SMEM_BLOCK:
            assert k1.qp_launch_config(
                itemsize, nm0, nrq, nq0, nkj, tile, None, depth=2,
                threads=threads) == (tile, planes, 2, threads, "simt",
                                     "smem")
    for m, k in kron:
        assert k2.kron_config(itemsize, m, k) == \
            k2.kron_config.__wrapped__(itemsize, m, k)
    for k, n in em:
        assert k2.em_config(itemsize, k, n) == \
            k2.em_config.__wrapped__(itemsize, k, n)
    f = nkj * 131072
    for vector in (True, False):
        units = k1.qp2_units(f, itemsize, vector)
        for wave in (132, 264, 1056):
            assert k1.qp2_grid(units, k1.QP2_UNROLL, wave) == \
                k1.qp2_grid.__wrapped__(units, k1.QP2_UNROLL, wave)


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("m,n", MATVEC_SHAPES)
def test_cached_matvec_configs_equal_their_rules(m, n, itemsize):
    """K8's team and grid and K9's row shares, each computed once per key,
    equal the rules computed afresh at every matvec shape."""
    from tpu_bench_torch.kernels import matvec as kmv

    for vector in (True, False):
        units = n * itemsize // 16 if vector else n
        for rows in kmv.RM_ROWS:
            for unroll in kmv.RM_UNROLLS:
                lanes = kmv.rm_lanes(units, unroll)
                assert lanes == kmv.rm_lanes.__wrapped__(units, unroll)
                for wave in (132, 264):
                    assert kmv.rm_grid(m, rows, lanes, wave) == \
                        kmv.rm_grid.__wrapped__(m, rows, lanes, wave)
    for blocks in (132, 1056):
        for unroll in kmv.CM_UNROLLS:
            assert kmv.cm_splits(n, m, itemsize, blocks, unroll) == \
                kmv.cm_splits.__wrapped__(n, m, itemsize, blocks, unroll)


def test_qp_launch_config_refuses_bad_knobs():
    """K1's cached launch configuration keeps the wrapper's refusals."""
    from tpu_bench_torch.kernels import bwdtrans3d as k1

    with pytest.raises(ValueError, match="epb=3"):
        k1.qp_launch_config(4, 7, 49, 8, 64, 3, None)
    with pytest.raises(ValueError, match="planes=5"):
        k1.qp_launch_config(4, 7, 49, 8, 64, None, 5)
    with pytest.raises(ValueError, match="does not fit"):
        k1.qp_launch_config(4, 31, 961, 32, 1024, None, None)
    with pytest.raises(ValueError, match="does not fit"):
        k1.qp_launch_config(4, 7, 49, 8, 64, 128, None, 1024)
    with pytest.raises(ValueError, match="forms"):
        k1.qp_launch_config(4, 7, 49, 8, 64, 32, 4, depth=3)
    with pytest.raises(ValueError, match="forms"):
        k1.qp_launch_config(4, 7, 49, 8, 64, 32, 4, depth=1, threads=512)
    with pytest.raises(ValueError, match="forms"):  # not built in f64
        k1.qp_launch_config(8, 7, 49, 8, 64, 16, 8, depth=2, threads=512)
    with pytest.raises(ValueError, match="forms"):  # no ring at tile 64
        k1.qp_launch_config(4, 7, 49, 8, 64, 64, 4, depth=2)
    # two f64 slabs of 16 elements at b04 nq=32^2 do not fit; one does
    assert k1.qp_launch_config(8, 31, 31, 32, 32, 16, 8, depth=1)
    with pytest.raises(ValueError, match="depth 2 does not fit"):
        k1.qp_launch_config(8, 31, 31, 32, 32, 16, 8, depth=2)
    # DMMA is built in f64 only, at the tiles QP_DMMA_TILES
    with pytest.raises(ValueError, match="bodies"):
        k1.qp_launch_config(4, 7, 49, 8, 64, 16, 8, body="dmma")
    with pytest.raises(ValueError, match="bodies"):
        k1.qp_launch_config(8, 7, 49, 8, 64, 64, 4, body="dmma")
    with pytest.raises(ValueError, match="bodies"):
        k1.qp_launch_config(8, 7, 49, 8, 64, 16, 8, body="tf32")
    # the ring at b05 10^3 leaves no room for V of 8 planes
    with pytest.raises(ValueError, match="does not fit"):
        k1.qp_launch_config(8, 9, 81, 10, 100, None, 8)
    # DMMA's warps hold C12T for nrq <= 88 and nkj <= 128 only; staged,
    # it serves those shapes
    staged_only = r"where='regs' is not one of \('smem',\)"
    with pytest.raises(ValueError, match=staged_only):
        k1.qp_launch_config(8, 10, 100, 11, 121, 16, 4, body="dmma",
                            where="regs")
    with pytest.raises(ValueError, match=staged_only):
        k1.qp_launch_config(8, 8, 64, 9, 144, 16, 4, body="dmma",
                            where="regs")
    assert k1.qp_launch_config(8, 1, 90, 2, 100, 16, 4,
                               body="dmma").c12t == "smem"
    # C12T held by the DMMA body only, and in one of QP_C12T
    with pytest.raises(ValueError, match="body='simt'"):
        k1.qp_launch_config(8, 7, 49, 8, 64, 16, 8, where="regs")
    with pytest.raises(ValueError, match="where='l2'"):
        k1.qp_launch_config(8, 7, 49, 8, 64, 16, 8, body="dmma", where="l2")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16], ids=["f32", "f64",
                                                         "bf16"])
def test_qp_launch_counts_its_depth(fake_library, monkeypatch, dtype):
    """K1's launch path into the stand-in library: each launch counted
    once under build.key("qp_fused3d", dtype) and once in qp_depths under
    the depth it took, which the entry receives after the tile and plane
    group, with the block's threads."""
    from tpu_bench_torch.kernels import bwdtrans3d as k1

    monkeypatch.setattr(build, "smem_limits", lambda index: (232448, 233472))
    gen = torch.Generator().manual_seed(5)
    x, b0, c12t = (torch.randn(*s, generator=gen).to(dtype)
                   for s in ((7 * 49, 64), (7, 8), (64, 49)))
    key = build.key("qp_fused3d", dtype)
    rule = k1.qp_config(dtype.itemsize, 7, 49, 8, 64)
    threads = k1.QP_FORMS[dtype.itemsize][-1][1]
    for knobs, depth in (((None, None, None, None), rule.depth),
                         ((16, None, 2, threads), 2),
                         ((16, None, None, None), 1),
                         ((None, None, 1, None), 1)):
        launches, depths = build.launches[key], k1.qp_depths.copy()
        out = k1._launch(x, b0, c12t, 49, *knobs)
        assert build.launches[key] == launches + 1
        assert k1.qp_depths - depths == {depth: 1}
        name, args = fake_library.calls[-1]
        assert name == f"tbt_qp_fused3d_{build.SUFFIXES[dtype]}"
        assert args[3] == out.data_ptr() and args[-1] == 77
        assert args[-4] == depth and args[-3] in (256, 512)


@pytest.mark.parametrize("dtype,body,where", [
    (torch.float32, None, None), (torch.bfloat16, None, None),
    (torch.float64, None, None), (torch.float64, "simt", None),
    (torch.float64, "dmma", None), (torch.float64, "dmma", "smem"),
    (torch.float64, "dmma", "regs")],
    ids=["f32", "bf16", "f64", "f64-simt", "f64-dmma", "f64-dmma-smem",
         "f64-dmma-regs"])
def test_qp_launch_passes_and_counts_its_body(fake_library, monkeypatch,
                                              dtype, body, where):
    """K1's stage-2 body and C12T's place round-trip through the wrapper:
    the knobs (given at depth 1, where every pair fits at b05 8^3), or
    qp_config's choice (SIMT outside f64; C12T staged where the body
    differs from the choice's and no place is given), reach the
    entry as QP_ENTRY_BODIES' code just before the stream, after the
    QPConfig's other fields, and the launch is counted once in qp_bodies
    under (dtype, body) and, on DMMA, once in qp_dmma_c12t under C12T's
    place."""
    from tpu_bench_torch.kernels import bwdtrans3d as k1

    monkeypatch.setattr(build, "smem_limits", lambda index: (232448, 233472))
    gen = torch.Generator().manual_seed(6)
    x, b0, c12t = (torch.randn(*s, generator=gen).to(dtype)
                   for s in ((7 * 49, 64), (7, 8), (64, 49)))
    depth = 1 if body or where else None
    cfg = k1.qp_launch_config(dtype.itemsize, 7, 49, 8, 64, None, None,
                              depth=depth, body=body, where=where)
    rule = k1.qp_config(dtype.itemsize, 7, 49, 8, 64)
    same = body in (None, rule.body)
    assert cfg == rule._replace(depth=depth or rule.depth,
                                body=body or rule.body,
                                c12t=where or (rule.c12t if same else "smem"))
    if dtype != torch.float64:
        assert cfg.body == "simt"
    bodies, places = k1.qp_bodies.copy(), k1.qp_dmma_c12t.copy()
    k1._launch(x, b0, c12t, 49, None, None, depth, body=body, where=where)
    name, args = fake_library.calls[-1]
    assert name == f"tbt_qp_fused3d_{build.SUFFIXES[dtype]}"
    assert args[-6:-1] == (*cfg[:4], k1.QP_ENTRY_BODIES[cfg.body, cfg.c12t])
    assert k1.qp_bodies - bodies == {(build.SUFFIXES[dtype], cfg.body): 1}
    assert k1.qp_dmma_c12t - places == (
        {cfg.c12t: 1} if cfg.body == "dmma" else {})
