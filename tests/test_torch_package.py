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
                                         "stream_probes.cu", "ozaki.cu"}
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
    (729, 1000, 1000, 11, 9), (343, 512, 999, 9, 9)])
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
    order nq (chip_smoke.config_operands' shapes)."""
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
    and b04 order."""
    from tpu_bench_torch.kernels import bwdtrans2d as k2
    from tpu_bench_torch.kernels import bwdtrans3d as k1

    (nm0, nrq, nq0, nkj), kron, em = _order_products(nq)
    rule = k1.qp_config.__wrapped__(itemsize, nm0, nrq, nq0, nkj)
    for _ in range(2):
        assert k1.qp_config(itemsize, nm0, nrq, nq0, nkj) == rule
    if rule is not None:
        assert k1.qp_launch_config(itemsize, nm0, nrq, nq0, nkj, None,
                                   None) == rule
        tile = k1.QP_TILES[itemsize][-1]
        assert k1.qp_launch_config(itemsize, nm0, nrq, nq0, nkj, tile,
                                   None) == (tile, k1.qp_planes(tile, nkj))
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
