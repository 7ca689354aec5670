"""The launch path's spans and block counter (tpu_bench_torch/core/spans.py):
nothing while no profiler records; under torch.profiler the wrapper spans
of the benchmarked columns, tbt.alloc and tbt.launch.<kernel> nested in
them, each output's address in spans.blocks, and the launch still counted
once."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_package import fake_library  # noqa: F401 (a fixture)
from tpu_bench_torch.core import spans
from tpu_bench_torch.kernels import build
from tpu_bench_torch.kernels import bwdtrans2d as k2
from tpu_bench_torch.kernels import bwdtrans3d as k1

# b05 at nq = 3^3: nm0 = 2, nrq = 4, nq0 = 3, nkj = 9; E = 8 elements
NM0, NRQ, NQ0, NKJ, E = 2, 4, 3, 9, 8


def _k1_operands(dtype=torch.float32, device="cpu", e=E):
    gen = torch.Generator(device=device).manual_seed(3)
    return (torch.randn(NM0 * NRQ, e, generator=gen, dtype=dtype,
                        device=device),
            torch.randn(NM0, NQ0, generator=gen, dtype=dtype, device=device),
            torch.randn(NKJ, NRQ, generator=gen, dtype=dtype, device=device))


def _k2_operands():
    gen = torch.Generator().manual_seed(4)
    return (torch.randn(2, NM0 * NRQ, E, generator=gen),
            torch.randn(NQ0 * NKJ, NM0 * NRQ, generator=gen))


def _spans(prof) -> list:
    """(name, start_ns, end_ns) of the profiler's tbt.* events, by start."""
    events = prof.profiler.kineto_results.events()
    return sorted(((ev.name(), ev.start_ns(), ev.end_ns()) for ev in events
                   if ev.name().startswith("tbt.")), key=lambda sp: sp[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture
def no_blocks():
    """spans.blocks empty before the test and as it was after it."""
    kept = list(spans.blocks)
    spans.blocks.clear()
    yield spans.blocks
    spans.blocks.clear()
    spans.blocks.extend(kept)


@pytest.fixture
def k1_on_launch_path(monkeypatch, fake_library):  # noqa: F811
    """qp_shared3d_flat on CPU tensors through K1's launch path (_launch)
    into the stand-in library, at the H100's shared memory."""
    monkeypatch.setattr(build, "smem_limits", lambda index: (232448, 233472))
    monkeypatch.setattr(
        k1, "qp_shared3d_flat_plain",
        lambda x, b0, c12t, *, nrq: k1._launch(x, b0, c12t, nrq, None, None))
    return fake_library


def test_off_records_nothing(monkeypatch, no_blocks, k1_on_launch_path):
    """With no profiler, no span is entered on any site and no block is
    kept, on the plain path and on the launch path alike."""
    assert not spans.profiler._is_profiler_enabled
    entered = []
    monkeypatch.setattr(spans, "span", lambda name: entered.append(name))
    x, b0, c12t = _k1_operands()
    k1.qp_shared3d_flat(x, b0, c12t, nrq=NRQ)
    k2.kron_blocked(*_k2_operands())
    assert entered == [] and len(no_blocks) == 0
    assert k1_on_launch_path.calls  # the launch path ran


def test_flag_follows_the_profiler():
    """The flag the hot sites test is true exactly while a profiler
    records, as the C profiler's own state is."""
    def flags():
        return (spans.profiler._is_profiler_enabled,
                torch._C._autograd._profiler_enabled())

    assert flags() == (False, False)
    with profile(activities=[ProfilerActivity.CPU]):
        assert flags() == (True, True)
    assert flags() == (False, False)


@pytest.mark.parametrize("column", ["qp_shared3d_flat", "kron_blocked"])
def test_cpu_call_records_its_wrapper_span(column, no_blocks):
    """Under the profiler a CPU call of a benchmarked column records its
    wrapper span once; the plain path allocates under no tbt.alloc."""
    if column == "qp_shared3d_flat":
        x, b0, c12t = _k1_operands()
        call = lambda: k1.qp_shared3d_flat(x, b0, c12t, nrq=NRQ)  # noqa
    else:
        call = lambda: k2.kron_blocked(*_k2_operands())  # noqa
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.profiler._is_profiler_enabled
        call()
    assert not spans.profiler._is_profiler_enabled
    assert [sp[0] for sp in _spans(prof)] == [f"tbt.{column}"]
    assert len(no_blocks) == 0


def test_launch_span_nested_in_the_wrapper(k1_on_launch_path, no_blocks):
    """K1's launch path under the profiler: tbt.alloc, then
    tbt.launch.qp_fused3d, both inside tbt.qp_shared3d_flat; the output's
    address kept in spans.blocks under the launch's key; the launch (of
    K1's probe entry) counted once and passed the output's address."""
    x, b0, c12t = _k1_operands()
    before = build.launches["qp_fused3d"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = k1.qp_shared3d_flat(x, b0, c12t, nrq=NRQ)
    wrapper, alloc, launch = _spans(prof)
    assert [wrapper[0], alloc[0], launch[0]] == [
        "tbt.qp_shared3d_flat", "tbt.alloc", "tbt.launch.qp_fused3d"]
    assert _inside(alloc, wrapper) and _inside(launch, wrapper)
    assert alloc[2] <= launch[1]
    assert build.launches["qp_fused3d"] == before + 1
    name, args = k1_on_launch_path.calls[-1]
    assert name == "tbt_qp_fused3d_probe_f32" and args[3] == out.data_ptr()
    assert list(no_blocks) == [("qp_fused3d", out.data_ptr())]
    assert out.shape == (NQ0 * NKJ, E)


def test_launch_span_names_the_counted_kernel(fake_library,  # noqa: F811
                                              no_blocks):
    """build.run's span carries the key build.launches counts, _bf16
    appended for a bf16 call; each launch counted once."""
    counted = ("map2_inplace", "qp_fused3d_bf16")
    before = [build.launches[n] for n in counted]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        build.run("map2_inplace", torch.zeros(4), 1)
        build.run("qp_fused3d", torch.zeros(4, dtype=torch.bfloat16), 2)
    assert [sp[0] for sp in _spans(prof)] == [f"tbt.launch.{n}"
                                              for n in counted]
    assert [build.launches[n] - b for n, b in zip(counted, before)] == [1, 1]
    assert len(no_blocks) == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_blocks_name_the_launch_key(dtype, k1_on_launch_path, no_blocks,
                                    monkeypatch):
    """K1's and K2's outputs go into spans.blocks under the key
    build.launches counts their launch under (_bf16 for a bf16 call)."""
    monkeypatch.setattr(k2, "kron_blocked_plain",
                        lambda x, c: k2._launch(x, c, None))
    x, b0, c12t = (t.to(dtype) for t in _k1_operands())
    in_blk, c = (t.to(dtype) for t in _k2_operands())
    with profile(activities=[ProfilerActivity.CPU]):
        out1 = k1.qp_shared3d_flat(x, b0, c12t, nrq=NRQ)
        out2 = k2.kron_blocked(in_blk, c)
    suffix = "_bf16" if dtype is torch.bfloat16 else ""
    assert list(no_blocks) == [(f"qp_fused3d{suffix}", out1.data_ptr()),
                               (f"kron_blocked{suffix}", out2.data_ptr())]
    tag = "bf16" if suffix else "f64"
    assert [name for name, _ in k1_on_launch_path.calls[-2:]] == [
        f"tbt_qp_fused3d_probe_{tag}", f"tbt_kron_blocked_{tag}"]


def test_profiled_k1_launches_the_probe_entry(k1_on_launch_path,
                                               no_blocks, monkeypatch):
    """K1 under the profiler launches tbt_qp_fused3d_probe_<dtype>: K1's
    arguments, then its device's probe buffer (made, zeroed, inside the
    call's tbt.qp_shared3d_flat span on the first probed launch), the
    launch's number and the buffer's block records.  Without a profiler
    K1 launches tbt_qp_fused3d_<dtype> with K1's arguments alone and makes
    no buffer."""
    monkeypatch.setattr(k1, "qp_probes", {})
    x, b0, c12t = _k1_operands()
    k1.qp_shared3d_flat(x, b0, c12t, nrq=NRQ)
    name, plain = k1_on_launch_path.calls[-1]
    assert name == "tbt_qp_fused3d_f32" and len(plain) == 15
    assert k1.qp_probes == {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            k1.qp_shared3d_flat(x, b0, c12t, nrq=NRQ)
    calls = k1_on_launch_path.calls[-2:]
    probe = k1.qp_probes[x.get_device()]
    assert probe.launches == 2
    for n, (name, args) in enumerate(calls):
        assert name == "tbt_qp_fused3d_probe_f32"
        assert args[:3] == plain[:3] and args[4:14] == plain[4:14]
        assert args[-1] == plain[-1]
        assert args[14:17] == (probe.words.data_ptr(), n, probe.capacity)
    wrapper = next(sp for sp in _spans(prof)
                   if sp[0] == "tbt.qp_shared3d_flat")
    zeros = [(ev.name(), ev.start_ns(), ev.end_ns())
             for ev in prof.profiler.kineto_results.events()
             if ev.name() == "aten::zeros"]
    assert zeros and all(_inside(z, wrapper) for z in zeros)


def test_blocks_keeps_its_bound(no_blocks):
    """spans.blocks holds at least 2^18 addresses, the newest."""
    bound = no_blocks.maxlen
    assert bound is not None and bound >= 2**18
    no_blocks.extend(range(bound + 5))
    assert len(no_blocks) == bound
    assert no_blocks[0] == 5 and no_blocks[-1] == bound + 4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_on_card_records_its_block(dtype, no_blocks):
    """A real K1 call under the profiler: tbt.alloc and
    tbt.launch.qp_fused3d inside its wrapper span, the output's address in
    spans.blocks, K1's device record after the launch, and the output
    within 1e-5 (f32) or 1e-12 (f64) of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, b0, c12t = _k1_operands(dtype, "cuda")
    k1.qp_shared3d_flat(x, b0, c12t, nrq=NRQ)  # build and load first
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        out = k1.qp_shared3d_flat(x, b0, c12t, nrq=NRQ)
        torch.cuda.synchronize()
    wrapper, alloc, launch = _spans(prof)
    assert [wrapper[0], alloc[0], launch[0]] == [
        "tbt.qp_shared3d_flat", "tbt.alloc", "tbt.launch.qp_fused3d"]
    assert _inside(alloc, wrapper) and _inside(launch, wrapper)
    assert list(no_blocks) == [("qp_fused3d", out.data_ptr())]
    kernels = [ev for ev in prof.profiler.kineto_results.events()
               if "qp_fused3d_kernel" in ev.name()]
    assert len(kernels) == 1 and kernels[0].start_ns() >= launch[1]
    plain = k1.qp_shared3d_flat_plain(x, b0, c12t, nrq=NRQ)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert (out - plain).abs().max() <= tol * plain.abs().max()


@pytest.mark.cuda
def test_k1_cache_miss_mallocs_inside_its_alloc_span(no_blocks):
    """After torch.cuda.empty_cache() a K1 call's output (1.8 MB, torch's
    large pool) misses the caching allocator: the profiler records its
    cudaMalloc inside the call's tbt.alloc span, where device_allocs
    counts it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, b0, c12t = _k1_operands(torch.float32, "cuda", e=16384)
    k1.qp_shared3d_flat(x, b0, c12t, nrq=NRQ)  # build, load, cache a block
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        out = k1.qp_shared3d_flat(x, b0, c12t, nrq=NRQ)
        torch.cuda.synchronize()
    (alloc,) = [sp for sp in _spans(prof) if sp[0] == "tbt.alloc"]
    mallocs = [(ev.name(), ev.start_ns(), ev.end_ns())
               for ev in prof.profiler.kineto_results.events()
               if ev.name().startswith("cudaMalloc")]
    assert any(_inside(m, alloc) for m in mallocs), (alloc, mallocs)
    assert list(no_blocks) == [("qp_fused3d", out.data_ptr())]
