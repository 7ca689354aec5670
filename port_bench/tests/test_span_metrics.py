"""The readers of the launch path's spans and block counter
(tpu_bench_torch/core/spans.py), on made-up traces."""

import sys

import pytest

from port_bench import spec, trace
from port_bench.run import Run
from tpu_bench_torch.core import spans

US = 1_000  # ns
K1 = "void qp_fused3d_kernel<double, 16, 8>(...)"
K2 = "void dense_gemm_kernel<double, MFast>(...)"
K4 = "void qp_stage2_kernel<double>(...)"


def _run(t, calls):
    return Run(config={}, op=None, calls=calls, window_s=1.0, call_ms=[],
               enqueue_ns=[], setup_s=1.0, library_s=None, trace=t,
               traced_calls=calls)


def _read(name, run):
    return spec.load("metrics", name).read(run)


def _calls(n, at=100 * US, every=50 * US, free=()):
    """Host events of n calls of K1's column: the wrapper span over the
    alloc and launch spans, with a cudaFree (then a cudaMalloc) inside the
    alloc span of each call in `free`."""
    host = []
    for c in range(n):
        t = at + c * every
        host += [("tbt.qp_shared3d_flat", t, t + 20 * US),
                 ("tbt.alloc", t + 5 * US, t + 8 * US),
                 ("aten::empty", t + 5 * US, t + 8 * US),
                 ("tbt.launch.qp_fused3d", t + 10 * US, t + 16 * US),
                 ("cudaLaunchKernel", t + 12 * US, t + 15 * US)]
        if c in free:
            host += [("cudaFree", t + 6 * US, t + 7 * US),
                     ("cudaMalloc", t + 7 * US, t + 8 * US)]
    return host


def _trace(host, device=(), window=(0, 10_000 * US)):
    return trace.Trace(window=window, device=sorted(device,
                                                    key=lambda d: d[1]),
                       host=sorted(host, key=lambda h: h[1]))


@pytest.fixture
def blocks():
    kept = list(spans.blocks)
    spans.blocks.clear()
    yield spans.blocks
    spans.blocks.clear()
    spans.blocks.extend(kept)


def test_span_durations():
    """call_us, alloc_us and launch_us: medians of their spans in µs."""
    host = _calls(5)
    host[0] = ("tbt.qp_shared3d_flat", 100 * US, 150 * US)  # a slow call
    run = _run(_trace(host), 5)
    assert _read("call_us", run) == 20.0
    assert _read("alloc_us", run) == 3.0
    assert _read("launch_us", run) == 6.0


def test_call_us_takes_top_level_spans_inside_the_window():
    """A wrapper span inside another (kron_blocked under a column's own
    wrapper) is not a call; spans cut by the window's edges are left out."""
    host = _calls(3) + [
        ("tbt.kron_blocked", 101 * US, 110 * US),
        ("tbt.qp_shared3d_flat", 0, 30 * US),  # cut at the window's start
        ("tbt.qp_shared3d_flat", 9_990 * US, 10_000 * US)]  # at its end
    run = _run(_trace(host), 3)
    assert _read("call_us", run) == 20.0


def test_no_spans_read_none(blocks):
    """A program that records no span (an earlier tree), or an untraced
    run: every reader gives None and none raises."""
    host = [("aten::empty", 10 * US, 20 * US),
            ("cudaMalloc", 11 * US, 12 * US)]
    device = [(K1, 30 * US, 40 * US)]
    for run in (_run(_trace(host, device), 1), _run(None, 1)):
        for name in ("call_us", "alloc_us", "launch_us", "device_allocs",
                     "out_block_spread_pct"):
            assert _read(name, run) is None, name


def test_spans_of_one_stage_read_none():
    """A column whose entry records no span and calls a spanned wrapper
    for its first stage only (K2's workspace, then K4 launched outside
    it): the wrapper span is not the call, and no launch-path reader
    gives a number."""
    host = []
    for c in range(6):
        t = 100 * US + c * 50 * US
        host += [("tbt.kron_blocked", t, t + 20 * US),
                 ("tbt.alloc", t + 5 * US, t + 8 * US),
                 ("tbt.launch.kron_blocked", t + 10 * US, t + 16 * US),
                 ("cudaLaunchKernel", t + 12 * US, t + 15 * US),
                 ("aten::empty", t + 22 * US, t + 25 * US),
                 ("cudaLaunchKernel", t + 30 * US, t + 33 * US)]
    run = _run(_trace(host), 6)
    for name in ("call_us", "alloc_us", "launch_us", "device_allocs"):
        assert _read(name, run) is None, name


def test_launch_without_a_spanned_output():
    """A call whose second launch writes an output not allocated under
    tbt.alloc: call_us and launch_us read, alloc_us and device_allocs,
    which would see part of the call's allocations, do not."""
    host = _calls(4)
    for c in range(4):
        t = 100 * US + c * 50 * US
        host.append(("tbt.launch.qp_stage2", t + 16 * US, t + 19 * US))
    run = _run(_trace(host), 4)
    assert _read("call_us", run) == 20.0
    assert _read("launch_us", run) == 4.5
    assert _read("alloc_us", run) is None
    assert _read("device_allocs", run) is None


def test_device_allocs_counts_only_inside_alloc_spans():
    """cudaFree and cudaMalloc inside tbt.alloc count; the same calls
    elsewhere (the window's own synchronize, the check) do not."""
    host = _calls(8, free={2})
    host += [("cudaFree", 50 * US, 60 * US),  # before any alloc span
             ("cudaFree", 100 * US + 9 * US, 100 * US + 9500),  # between
             ("cudaMallocHost", 5_000 * US, 5_001 * US)]  # after the last
    run = _run(_trace(host), 8)
    assert _read("device_allocs", run) == pytest.approx(1000 * 2 / 8)
    assert _read("device_allocs", _run(_trace(_calls(8)), 8)) == 0.0


def _blocked(n, block_of, ns_of, skip=()):
    """A trace of n calls, call c writing block block_of(c) and K1 taking
    ns_of(c) (no record for a call in `skip`); a short kernel of another
    name between calls; spans.blocks as the program fills it."""
    device = []
    for c in range(n):
        t = 1_000 * US + c * 100 * US
        if c not in skip:
            device.append((K1, t, t + ns_of(c)))
        device.append(("memset", t + 90 * US, t + 91 * US))
        spans.blocks.append(("qp_fused3d", block_of(c)))
    return _trace(_calls(n), device)


def test_out_block_spread_pairs_blocks_with_device_records(blocks):
    """Call n's block with K1's n-th record: block A at 60 µs, B at 66 µs
    (10% slower), C with too few calls to count."""
    spans.blocks.extend([("qp_fused3d", 7)] * 3)  # calls before the window
    times = {0xA: 60 * US, 0xB: 66 * US, 0xC: 90 * US}

    def block_of(c):
        return 0xC if c in (0, 1) else (0xA, 0xB)[c % 2]

    t = _blocked(22, block_of, lambda c: times[block_of(c)])
    assert _read("out_block_spread_pct", _run(t, 22)) == pytest.approx(10.0)


def test_out_block_spread_leaves_out_blocks_of_part_of_the_window(blocks):
    """A block written only in the window's first half (taken out of the
    rotation by the sample) or only from its middle on (handed back) does
    not count, however many calls it has: the card ran slower in the
    window's second half, on every block alike."""
    def block_of(c):
        if c % 3 == 2:
            return 0xA if c < 30 else 0xB
        return c % 3

    t = _blocked(60, block_of, lambda c: 50 * US + (c >= 30) * 5 * US)
    assert _read("out_block_spread_pct", _run(t, 60)) == pytest.approx(0.0)


def test_out_block_spread_none_where_counts_disagree(blocks):
    """One block a launch is the pairing: a device record fewer than the
    blocks, fewer blocks kept than the window's tbt.alloc spans, or too
    few blocks to compare, gives None."""
    t = _blocked(12, lambda c: c % 2, lambda c: 50 * US)
    assert _read("out_block_spread_pct", _run(t, 12)) == pytest.approx(0.0)
    spans.blocks.pop()
    assert _read("out_block_spread_pct", _run(t, 12)) is None
    spans.blocks.clear()
    short = _blocked(12, lambda c: c % 2, lambda c: 50 * US, skip={5})
    assert _read("out_block_spread_pct", _run(short, 12)) is None
    spans.blocks.clear()
    one = _blocked(12, lambda c: 5, lambda c: 50 * US)
    assert _read("out_block_spread_pct", _run(one, 12)) is None


def test_out_block_spread_pairs_only_the_main_kernels_launches(blocks):
    """Each call allocates K2's workspace, then K1's output, under
    tbt.alloc: K1's records pair with K1's blocks alone.  Where the main
    kernel is one no block's launch key runs (K4 writing an output not
    allocated under a span), or one the key does not run, None."""
    def calls(n, main):
        device = []
        for c in range(n):
            t = 1_000 * US + c * 100 * US
            device += [(K2, t, t + 10 * US),
                       (main, t + 10 * US, t + 10 * US + (55, 50)[c % 2] * US)]
            spans.blocks.extend([("kron_blocked", 0xF0 + c % 3),
                                 ("qp_fused3d", c % 2)])
        host = []
        for name, s, e in _calls(n):
            host.append((name, s, e))
            if name == "tbt.alloc":
                host.append(("tbt.alloc", s - 4 * US, s - 2 * US))
        return _trace(host, device)

    assert _read("out_block_spread_pct",
                 _run(calls(20, K1), 20)) == pytest.approx(10.0)
    spans.blocks.clear()
    assert _read("out_block_spread_pct", _run(calls(20, K4), 20)) is None
    spans.blocks.clear()
    t = calls(20, K1)
    for i, (_, block) in enumerate(spans.blocks):
        spans.blocks[i] = ("kron_blocked", block)
    assert _read("out_block_spread_pct", _run(t, 20)) is None


def test_out_block_spread_none_without_spans_module(monkeypatch, blocks):
    """An earlier tree has no tpu_bench_torch/core/spans.py: None."""
    import tpu_bench_torch.core

    t = _blocked(12, lambda c: c % 2, lambda c: 50 * US)
    assert _read("out_block_spread_pct", _run(t, 12)) == pytest.approx(0.0)
    monkeypatch.delattr(tpu_bench_torch.core, "spans")
    monkeypatch.setitem(sys.modules, "tpu_bench_torch.core.spans", None)
    assert _read("out_block_spread_pct", _run(t, 12)) is None


def test_traced_cpu_run_reads_the_wrapper_span():
    """A traced run of a cell's column on the CPU (the plain version under
    its wrapper span) carries call_us; nothing is allocated under
    tbt.alloc there."""
    from port_bench.tests.test_run import _cell, _run as run_cell

    result = run_cell(_cell("qp_shared"), traced=True)
    assert result["metrics"]["call_us"]["value"] > 0
    assert result["metrics"]["call_us"]["unit"] == "us"
    assert "alloc_us" not in result["metrics"]


@pytest.mark.cuda
def test_readers_on_the_card_count_a_cache_miss(blocks):
    """K1 calls in a window annotated as run.py annotates its own, torch's
    cache emptied before the third: trace.read carries the profiler's
    cudaMalloc inside that call's tbt.alloc span, device_allocs reads it,
    and the other launch-path readers read numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from tpu_bench_torch.kernels import bwdtrans3d as k1

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(5)
    # b05 at nq = 3^3, 16384 elements: a 1.8 MB output, torch's large pool
    x, b0, c12t = (torch.randn(*shape, generator=gen, device="cuda")
                   for shape in ((8, 16384), (2, 3), (9, 4)))

    def call():
        return k1.qp_shared3d_flat(x, b0, c12t, nrq=4)

    call()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        with record_function(trace.WINDOW):
            held = [call(), call()]
            torch.cuda.synchronize()
            del held
            torch.cuda.empty_cache()
            held = [call(), call()]
            torch.cuda.synchronize()
    run = _run(trace.read(prof), 4)
    assert _read("device_allocs", run) >= 250.0
    for name in ("call_us", "alloc_us", "launch_us"):
        assert _read(name, run) > 0, name
