"""The reductions from a trace and a window to metrics, on made-up
records."""

import pytest

from port_bench import roofline, spec, trace
from port_bench.run import Run

MS = 1_000_000  # ns


def _trace():
    return trace.Trace(
        window=(0, 10 * MS),
        device=[("void qp_fused3d_kernel<float, 32, 4>(...)", 1 * MS, 3 * MS),
                ("void qp_fused3d_kernel<float, 32, 4>(...)", 3 * MS, 5 * MS),
                ("memset", 4 * MS, 6 * MS),
                ("void dense_gemm_kernel<float, NFast>(...)", 8 * MS,
                 9 * MS)],
        host=[("aten::empty", 0, 1 * MS), ("cudaEventSynchronize",
                                           5 * MS, 8 * MS),
              ("python", 5 * MS, 9 * MS)])


def _run(**kw):
    base = dict(config={"operation": "b05", "nq": [8, 8, 8],
                        "nelmt": 131072, "dtype": "float32"},
                op=spec.load("operations", "b05"), calls=4, window_s=2.0,
                call_ms=[1.0, 2.0, 3.0, 4.0], enqueue_ns=[1000, 3000, 2000],
                setup_s=5.0, library_s=0.25)
    base.update(kw)
    return Run(**base)


def test_busy_gaps_and_idle():
    t = _trace()
    assert trace.busy(t) == [(1 * MS, 6 * MS), (8 * MS, 9 * MS)]
    assert trace.busy_s(t) == pytest.approx(6e-3)
    assert trace.gaps(t) == [(0, 1 * MS), (6 * MS, 8 * MS),
                             (9 * MS, 10 * MS)]
    idle = spec.load("metrics", "device_idle_pct").read(_run(trace=t))
    assert idle == pytest.approx(40.0)


def test_breakdown():
    t = _trace()
    ops = trace.device_ops(t)
    assert ops[0] == ["void qp_fused3d_kernel<float, 32, 4>(...)",
                      pytest.approx(4e-3)]
    gaps = trace.idle_gaps(t)
    assert gaps[0] == ["cudaEventSynchronize", pytest.approx(2e-3)]
    assert len(gaps) == 3


def test_roofline_share_reads_only_its_kernels():
    t = _trace()
    run = _run(trace=t, traced_calls=2)
    k1 = spec.load("metrics", "qp_fused3d_roofline").read(run)
    least = roofline.least_s(run.op, run.config)
    assert k1 == pytest.approx(100 * least / 2e-3)
    # K3's dense body (NFast) is not K2's
    assert spec.load("metrics", "kron_blocked_roofline").read(run) is None
    assert spec.load("metrics", "qp_fused3d_roofline").read(_run()) is None


def test_window_readers():
    run = _run()
    gdof = spec.load("metrics", "gdof_s").read(run)
    assert gdof == pytest.approx(1e-9 * 131072 * 343 * 4 / 2.0)
    p95 = spec.load("metrics", "call_ms_p95").read(run)
    assert 3.0 < p95 <= 4.0
    assert spec.load("metrics", "enqueue_us").read(run) == 2.0
    assert spec.load("metrics", "setup_s").read(run) == 5.0
    assert spec.load("metrics", "library_s").read(run) == 0.25
    assert spec.load("metrics", "device_idle_pct").read(run) is None
