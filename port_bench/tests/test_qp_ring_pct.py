"""qp_ring_pct, the reader of K1's launches by depth
(tpu_bench_torch/kernels/bwdtrans3d.qp_depths), on made-up counts."""

import collections

import pytest

from port_bench import spec
from port_bench.run import Run
from tpu_bench_torch.kernels import bwdtrans3d


def _read(depths, monkeypatch):
    monkeypatch.setattr(bwdtrans3d, "qp_depths", collections.Counter(depths))
    run = Run(config={}, op=None, calls=0, window_s=1.0, call_ms=[],
              enqueue_ns=[], setup_s=1.0, library_s=None)
    return spec.load("metrics", "qp_ring_pct").read(run)


def test_every_launch_on_the_ring_reads_100(monkeypatch):
    assert _read({2: 691}, monkeypatch) == 100.0


def test_depth_1_launches_only_read_0(monkeypatch):
    assert _read({1: 1800}, monkeypatch) == 0.0


def test_mixed_launches_read_the_ring_share(monkeypatch):
    assert _read({1: 3, 2: 1}, monkeypatch) == pytest.approx(25.0)


def test_empty_counter_reads_none(monkeypatch):
    assert _read({}, monkeypatch) is None
