"""kron_wgmma_pct, the reader of K2's dense launches by dtype and body
(tpu_bench_torch/kernels/bwdtrans2d.dense_bodies), on made-up counts."""

import collections

import pytest

from port_bench import spec
from port_bench.run import Run
from tpu_bench_torch.kernels import bwdtrans2d


def _read(bodies, monkeypatch):
    monkeypatch.setattr(bwdtrans2d, "dense_bodies",
                        collections.Counter(bodies))
    run = Run(config={}, op=None, calls=0, window_s=1.0, call_ms=[],
              enqueue_ns=[], setup_s=1.0, library_s=None)
    return spec.load("metrics", "kron_wgmma_pct").read(run)


def test_every_f32_launch_on_wgmma_reads_100(monkeypatch):
    assert _read({("f32", "wgmma"): 691}, monkeypatch) == 100.0


def test_f64_launches_read_0(monkeypatch):
    assert _read({("f64", "mma"): 1800}, monkeypatch) == 0.0


def test_mixed_launches_read_the_wgmma_share(monkeypatch):
    assert _read({("f32", "wgmma"): 1, ("f32", "mma"): 2,
                  ("bf16", "mma"): 1}, monkeypatch) == pytest.approx(25.0)


def test_empty_counter_reads_none(monkeypatch):
    assert _read({}, monkeypatch) is None
