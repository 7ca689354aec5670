"""qp_dmma_pct, the reader of K1's launches by dtype and stage-2 body
(tpu_bench_torch/kernels/bwdtrans3d.qp_bodies), on made-up counts."""

import collections

import pytest

from port_bench import spec
from port_bench.run import Run
from tpu_bench_torch.kernels import bwdtrans3d


def _run():
    return Run(config={}, op=None, calls=0, window_s=1.0, call_ms=[],
               enqueue_ns=[], setup_s=1.0, library_s=None)


def _read(bodies, monkeypatch):
    monkeypatch.setattr(bwdtrans3d, "qp_bodies", collections.Counter(bodies))
    return spec.load("metrics", "qp_dmma_pct").read(_run())


def test_every_f64_launch_on_dmma_reads_100(monkeypatch):
    assert _read({("f64", "dmma"): 674}, monkeypatch) == 100.0


def test_f32_launches_read_0(monkeypatch):
    assert _read({("f32", "simt"): 5800}, monkeypatch) == 0.0


def test_mixed_launches_read_the_dmma_share(monkeypatch):
    assert _read({("f64", "dmma"): 1, ("f64", "simt"): 2,
                  ("bf16", "simt"): 1}, monkeypatch) == pytest.approx(25.0)


def test_empty_counter_reads_none(monkeypatch):
    assert _read({}, monkeypatch) is None


def test_program_without_the_counter_reads_none(monkeypatch):
    """A program whose K1 keeps no qp_bodies (the tree before the DMMA
    body) reads None, and does not raise."""
    monkeypatch.delattr(bwdtrans3d, "qp_bodies")
    assert spec.load("metrics", "qp_dmma_pct").read(_run()) is None
