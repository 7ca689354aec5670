"""qp_s1_dmma_pct, the reader of K1's launches by dtype and stage-1 body
(tpu_bench_torch/kernels/bwdtrans3d.qp_stage1_bodies), on made-up
counts."""

import collections

import pytest

from port_bench import spec
from port_bench.run import Run
from tpu_bench_torch.kernels import bwdtrans3d


def _run():
    return Run(config={}, op=None, calls=0, window_s=1.0, call_ms=[],
               enqueue_ns=[], setup_s=1.0, library_s=None)


def _read(bodies, monkeypatch):
    monkeypatch.setattr(bwdtrans3d, "qp_stage1_bodies",
                        collections.Counter(bodies))
    return spec.load("metrics", "qp_s1_dmma_pct").read(_run())


def test_every_f64_launch_with_stage_1_on_dmma_reads_100(monkeypatch):
    """quad32-f64-qp, whose K1 runs stage 1 on DMMA."""
    assert _read({("f64", "dmma"): 674}, monkeypatch) == 100.0


@pytest.mark.parametrize("bodies", [
    {("f64", "simt"): 674}, {("f32", "simt"): 9100},
    {("bf16", "simt"): 731}],
    ids=["f64-simt", "f32-simt", "bf16-simt"])
def test_launches_with_stage_1_off_dmma_read_0(bodies, monkeypatch):
    """The six other qp cells: f64 shapes that keep the SIMT stage 1
    (hex8-f64-qp, hex10-f64-qp), and f32 and bf16, which have no DMMA."""
    assert _read(bodies, monkeypatch) == 0.0


def test_mixed_launches_read_the_dmma_share(monkeypatch):
    assert _read({("f64", "dmma"): 1, ("f64", "simt"): 2,
                  ("f32", "simt"): 1}, monkeypatch) == pytest.approx(25.0)


def test_empty_counter_reads_none(monkeypatch):
    assert _read({}, monkeypatch) is None


def test_program_without_the_counter_reads_none(monkeypatch):
    """A program whose K1 keeps no qp_stage1_bodies, as the tree before
    the DMMA stage 1, reads None, and does not raise."""
    monkeypatch.delattr(bwdtrans3d, "qp_stage1_bodies")
    assert spec.load("metrics", "qp_s1_dmma_pct").read(_run()) is None


def test_entry_is_the_qp_cells_of_the_hand_kernels_layer():
    [entry] = [m for m in spec.benchmark()["per_layer"]
               if m["name"] == "qp_s1_dmma_pct"]
    assert entry == {"name": "qp_s1_dmma_pct", "unit": "%",
                     "better": "higher", "source": "program_counter",
                     "layer": "hand kernels", "moves": "gdof_s",
                     "workloads": ["hex8-f32-qp", "hex8-f64-qp",
                                   "hex10-f64-qp", "quad8-f32-qp",
                                   "quad32-f64-qp", "hex8-bf16-qp",
                                   "quad8-bf16-qp"]}
