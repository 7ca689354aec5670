"""qp_tf32_pct, the reader of K1's launches by dtype and stage-2 body
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
    return spec.load("metrics", "qp_tf32_pct").read(_run())


def test_every_f32_launch_on_tf32_reads_100(monkeypatch):
    """hex8-f32-qp, whose K1 runs stage 2 on wgmma."""
    assert _read({("f32", "tf32"): 5800}, monkeypatch) == 100.0


@pytest.mark.parametrize("bodies", [
    {("f32", "simt"): 9100}, {("f64", "dmma"): 674},
    {("bf16", "hmma"): 731}, {("bf16", "simt"): 12}],
    ids=["f32-simt", "f64-dmma", "bf16-hmma", "bf16-simt"])
def test_launches_off_tf32_read_0(bodies, monkeypatch):
    """The six other qp cells: an f32 shape the sweep left on SIMT
    (quad8-f32-qp), f64 on DMMA and bf16 on HMMA or SIMT; and the parent
    tree's hex8-f32-qp, whose K1 counts ("f32", "simt")."""
    assert _read(bodies, monkeypatch) == 0.0


def test_mixed_launches_read_the_tf32_share(monkeypatch):
    assert _read({("f32", "tf32"): 1, ("f32", "simt"): 2,
                  ("f64", "dmma"): 1}, monkeypatch) == pytest.approx(25.0)


def test_empty_counter_reads_none(monkeypatch):
    assert _read({}, monkeypatch) is None


def test_program_without_the_counter_reads_none(monkeypatch):
    """A program whose K1 keeps no qp_bodies reads None, and does not
    raise."""
    monkeypatch.delattr(bwdtrans3d, "qp_bodies")
    assert spec.load("metrics", "qp_tf32_pct").read(_run()) is None


def test_entry_is_the_qp_cells_of_the_hand_kernels_layer():
    [entry] = [m for m in spec.benchmark()["per_layer"]
               if m["name"] == "qp_tf32_pct"]
    assert entry == {"name": "qp_tf32_pct", "unit": "%", "better": "higher",
                     "source": "program_counter", "layer": "hand kernels",
                     "moves": "gdof_s",
                     "workloads": ["hex8-f32-qp", "hex8-f64-qp",
                                   "hex10-f64-qp", "quad8-f32-qp",
                                   "quad32-f64-qp", "hex8-bf16-qp",
                                   "quad8-bf16-qp"]}
