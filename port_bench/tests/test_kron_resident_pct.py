"""kron_resident_pct, the reader of K2's launches by dtype and strip
(tpu_bench_torch/kernels/bwdtrans2d.kron_strips), on made-up counts, and
the counter itself: one launch of K2 counted under the strip it ran."""

import collections

import pytest
import torch

from port_bench import spec
from port_bench.run import Run
from tpu_bench_torch.kernels import build
from tpu_bench_torch.kernels import bwdtrans2d as k2


def _read(strips, monkeypatch):
    monkeypatch.setattr(k2, "kron_strips", collections.Counter(strips))
    run = Run(config={}, op=None, calls=0, window_s=1.0, call_ms=[],
              enqueue_ns=[], setup_s=1.0, library_s=None)
    return spec.load("metrics", "kron_resident_pct").read(run)


def test_every_launch_resident_reads_100(monkeypatch):
    assert _read({("f32", 64): 691}, monkeypatch) == 100.0


def test_dense_launches_read_0(monkeypatch):
    assert _read({("f32", 0): 300, ("f64", 0): 1800}, monkeypatch) == 0.0


def test_mixed_launches_read_the_resident_share(monkeypatch):
    assert _read({("f32", 64): 1, ("f64", 256): 2, ("f32", 0): 5},
                 monkeypatch) == pytest.approx(37.5)


def test_empty_counter_reads_none(monkeypatch):
    assert _read({}, monkeypatch) is None


@pytest.mark.parametrize("dtype,shape,c_rows,strip,counted", [
    (torch.float32, (2, 49, 256), 64, None, ("f32", 64)),
    (torch.float64, (2, 49, 256), 64, None, ("f64", 64)),
    (torch.float32, (2, 49, 256), 64, 128, ("f32", 128)),
    (torch.float32, (2, 49, 256), 64, 0, ("f32", 0)),
    (torch.float32, (1, 343, 256), 512, None, ("f32", 0))],
    ids=["b04-rule", "b04-rule-f64", "b04-strip-128", "b04-dense",
         "b05-rule"])
def test_launch_counts_the_strip_it_passed(monkeypatch, dtype, shape, c_rows,
                                           strip, counted):
    """_launch counts each launch once, under the strip it hands the
    kernel: kron_config's where none is given (64 for b04 8^2's C, 64 x
    49; dense, 0, for b05 8^3's 512 x 343), else the one given."""
    calls = []
    monkeypatch.setattr(build, "run", lambda *args: calls.append(args))
    monkeypatch.setattr(build, "smem_limits",
                        lambda index: (232448, 233472))
    monkeypatch.setattr(k2, "kron_strips", collections.Counter())
    x = torch.zeros(shape, dtype=dtype)
    c = torch.zeros(c_rows, shape[1], dtype=dtype)
    k2._launch(x, c, strip)
    assert len(calls) == 1 and calls[0][-2] == counted[1]
    assert k2.kron_strips == {counted: 1}
