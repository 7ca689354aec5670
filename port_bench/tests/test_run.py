"""One run of a cell driven on the CPU past the look for a card: the
result line, and `correct` false under each fault the cells can have."""

import json
import os
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

from port_bench import run, spec, window

CPU = torch.device("cpu")
PATHS = ("qp_shared", "kron_blocked")


def _cell(path, dtype="float32", limit=1e-5, nelmt=256):
    config = {"operation": "b05", "nq": [8, 8, 8], "nelmt": nelmt,
              "dtype": dtype, "limits": {"max_err": limit}}
    bench = spec.benchmark()
    return spec.Cell(name="test", chips=1, config=config,
                     traffic={"path": path},
                     end_to_end=bench["end_to_end"],
                     per_layer=[m for m in bench["per_layer"]
                                if "workloads" not in m])


def _run(cell, traced=False, seed=2**34 + 9):
    return run.run_cell(cell, seed, 0.05, traced, CPU, time.perf_counter())


@pytest.mark.parametrize("path", PATHS)
def test_sound_run_is_correct(path):
    result = _run(_cell(path))
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {"gdof_s", "call_ms_p95", "setup_s"} or (
        result["attempted"] < 2)
    assert result["checks"]["max_err"]["value"] < 1e-5
    json.dumps(result)


def test_traced_run_carries_the_per_layer_metrics():
    result = _run(_cell("qp_shared"), traced=True)
    assert list(result)[-1] == "checks" and "breakdown" in result
    assert "enqueue_us" in result["metrics"]
    assert "library_s" not in result["metrics"]  # nothing built off the card
    assert result["device"]["window_s"] > 0


def _unwritten(fn):
    return lambda *args: torch.zeros_like(fn(*args))


def _half_batch(fn):
    """The second half of the elements left out: the coefficient operand's
    last axis runs over elements in both layouts."""
    def call(x, *rest):
        x = x.clone()
        x[..., x.shape[-1] // 2:] = 0
        return fn(x, *rest)
    return call


def _altered(fn):
    def call(*args):
        out = fn(*args)
        out.view(-1)[out.numel() // 3] += 1.0
        return out
    return call


@pytest.mark.parametrize("fault", [_unwritten, _half_batch, _altered])
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("dtype,limit", [("float32", 1e-5), ("float64", 1e-10)])
def test_fault_makes_the_run_incorrect(monkeypatch, path, fault, dtype, limit):
    real = spec.load("programs", "b05")

    def column(*a, **k):
        fn, keys = real.column(*a, **k)
        return fault(fn), keys

    fake = types.SimpleNamespace(operators=real.operators, column=column)
    monkeypatch.setattr(spec.Cell, "program", property(lambda self: fake))
    result = _run(_cell(path, dtype, limit))
    assert not result["correct"]
    assert result["failed"] >= 1
    assert result["checks"]["max_err"]["value"] > limit


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "hex8-f32-qp", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_refuses_with_fewer_cards_than_the_cell_asks(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(["--workload", "hex8-f32-qp", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_command_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", "hex8-f32-qp",
         "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout == ""


def test_the_benchmark_alone_cannot_bind_a_column(tmp_path):
    """In a directory that holds only BENCHMARK.json and port_bench/, the
    program is missing, so no cell can be run."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("from port_bench import spec; "
            "spec.cell('hex8-f32-qp').program")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode != 0
    assert "tpu_bench_torch" in proc.stderr


def test_sample_is_drawn_from_the_seed():
    def kept(seed):
        sample = window.Sample(2, seed)
        for i in range(1000):
            sample(i)
        return sample.kept, sample.seen

    assert kept(7) == kept(7)
    assert kept(7)[1] == 1000
    assert kept(7) != kept(8)
