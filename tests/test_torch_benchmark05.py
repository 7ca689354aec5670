"""The port's benchmark05 on the CPU: every column against the f64 oracle,
the reference log's golden norm, f32 cross-column agreement, the CLI's log
through postprocess/common.py, and the headline entry point."""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from tpu_bench_torch import bench
from tpu_bench_torch.benchmarks import benchmark05 as b05
from tpu_bench_torch.core.config import Config
from tpu_bench_torch.core.validate import l2norm
from tpu_bench_torch.ops import bwdtrans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIVE = set(b05.LABELS)


def _cfg(dtype):
    return Config(dtype=dtype, n_tests=2, device="cpu")


def _live_norms(data, cfg):
    norms = {label: l2norm(fn(*args))
             for label, fn, args in b05.build_variants(data, cfg)}
    assert set(norms) == LIVE and len(LIVE) == 11
    return norms


@pytest.mark.parametrize("nq", [(2, 2, 2), (3, 3, 3), (6, 6, 6), (3, 4, 5)])
def test_live_columns_match_oracle(nq):
    cfg = _cfg(torch.float64)
    data = b05.prepare(*nq, 128, cfg)
    ref = bwdtrans.reference3d(data["basis"], 128)
    ref_norm = float(np.linalg.norm(ref))
    for label, norm in _live_norms(data, cfg).items():
        assert norm == pytest.approx(ref_norm, rel=1e-10), label
    label, fn, args = b05.build_variants(data, cfg)[0]
    assert label == "XLA(Uncoales)"
    np.testing.assert_allclose(fn(*args).numpy(), ref, rtol=1e-9)


def test_golden_norm_nq8():
    """Reference committed log value (benchmark05/nq8x8x8.log:3)."""
    cfg = _cfg(torch.float64)
    for label, norm in _live_norms(b05.prepare(8, 8, 8, 128, cfg),
                                   cfg).items():
        assert norm == pytest.approx(189.3141665, rel=1e-8), label


@pytest.mark.parametrize("nq", [4, 8])
def test_f32_agreement(nq):
    cfg = _cfg(torch.float32)
    norms = _live_norms(b05.prepare(nq, nq, nq, 256, cfg), cfg)
    ref = norms["XLA(Uncoales)"]
    for label, norm in norms.items():
        assert norm == pytest.approx(ref, rel=5e-4), label


def test_main_log_parses_with_postprocess(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        b05.main(["4", "4", "4", "--max-size", "256", "--ntests", "2",
                  "--device", "cpu"])
    log = tmp_path / "nq4x4x4.log"
    log.write_text(buf.getvalue())
    sys.path.insert(0, os.path.join(REPO, "postprocess"))
    try:
        import common
    finally:
        sys.path.pop(0)
    sizes, series, labels, title = common.parse_log(str(log), "nelmt",
                                                    "DOF/s")
    assert title == "BwdTrans (NQ = 4, 4, 4)"
    assert labels == b05.LABELS
    assert sizes == [128.0, 256.0]
    for row in series:
        for label, v in zip(labels, row):
            assert (v > 0) == (label in LIVE), (label, v)


def test_main_refuses_bf16(tmp_path):
    """bf16 runs: the CLI's log parses with postprocess/common.py, every
    column > 0 and the norms of each row within bf16's 5e-2."""
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        b05.main(["8", "8", "8", "--dtype", "bf16", "--device", "cpu",
                  "--max-size", "256", "--ntests", "2"])
    assert "WARNING" not in err.getvalue(), err.getvalue()
    log = tmp_path / "nq8x8x8.log"
    log.write_text(buf.getvalue())
    sys.path.insert(0, os.path.join(REPO, "postprocess"))
    try:
        import common
    finally:
        sys.path.pop(0)
    sizes, series, labels, _ = common.parse_log(str(log), "nelmt", "DOF/s")
    assert labels == b05.LABELS and sizes == [128.0, 256.0]
    for row in series:
        assert len(row) == 11 and all(v > 0 for v in row), row
    for line in buf.getvalue().splitlines():
        if " norm: " in line:
            norms = [float(v) for v in line.split()[3:]]
            assert len(norms) == 11
            assert max(norms) <= min(norms) * (1 + 5e-2), norms


def test_bench_headline_json(capsys):
    result, columns = bench.main(["--device", "cpu", "--nelmt", "256",
                                  "--ntests", "1"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == result
    assert set(result) == {"metric", "value", "unit", "vs_baseline"}
    assert result["unit"] == "GDOF/s"
    assert [c["label"] for c in columns] == [
        "XLA(GEMM)", "Pallas(Coales)", "Pallas(QP/Shared)"]
    norms = [c["norm"] for c in columns]
    assert max(norms) == pytest.approx(min(norms), rel=5e-4)


def test_main_profile_writes_trace(tmp_path):
    with contextlib.redirect_stdout(io.StringIO()):
        b05.main(["2", "2", "2", "--max-size", "128", "--ntests", "1",
                  "--device", "cpu", "--profile", str(tmp_path)])
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]
    # the wrappers of Pallas(QP/Shared) and Pallas(Coales) record their spans
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert {"tbt.qp_shared3d_flat", "tbt.kron_blocked"} <= names


def test_ozaki_route_golden_norm():
    """--dtype f64 --f64-coales ozaki: Pallas(Coales) runs the slice GEMM,
    normed through its (hi, lo) pair; every column gives the golden norm
    and all eleven agree to 1e-10."""
    cfg = Config(dtype=torch.float64, n_tests=2, device="cpu",
                 f64_coales="ozaki")
    data = b05.prepare(8, 8, 8, 128, cfg)
    norms = {}
    for label, fn, args, *norm in b05.build_variants(data, cfg):
        norms[label] = (norm[0] if norm else l2norm)(fn(*args))
    assert list(norms) == b05.LABELS
    coales = b05.variant_specs(data, cfg)[6]
    assert coales[0] == "Pallas(Coales)" and coales[2] == ("in_slices",
                                                           "c_slices")
    for label, norm in norms.items():
        assert norm == pytest.approx(189.3141665, rel=1e-8), label
        assert norm == pytest.approx(norms["XLA(GEMM)"], rel=1e-10), label


def test_ozaki_route_cli_log():
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        b05.main(["8", "8", "8", "--dtype", "f64", "--f64-coales", "ozaki",
                  "--device", "cpu", "--max-size", "128", "--ntests", "1"])
    norms = next(line for line in buf.getvalue().splitlines()
                 if " norm: " in line).split()[3:]
    assert len(norms) == 11 and set(norms) == {"189.3141665"}, norms
    assert "WARNING" not in err.getvalue(), err.getvalue()


def test_ozaki_route_needs_f64():
    """The route is the f64 column's: any other dtype is refused."""
    with pytest.raises(ValueError, match="needs dtype f64"):
        b05.main(["8", "8", "8", "--dtype", "f32", "--f64-coales", "ozaki",
                  "--device", "cpu"])
