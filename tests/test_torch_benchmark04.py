"""The port's benchmark04 on the CPU: every column against the f64 oracle,
the reference log's golden norm, f32 columns against the oracle at
anisotropic orders, one kernel path per column at every order, and the
CLI's log through postprocess/common.py."""

import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch

from tpu_bench_torch.benchmarks import benchmark04 as b04
from tpu_bench_torch.core.config import Config
from tpu_bench_torch.core.validate import l2norm
from tpu_bench_torch.ops import bwdtrans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(dtype):
    return Config(dtype=dtype, n_tests=2, device="cpu")


def _norms(data, cfg):
    norms = {label: l2norm(fn(*args))
             for label, fn, args in b04.build_variants(data, cfg)}
    assert list(norms) == b04.LABELS and len(norms) == 11
    return norms


@pytest.mark.parametrize("nelmt", [128, 200])
@pytest.mark.parametrize("nq", [2, 3, 8, 11, 32])
def test_columns_match_oracle(nq, nelmt):
    cfg = _cfg(torch.float64)
    data = b04.prepare(nq, nq, nelmt, cfg)
    ref = bwdtrans.reference2d(data["basis"], nelmt)
    ref_norm = float(np.linalg.norm(ref))
    for label, norm in _norms(data, cfg).items():
        assert norm == pytest.approx(ref_norm, rel=1e-10), label
    label, fn, args = b04.build_variants(data, cfg)[0]
    assert label == "XLA(Uncoales)"
    out = fn(*args).numpy()  # (e_pad, nq1, nq0); padding elements are zero
    np.testing.assert_allclose(out[:nelmt], ref, rtol=1e-9,
                               atol=1e-12 * np.abs(ref).max())
    assert not out[nelmt:].any()


def test_golden_norm_nq8():
    """Reference committed log value (benchmark04/nq8x8.log:3)."""
    cfg = _cfg(torch.float64)
    for label, norm in _norms(b04.prepare(8, 8, 128, cfg), cfg).items():
        assert norm == pytest.approx(29.12205853, rel=1e-8), label


@pytest.mark.parametrize("nq", [(10, 12), (12, 10), (4, 4), (32, 32)])
def test_f32_columns_match_oracle(nq):
    """f32 against the f64 oracle.  At (10, 12) the JAX package's f32
    Pallas(QP/Shared) gives the (12, 10) norm, 138.66765596, where the
    oracle gives 29.74275807 (its qp_w_flat reads q-major rows as
    p-major; ROADMAP Queue 3); the port's column must give the oracle."""
    cfg = _cfg(torch.float32)
    data = b04.prepare(*nq, 128, cfg)
    ref_norm = float(np.linalg.norm(bwdtrans.reference2d(data["basis"],
                                                         128)))
    for label, norm in _norms(data, cfg).items():
        assert norm == pytest.approx(ref_norm, rel=5e-4), label
    if nq == (10, 12):
        assert ref_norm == pytest.approx(29.74275807, rel=1e-9)


def test_one_kernel_path_per_column():
    """No per-order choice of kernel: every order runs the same function
    on the same operands in each column."""
    cfg = _cfg(torch.float32)
    tables = [[(label, getattr(fn, "func", fn), keys)
               for label, fn, keys in b04.variant_specs(
                   b04.prepare(nq, nq, 128, cfg), cfg)]
              for nq in (2, 8, 14, 32)]
    assert all(t == tables[0] for t in tables)


def test_main_log_parses_with_postprocess(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        b04.main(["4", "4", "--max-size", "256", "--ntests", "2",
                  "--device", "cpu"])
    log = tmp_path / "nq4x4.log"
    log.write_text(buf.getvalue())
    sys.path.insert(0, os.path.join(REPO, "postprocess"))
    try:
        import common
    finally:
        sys.path.pop(0)
    sizes, series, labels, title = common.parse_log(str(log), "nelmt",
                                                    "DOF/s")
    assert title == "BwdTrans (NQ = 4, 4)"
    assert labels == b04.LABELS and len(labels) == 11
    assert sizes == [128.0, 256.0]
    for row in series:
        assert len(row) == 11 and all(v > 0 for v in row), row


def test_main_refuses_bf16(tmp_path):
    """bf16 runs: the CLI's log parses with postprocess/common.py, every
    column > 0 and the norms of each row within bf16's 5e-2."""
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        b04.main(["8", "8", "--dtype", "bf16", "--device", "cpu",
                  "--max-size", "256", "--ntests", "2"])
    assert "WARNING" not in err.getvalue(), err.getvalue()
    log = tmp_path / "nq8x8.log"
    log.write_text(buf.getvalue())
    sys.path.insert(0, os.path.join(REPO, "postprocess"))
    try:
        import common
    finally:
        sys.path.pop(0)
    sizes, series, labels, _ = common.parse_log(str(log), "nelmt", "DOF/s")
    assert labels == b04.LABELS and sizes == [128.0, 256.0]
    for row in series:
        assert len(row) == 11 and all(v > 0 for v in row), row
    for line in buf.getvalue().splitlines():
        if " norm: " in line:
            norms = [float(v) for v in line.split()[3:]]
            assert len(norms) == 11
            assert max(norms) <= min(norms) * (1 + 5e-2), norms


def test_ozaki_route_golden_norm():
    """--dtype f64 --f64-coales ozaki: Pallas(Coales) runs the slice GEMM,
    normed through its (hi, lo) pair; every column gives the golden norm
    and all eleven agree to 1e-10."""
    cfg = Config(dtype=torch.float64, n_tests=2, device="cpu",
                 f64_coales="ozaki")
    data = b04.prepare(8, 8, 128, cfg)
    norms = {}
    for label, fn, args, *norm in b04.build_variants(data, cfg):
        norms[label] = (norm[0] if norm else l2norm)(fn(*args))
    assert list(norms) == b04.LABELS
    coales = b04.variant_specs(data, cfg)[6]
    assert coales[0] == "Pallas(Coales)" and coales[2] == ("in_slices",
                                                           "c_slices")
    for label, norm in norms.items():
        assert norm == pytest.approx(29.12205853, rel=1e-8), label
        assert norm == pytest.approx(norms["XLA(GEMM)"], rel=1e-10), label


def test_ozaki_route_cli_log():
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        b04.main(["8", "8", "--dtype", "f64", "--f64-coales", "ozaki",
                  "--device", "cpu", "--max-size", "128", "--ntests", "1"])
    norms = next(line for line in buf.getvalue().splitlines()
                 if " norm: " in line).split()[3:]
    assert len(norms) == 11 and set(norms) == {"29.12205853"}, norms
    assert "WARNING" not in err.getvalue(), err.getvalue()


def test_ozaki_route_needs_f64():
    """The route is the f64 column's: any other dtype is refused."""
    with pytest.raises(ValueError, match="needs dtype f64"):
        b04.main(["8", "8", "--dtype", "f32", "--f64-coales", "ozaki",
                  "--device", "cpu"])
