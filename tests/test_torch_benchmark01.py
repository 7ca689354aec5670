"""The port's benchmark01 on the CPU: every column against the f64 oracle
and the reference log's golden norms, f32 against the oracle, the columns
on the JAX package's operands against the JAX columns, and the CLI's log
against the JAX CLI's and through postprocess/common.py.

Tolerances: f64 1e-12 against the oracle (a sum of at most 65,537
positive terms); golden norms 1e-9 (the log prints 10 digits); f32 1e-5
(the JAX package's own f32 bound, tests/test_benchmark01.py); the logs'
norms 1e-10 in f64 and 1e-5 in f32, where the two packages' x differ by
one ulp on a few percent of the elements (ops/initdata.py) and the sums
run in other orders."""

import contextlib
import io
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bench.benchmarks import benchmark01 as jax_b01
from tpu_bench.core.config import Config as JaxConfig
from tpu_bench.ops import initdata as jax_init
from tpu_bench_torch import convert
from tpu_bench_torch.benchmarks import benchmark01 as b01
from tpu_bench_torch.core.config import Config
from tpu_bench_torch.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# sqrt(sum x^2) of the reference log (benchmark01/outfile.log:5,9)
GOLDEN_NORMS = {1024: 231.3925755, 2048: 327.7035849, 4096: 464.5263377}


def _cfg(dtype):
    return Config(dtype=dtype, n_tests=2, device="cpu")


def _norms(data, cfg):
    norms = {label: b01.sumsq_norm(fn(*args))
             for label, fn, args in b01.build_variants(data, cfg)}
    assert list(norms) == b01.LABELS and len(norms) == 5
    return norms


@pytest.mark.parametrize("size", [1000, 1024, 4096, 65537])
def test_columns_match_oracle(size):
    cfg = _cfg(torch.float64)
    x = native.init_mod13(size)
    expected = math.sqrt(float(np.sum(x * x)))
    for label, norm in _norms(b01.prepare(size, cfg), cfg).items():
        assert norm == pytest.approx(expected, rel=1e-12), label


@pytest.mark.parametrize("size,golden", sorted(GOLDEN_NORMS.items()))
def test_golden_norms(size, golden):
    cfg = _cfg(torch.float64)
    for label, norm in _norms(b01.prepare(size, cfg), cfg).items():
        assert norm == pytest.approx(golden, rel=1e-9), label


def test_f32_columns_match_oracle():
    cfg = _cfg(torch.float32)
    x = native.init_mod13(8192)
    expected = math.sqrt(float(np.sum(x * x)))
    for label, norm in _norms(b01.prepare(8192, cfg), cfg).items():
        assert norm == pytest.approx(expected, rel=1e-5), label


def test_columns_match_jax_on_jax_operands():
    """The port's columns on the JAX package's x (convert.B01_KEYS) give
    the JAX columns' norms (Pallas in interpret mode)."""
    jcfg = JaxConfig(dtype=jnp.float32, n_tests=2)
    jdata = {"x": jax_init.device_x(4096, jnp.float32)}
    jax_norms = {label: math.sqrt(float(fn(*args)))
                 for label, fn, args in jax_b01.build_variants(jdata, jcfg)}
    data = convert.data_from_numpy(
        {k: np.asarray(jdata[k]) for k in convert.B01_KEYS}, device="cpu",
        dtype=torch.float32)
    port = _norms(data, _cfg(torch.float32))
    assert list(port) == list(jax_norms)
    for label, norm in port.items():
        assert norm == pytest.approx(jax_norms[label], rel=1e-5), label


def _log(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.mark.parametrize("dtype,rtol", [("f32", 1e-5), ("f64", 1e-10)])
def test_log_matches_jax_cli(dtype, rtol):
    """Title, Case lines and norms of `--max-size 4096` against the JAX
    CLI's (its Pallas columns in interpret mode)."""
    argv = ["--max-size", "4096", "--ntests", "2", "--dtype", dtype]
    ours = _log(b01.main, argv + ["--device", "cpu"]).splitlines()
    theirs = _log(jax_b01.main, argv).splitlines()
    assert len(ours) == len(theirs) == 3 + 3 * 3
    for a, b in zip(ours, theirs):
        if " norm: " in a:
            assert a.split()[:3] == b.split()[:3]
            for u, v in zip(a.split()[3:], b.split()[3:], strict=True):
                assert float(u) == pytest.approx(float(v), rel=rtol), a
        elif " GB/s: " not in a:
            assert a == b


def test_main_log_parses_with_postprocess(tmp_path):
    log = tmp_path / "outfile.log"
    log.write_text(_log(b01.main, ["--max-size", "4096", "--ntests", "2",
                                   "--device", "cpu"]))
    sys.path.insert(0, os.path.join(REPO, "postprocess"))
    try:
        import common
    finally:
        sys.path.pop(0)
    sizes, series, labels, _ = common.parse_log(str(log), "Size", "GB/s")
    assert labels == b01.LABELS
    assert sizes == [1024.0, 2048.0, 4096.0]
    for row in series:
        assert len(row) == 5 and all(v > 0 for v in row), row


def test_main_refuses_bf16():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        b01.main(["--dtype", "bf16", "--device", "cpu"])
