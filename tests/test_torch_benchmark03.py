"""The port's benchmark03 on the CPU: every column against the f64 matvec
oracle and the reference log's golden norms, f32 against the oracle, the
columns on the JAX package's operands against the JAX columns, and the
CLI's log against the JAX CLI's and through postprocess/common.py.

Tolerances: f64 1e-12 of the largest output against the oracle (sums of
at most 256 products, which cancel); golden norms 1e-9 (the log prints 10
digits); f32 1e-5 (the JAX package's own f32 bound,
tests/test_benchmark03.py); the logs' norms 1e-10 in f64 and 1e-5 in
f32."""

import contextlib
import io
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bench.benchmarks import benchmark03 as jax_b03
from tpu_bench.core.config import Config as JaxConfig
from tpu_bench.core.validate import l2norm as jax_l2norm
from tpu_bench.ops import initdata as jax_init
from tpu_bench_torch import convert
from tpu_bench_torch.benchmarks import benchmark03 as b03
from tpu_bench_torch.core.config import Config
from tpu_bench_torch.core.validate import l2norm
from tpu_bench_torch.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# ||A.x|| of the reference log (benchmark03/outfile.log:5,8)
GOLDEN_NORMS = {128: 1053.208334, 256: 3026.150384, 512: 8521.062683}


def _cfg(dtype):
    return Config(dtype=dtype, n_tests=2, device="cpu")


def _outputs(data, cfg):
    outs = {label: fn(*args)
            for label, fn, args in b03.build_variants(data, cfg)}
    assert list(outs) == b03.LABELS and len(outs) == 5
    return outs


@pytest.mark.parametrize("size", [100, 128, 256])
def test_columns_match_oracle(size):
    cfg = _cfg(torch.float64)
    data = b03.prepare(size, cfg)
    assert torch.equal(data["a_cm"], data["a_rm"].T)
    assert data["a_cm"].is_contiguous()
    expected = native.matvec_ref(data["a_rm"].numpy(), data["x"].numpy())
    for label, y in _outputs(data, cfg).items():
        np.testing.assert_allclose(y.numpy(), expected, rtol=0,
                                   atol=1e-12 * np.abs(expected).max(),
                                   err_msg=label)


@pytest.mark.parametrize("size,golden", sorted(GOLDEN_NORMS.items()))
def test_golden_norms(size, golden):
    cfg = _cfg(torch.float64)
    for label, y in _outputs(b03.prepare(size, cfg), cfg).items():
        assert l2norm(y) == pytest.approx(golden, rel=1e-9), label


def test_f32_columns_match_oracle():
    cfg = _cfg(torch.float32)
    data = b03.prepare(512, cfg)
    ref = float(np.linalg.norm(native.matvec_ref(
        native.init_sin1(512 * 512).reshape(512, 512),
        np.arange(512.0))))
    for label, y in _outputs(data, cfg).items():
        assert l2norm(y) == pytest.approx(ref, rel=1e-5), label


def test_columns_match_jax_on_jax_operands():
    """The port's columns on the JAX package's A, A^T and x
    (convert.B03_KEYS) give the JAX columns' norms (Pallas in interpret
    mode)."""
    jcfg = JaxConfig(dtype=jnp.float32, n_tests=2)
    a = jax_init.host_matrix_sin1((256, 256), jnp.float32)
    jdata = {"a_rm": a, "a_cm": jnp.asarray(a.T),
             "x": jax_init.host_x_linear(256, jnp.float32)}
    jax_norms = {label: jax_l2norm(fn(*args))
                 for label, fn, args in jax_b03.build_variants(jdata, jcfg)}
    data = convert.data_from_numpy(
        {k: np.asarray(jdata[k]) for k in convert.B03_KEYS}, device="cpu",
        dtype=torch.float32)
    port = {label: l2norm(y)
            for label, y in _outputs(data, _cfg(torch.float32)).items()}
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
    """Title, Case lines and norms of `--max-size 512` against the JAX
    CLI's (its Pallas columns in interpret mode; 512, not 4096, keeps the
    interpreted f64 pair kernels within seconds)."""
    argv = ["--max-size", "512", "--ntests", "2", "--dtype", dtype]
    ours = _log(b03.main, argv + ["--device", "cpu"]).splitlines()
    theirs = _log(jax_b03.main, argv).splitlines()
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
    log.write_text(_log(b03.main, ["--max-size", "256", "--ntests", "2",
                                   "--device", "cpu"]))
    sys.path.insert(0, os.path.join(REPO, "postprocess"))
    try:
        import common
    finally:
        sys.path.pop(0)
    sizes, series, labels, _ = common.parse_log(str(log), "Size", "GB/s")
    assert labels == b03.LABELS
    assert sizes == [128.0, 256.0]
    for row in series:
        assert len(row) == 5 and all(v > 0 for v in row), row


def test_main_refuses_bf16():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        b03.main(["--dtype", "bf16", "--device", "cpu"])
