"""The port's benchmark02 on the CPU: b02's accumulating protocol, every
column against the f64 oracle ||x0 + n_tests*y|| and the reference log's
golden norms (40 calls), f32 against the oracle, the columns on the JAX
package's operands against the JAX columns, and the CLI's log against the
JAX CLI's and through postprocess/common.py.

Tolerances: f64 1e-12 against the oracle (one rounded add per element
and call); golden norms 1e-9 (the log prints 10 digits); f32 1e-5 (the
JAX package's own f32 bound); the logs' norms 1e-10 in f64 and 1e-5 in
f32, where the two packages' x and y differ by one ulp on a few percent of
the elements (ops/initdata.py)."""

import contextlib
import io
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bench.benchmarks import benchmark02 as jax_b02
from tpu_bench.core.config import Config as JaxConfig
from tpu_bench.core.validate import l2norm as jax_l2norm
from tpu_bench.core.variants import Layouts as JaxLayouts
from tpu_bench.ops import initdata as jax_init
from tpu_bench_torch import convert
from tpu_bench_torch.benchmarks import benchmark02 as b02
from tpu_bench_torch.core import timing
from tpu_bench_torch.core.config import Config
from tpu_bench_torch.core.validate import l2norm
from tpu_bench_torch.core.variants import Layouts
from tpu_bench_torch.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# ||x0 + 40 y|| of the reference log (benchmark02/outfile.log:5,8)
GOLDEN_NORMS = {1024: 5979.883197, 2048: 8481.399219}


def _cfg(dtype, n_tests=2):
    return Config(dtype=dtype, n_tests=n_tests, device="cpu")


def _final_norms(data, cfg):
    norms = {}
    for label, fn, keys in b02.variant_specs(data, cfg):
        t, x = timing.accumulating(fn, tuple(data[k] for k in keys), cfg)
        assert t > 0
        norms[label] = l2norm(x)
    assert list(norms) == b02.LABELS and len(norms) == 5
    return norms


def test_accumulating_runs_n_tests_calls_after_a_scratch_warmup():
    cfg = _cfg(torch.float64, n_tests=5)
    x0 = torch.arange(6.0, dtype=torch.float64)
    y = torch.ones(6, dtype=torch.float64)
    seen = []

    def add(x, y):
        seen.append(x.data_ptr())
        return x.add_(y)

    x = x0.clone()
    _, out = timing.accumulating(add, (x, y), cfg)
    assert len(seen) == 6 and seen[0] != x.data_ptr()  # the scratch copy
    assert set(seen[1:]) == {x.data_ptr()} and out is x
    assert torch.equal(out, x0 + 5)


@pytest.mark.parametrize("size", [1000, 4096])
def test_columns_accumulate_to_oracle(size):
    cfg = _cfg(torch.float64, n_tests=3)
    expected = float(np.linalg.norm(native.init_mod13(size)
                                    + 3 * native.init_mod8(size)))
    for label, norm in _final_norms(b02.prepare(size, cfg), cfg).items():
        assert norm == pytest.approx(expected, rel=1e-12), label


@pytest.mark.parametrize("size,golden", sorted(GOLDEN_NORMS.items()))
def test_golden_norms(size, golden):
    cfg = _cfg(torch.float64, n_tests=40)  # the reference's 40 calls
    for label, norm in _final_norms(b02.prepare(size, cfg), cfg).items():
        assert norm == pytest.approx(golden, rel=1e-9), label


def test_f32_columns_match_oracle():
    cfg = _cfg(torch.float32)
    expected = float(np.linalg.norm(native.init_mod13(8192)
                                    + 2 * native.init_mod8(8192)))
    for label, norm in _final_norms(b02.prepare(8192, cfg), cfg).items():
        assert norm == pytest.approx(expected, rel=1e-5), label


def test_columns_match_jax_on_jax_operands():
    """The port's columns on the JAX package's x and y
    (convert.B02_KEYS) give the JAX columns' norms after the same two
    accumulating calls (Pallas in interpret mode)."""
    jcfg = JaxConfig(dtype=jnp.float32, n_tests=2, timing="dispatch")
    x0 = np.asarray(jax_init.device_x(4096, jnp.float32))
    y = np.asarray(jax_init.device_y(4096, jnp.float32))
    jdata = JaxLayouts(base={"y": jnp.asarray(y)},
                       derived={"x": lambda: jnp.asarray(x0)})
    jax_norms = {}
    for label, fn, keys in jax_b02.variant_specs(jdata, jcfg):
        _, x_final = jax_b02._time_accumulating(fn, jcfg, jdata, *keys)
        jax_norms[label] = jax_l2norm(x_final)
    t = convert.data_from_numpy({"x": x0, "y": y}, device="cpu",
                                dtype=torch.float32)
    data = Layouts(base={"y": t["y"]}, derived={"x": t["x"].clone})
    port = _final_norms(data, _cfg(torch.float32))
    assert list(port) == list(jax_norms)
    for label, norm in port.items():
        assert norm == pytest.approx(jax_norms[label], rel=1e-6), label


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
    ours = _log(b02.main, argv + ["--device", "cpu"]).splitlines()
    theirs = _log(jax_b02.main, argv).splitlines()
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
    log.write_text(_log(b02.main, ["--max-size", "2048", "--ntests", "2",
                                   "--device", "cpu"]))
    sys.path.insert(0, os.path.join(REPO, "postprocess"))
    try:
        import common
    finally:
        sys.path.pop(0)
    sizes, series, labels, _ = common.parse_log(str(log), "Size", "GB/s")
    assert labels == b02.LABELS
    assert sizes == [1024.0, 2048.0]
    for row in series:
        assert len(row) == 5 and all(v > 0 for v in row), row


def test_main_refuses_bf16():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        b02.main(["--dtype", "bf16", "--device", "cpu"])
