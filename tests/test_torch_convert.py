"""Operands carried across from the JAX package (tpu_bench_torch.convert):
the port's three headline columns on the JAX prepare dict's arrays give the
norms of the JAX package's own columns (Pallas in interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bench.benchmarks import benchmark05 as jax_b05
from tpu_bench.core.config import Config as JaxConfig
from tpu_bench.core.validate import l2norm as jax_l2norm
from tpu_bench_torch import convert
from tpu_bench_torch.baselines import bwdtrans3d as lib_bt
from tpu_bench_torch.core.validate import l2norm
from tpu_bench_torch.kernels import bwdtrans2d as k2
from tpu_bench_torch.kernels import bwdtrans3d as k1


def test_headline_columns_match_jax():
    cfg = JaxConfig(dtype=jnp.float32, n_tests=2)
    data = jax_b05.prepare(8, 8, 8, 256, cfg)
    arrays = {k: np.asarray(data[k]) for k in convert.KEYS}
    t = convert.data_from_numpy(arrays, device="cpu", dtype=torch.float32)
    for k in convert.KEYS:
        assert tuple(t[k].shape) == arrays[k].shape, k
        assert np.array_equal(t[k].numpy(), arrays[k]), k

    jax_norms = {label: jax_l2norm(fn(*args))
                 for label, fn, args in jax_b05.build_variants(data, cfg)
                 if label in ("XLA(GEMM)", "Pallas(Coales)",
                              "Pallas(QP/Shared)")}
    port_norms = {
        "XLA(GEMM)": l2norm(lib_bt.gemm_kron(t["in_coa"], t["c_coa3"])),
        "Pallas(Coales)": l2norm(k2.kron_blocked(t["in_blk"], t["c_coa3"])),
        "Pallas(QP/Shared)": l2norm(k1.qp_shared3d_flat(
            t["in_pflat"], t["b0"], t["c12t"], nrq=49)),
    }
    for label, norm in port_norms.items():
        assert norm == pytest.approx(jax_norms[label], rel=1e-5), label


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_port_prepare_builds_the_jax_bytes(dtype):
    """The port's own prepare gives the JAX package's operands exactly, and
    blocked_coa reproduces the JAX chunk layout at the JAX chunk width."""
    from tpu_bench_torch.benchmarks import benchmark05 as b05
    from tpu_bench_torch.core.config import Config
    from tpu_bench_torch.ops import bwdtrans

    jdata = jax_b05.prepare(3, 4, 5, 300, JaxConfig(dtype=jnp.dtype(dtype),
                                                    n_tests=2))
    data = b05.prepare(3, 4, 5, 300, Config(dtype=getattr(torch, dtype),
                                            device="cpu"))
    for k in convert.KEYS:
        if k == "in_blk":
            continue
        np.testing.assert_array_equal(data[k].numpy(), np.asarray(jdata[k]),
                                      err_msg=k)
    jblk = np.asarray(jdata["in_blk"])
    np.testing.assert_array_equal(
        bwdtrans.blocked_coa(data["in_coa"], jblk.shape[2]).numpy(), jblk)
    np.testing.assert_array_equal(
        data["in_blk"].numpy(),
        bwdtrans.blocked_coa(data["in_coa"], data["ce"]).numpy())


def test_unknown_operand_is_refused():
    with pytest.raises(KeyError, match="in_slices"):
        convert.data_from_numpy({"in_slices": np.zeros(2)}, device="cpu",
                                dtype=torch.float32)
