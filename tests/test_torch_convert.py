"""Operands carried across from the JAX package (tpu_bench_torch.convert):
the port's eleven benchmark05 and benchmark04 columns on the JAX prepare
dict's arrays give the norms of the JAX package's own columns (Pallas in
interpret mode), and the port's own prepare builds the JAX bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bench.benchmarks import benchmark04 as jax_b04
from tpu_bench.benchmarks import benchmark05 as jax_b05
from tpu_bench.core.config import Config as JaxConfig
from tpu_bench.core.validate import l2norm as jax_l2norm
from tpu_bench_torch import convert
from tpu_bench_torch.benchmarks import benchmark04 as b04
from tpu_bench_torch.benchmarks import benchmark05 as b05
from tpu_bench_torch.core.config import Config
from tpu_bench_torch.core.validate import l2norm
from tpu_bench_torch.kernels import bwdtrans3d as k1
from tpu_bench_torch.ops import bwdtrans


def test_headline_columns_match_jax():
    """All eleven columns of the port's variant table, each on the JAX
    operands it names, against the JAX package's column of the same label."""
    cfg = JaxConfig(dtype=jnp.float32, n_tests=2)
    data = jax_b05.prepare(8, 8, 8, 256, cfg)
    arrays = {k: np.asarray(data[k]) for k in convert.B05_KEYS}
    t = convert.data_from_numpy(arrays, device="cpu", dtype=torch.float32)
    for k in convert.B05_KEYS:
        assert tuple(t[k].shape) == arrays[k].shape, k
        assert np.array_equal(t[k].numpy(), arrays[k]), k

    jax_norms = {label: jax_l2norm(fn(*args))
                 for label, fn, args in jax_b05.build_variants(data, cfg)}
    t["basis"] = bwdtrans.make_basis3d(8, 8, 8, torch.float32, "cpu")
    t["epb_qp"] = k1.EPB
    specs = b05.variant_specs(t, Config(dtype=torch.float32, device="cpu"))
    port_norms = {label: l2norm(fn(*(t[k] for k in keys)))
                  for label, fn, keys in specs}
    assert list(port_norms) == list(jax_norms) == b05.LABELS
    for label, norm in port_norms.items():
        assert norm == pytest.approx(jax_norms[label], rel=1e-5), label


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_port_prepare_builds_the_jax_bytes(dtype):
    """The port's own prepare gives the JAX package's operands exactly, as
    contiguous tensors (the kernels take no other), and blocked_coa
    reproduces the JAX chunk layout at the JAX chunk width."""
    jdata = jax_b05.prepare(3, 4, 5, 300, JaxConfig(dtype=jnp.dtype(dtype),
                                                    n_tests=2))
    data = b05.prepare(3, 4, 5, 300, Config(dtype=getattr(torch, dtype),
                                            device="cpu"))
    for k in convert.B05_KEYS:
        if k == "in_blk":
            continue
        assert data[k].is_contiguous(), k
        np.testing.assert_array_equal(data[k].numpy(), np.asarray(jdata[k]),
                                      err_msg=k)
    jblk = np.asarray(jdata["in_blk"])
    np.testing.assert_array_equal(
        bwdtrans.blocked_coa(data["in_coa"], jblk.shape[2]).numpy(), jblk)
    np.testing.assert_array_equal(
        data["in_blk"].numpy(),
        bwdtrans.blocked_coa(data["in_coa"], data["ce"]).numpy())


def test_b04_columns_match_jax():
    """benchmark04 at nq=8, f32, column by column: the port's table on the
    JAX operands against the JAX package's column of the same label (there
    Pallas(Coales) is kron_wide4 and Pallas(QP/Shared) qp_shared)."""
    cfg = JaxConfig(dtype=jnp.float32, n_tests=2)
    data = jax_b04.prepare(8, 8, 256, cfg)
    arrays = {k: np.asarray(data[k]) for k in convert.B04_KEYS}
    t = convert.data_from_numpy(arrays, device="cpu", dtype=torch.float32)
    for k in convert.B04_KEYS:
        assert np.array_equal(t[k].numpy(), arrays[k]), k

    jax_norms = {label: jax_l2norm(fn(*args))
                 for label, fn, args in jax_b04.build_variants(data, cfg)}
    t["epb_qp"] = k1.EPB
    specs = b04.variant_specs(t, Config(dtype=torch.float32, device="cpu"))
    port_norms = {label: l2norm(fn(*(t[k] for k in keys)))
                  for label, fn, keys in specs}
    assert list(port_norms) == list(jax_norms) == b04.LABELS
    for label, norm in port_norms.items():
        assert norm == pytest.approx(jax_norms[label], rel=1e-5), label


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_b04_prepare_builds_the_jax_bytes(dtype):
    """benchmark04's operands at the anisotropic (3, 5), nelmt=300; the 4D
    chunk layout is compared through blocked_coa, since the two packages
    choose different chunk widths."""
    jdata = jax_b04.prepare(3, 5, 300, JaxConfig(dtype=jnp.dtype(dtype),
                                                 n_tests=2))
    data = b04.prepare(3, 5, 300, Config(dtype=getattr(torch, dtype),
                                         device="cpu"))
    for k in convert.B04_KEYS:
        if k == "in_blk_w4":
            continue
        assert data[k].is_contiguous(), k
        np.testing.assert_array_equal(data[k].numpy(), np.asarray(jdata[k]),
                                      err_msg=k)
    for blk4 in (np.asarray(jdata["in_blk_w4"]), data["in_blk_w4"].numpy()):
        nblk, nm, cr, lanes = blk4.shape
        np.testing.assert_array_equal(
            blk4.reshape(nblk, nm, cr * lanes),
            bwdtrans.blocked_coa(data["in_coa"], cr * lanes).numpy())


def test_unknown_operand_is_refused():
    with pytest.raises(KeyError, match="in_slices"):
        convert.data_from_numpy({"in_slices": np.zeros(2)}, device="cpu",
                                dtype=torch.float32)
