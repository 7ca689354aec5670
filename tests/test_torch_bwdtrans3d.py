"""The port's 3D QP wrappers (tpu_bench_torch.kernels.bwdtrans3d) against
the JAX package's Pallas kernels in interpret mode, on the same numpy-seeded
random inputs, which vary per element so an element-axis bug shows, and
random dense stage operators, so the kernels' generality shows too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bench.kernels import bwdtrans3d as pl_bt
from tpu_bench_torch.kernels import bwdtrans3d as k1

E, EPB = 256, 128
SHAPES = [(4, 4, 4), (8, 8, 8), (3, 4, 5)]
# f32: both sides sum the same products in other orders; f64: to rounding.
TOLS = [(np.float32, 1e-5), (np.float64, 1e-12)]


def _inputs(nq, dtype, seed=0):
    nq0, nq1, nq2 = nq
    nm0, nrq, nkj = nq0 - 1, (nq2 - 1) * (nq1 - 1), nq2 * nq1
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nm0, nrq, E)).astype(dtype)
    b0 = rng.standard_normal((nm0, nq0)).astype(dtype)
    c12t = rng.standard_normal((nkj, nrq)).astype(dtype)
    return x, b0, c12t


def _close(out, ref, rtol):
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("dtype,rtol", TOLS)
@pytest.mark.parametrize("nq", SHAPES)
def test_qp_shared3d_matches_jax(nq, dtype, rtol):
    x, b0, c12t = _inputs(nq, dtype)
    ref = pl_bt.qp_shared3d(jnp.asarray(x), jnp.asarray(b0),
                            jnp.asarray(c12t), epb=EPB, interpret=True,
                            precision=jax.lax.Precision.HIGHEST)
    out = k1.qp_shared3d(torch.from_numpy(x), torch.from_numpy(b0),
                         torch.from_numpy(c12t))
    assert out.dtype == torch.from_numpy(x).dtype
    _close(out.numpy(), np.asarray(ref), rtol)


@pytest.mark.parametrize("dtype,rtol", TOLS)
@pytest.mark.parametrize("nq", SHAPES)
def test_qp_shared3d_flat_matches_jax(nq, dtype, rtol):
    x, b0, c12t = _inputs(nq, dtype, seed=1)
    nm0, nrq, _ = x.shape
    flat = x.reshape(nm0 * nrq, E)
    ref = pl_bt.qp_shared3d_flat(jnp.asarray(flat), jnp.asarray(b0),
                                 jnp.asarray(c12t), nrq=nrq, epb=EPB,
                                 interpret=True,
                                 precision=jax.lax.Precision.HIGHEST)
    out = k1.qp_shared3d_flat(torch.from_numpy(flat), torch.from_numpy(b0),
                              torch.from_numpy(c12t), nrq=nrq)
    _close(out.numpy(), np.asarray(ref), rtol)


@pytest.mark.parametrize("nq", SHAPES)
def test_plane_and_flat_agree_bit_for_bit(nq):
    x, b0, c12t = (torch.from_numpy(a) for a in _inputs(nq, np.float32, 2))
    nm0, nrq, _ = x.shape
    plane = k1.qp_shared3d(x, b0, c12t)
    flat = k1.qp_shared3d_flat(x.reshape(nm0 * nrq, E), b0, c12t, nrq=nrq)
    assert torch.equal(plane.reshape(flat.shape), flat)


def _stage_operators(nq, dtype, seed):
    """Random dense operators of the QP-1D stage shapes at order nq:
    (nmTot, nm2*nm1*nq0), (.., nm2*nq1*nq0), (.., nqTot); and in (E, nmTot)."""
    nq0, nq1, nq2 = nq
    nm0, nm1, nm2 = nq0 - 1, nq1 - 1, nq2 - 1
    widths = [nm2 * nm1 * nm0, nm2 * nm1 * nq0, nm2 * nq1 * nq0,
              nq2 * nq1 * nq0]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, widths[0])).astype(dtype)
    ops = [rng.standard_normal((k, n)).astype(dtype)
           for k, n in zip(widths, widths[1:])]
    return x, ops


@pytest.mark.parametrize("dtype,rtol", TOLS)
@pytest.mark.parametrize("nq", SHAPES)
def test_qp_global3d_matches_jax(nq, dtype, rtol):
    x, b0, c12t = _inputs(nq, dtype, seed=3)
    ref = pl_bt.qp_global3d(jnp.asarray(x), jnp.asarray(b0),
                            jnp.asarray(c12t), epb=EPB, interpret=True,
                            precision=jax.lax.Precision.HIGHEST)
    out = k1.qp_global3d(torch.from_numpy(x), torch.from_numpy(b0),
                         torch.from_numpy(c12t))
    assert out.shape == ref.shape
    _close(out.numpy(), np.asarray(ref), rtol)


@pytest.mark.parametrize("dtype,rtol", TOLS)
@pytest.mark.parametrize("nq", SHAPES)
@pytest.mark.parametrize("name", ["qp1d_shared3d", "qp1d_global3d"])
def test_qp1d3d_matches_jax(name, nq, dtype, rtol):
    x, ops = _stage_operators(nq, dtype, seed=4)
    ref = getattr(pl_bt, name)(jnp.asarray(x), *map(jnp.asarray, ops),
                               epb=EPB, interpret=True,
                               precision=jax.lax.Precision.HIGHEST)
    out = getattr(k1, name)(torch.from_numpy(x), *map(torch.from_numpy, ops))
    assert out.shape == ref.shape and out.dtype == torch.from_numpy(x).dtype
    _close(out.numpy(), np.asarray(ref), rtol)


def test_new_wrappers_reject_bad_input():
    x, b0, c12t = (torch.from_numpy(a) for a in _inputs((4, 4, 4),
                                                        np.float32))
    em, ops = _stage_operators((4, 4, 4), np.float32, seed=5)
    em, ops = torch.from_numpy(em), [torch.from_numpy(o) for o in ops]
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 2"):
        k1.qp_global3d(x.bfloat16(), b0.bfloat16(), c12t.bfloat16())
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 2"):
        k1.qp1d_shared3d(em.bfloat16(), *(o.bfloat16() for o in ops))
    with pytest.raises(TypeError):
        k1.qp_stage2_3d(x, b0.double())
    with pytest.raises(ValueError, match="do not chain"):
        k1.qp1d_shared3d(em, ops[0], ops[2], ops[1])
    with pytest.raises(ValueError, match="element tiles"):
        k1.qp1d_shared3d(em, *ops, epb=128)
    with pytest.raises(ValueError, match="contiguous"):
        k1.qp1d_shared3d(em[:, ::2], *ops)
    meta = [t.to("meta") for t in (em, *ops)]
    with pytest.raises(ValueError, match="no kernel for device"):
        k1.qp1d_shared3d(*meta)
    with pytest.raises(ValueError, match="no kernel for device"):
        k1.qp_stage2_3d(x.to("meta"), b0.to("meta"))


def test_wrapper_rejects_bad_input():
    x, b0, c12t = (torch.from_numpy(a) for a in _inputs((4, 4, 4),
                                                        np.float32))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        k1.qp_shared3d(x.bfloat16(), b0.bfloat16(), c12t.bfloat16())
    with pytest.raises(TypeError):
        k1.qp_shared3d(x, b0.double(), c12t)
    with pytest.raises(ValueError):
        k1.qp_shared3d(x[:, :-1], b0, c12t)
    with pytest.raises(ValueError, match="contiguous"):
        k1.qp_shared3d_flat(x.reshape(-1, E)[:, ::2], b0, c12t, nrq=9)


def test_non_cpu_tensor_never_takes_plain_path():
    """Only a CPU tensor goes to the plain version; any other device
    launches the kernel or raises."""
    x, b0, c12t = (torch.from_numpy(a).to("meta")
                   for a in _inputs((4, 4, 4), np.float32))
    with pytest.raises(ValueError, match="no kernel for device"):
        k1.qp_shared3d(x, b0, c12t)
