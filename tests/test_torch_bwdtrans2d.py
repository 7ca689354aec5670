"""The port's kron_blocked and kron_elem_major
(tpu_bench_torch.kernels.bwdtrans2d) against the JAX package's Pallas
kernels in interpret mode, on kron and random dense operators and
numpy-seeded random per-element inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bench.kernels import bwdtrans2d as pl_bt2d
from tpu_bench.utils import native
from tpu_bench_torch.kernels import bwdtrans2d as k2

NBLK, CE = 2, 128


def _kron_operator(nq, dtype):
    """C_coa = kron(B2, B1, B0)^T, (nqTot, nmTot), from the cos basis."""
    b = native.init_cos((nq - 1) * nq).reshape(nq - 1, nq)
    return np.ascontiguousarray(np.kron(b, np.kron(b, b)).T, dtype=dtype)


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5),
                                        (np.float64, 1e-12)])
@pytest.mark.parametrize("nq", [4, 8])
def test_kron_blocked_matches_jax(nq, dtype, rtol):
    c = _kron_operator(nq, dtype)
    rng = np.random.default_rng(nq)
    x = rng.standard_normal((NBLK, c.shape[1], CE)).astype(dtype)
    ref = np.asarray(pl_bt2d.kron_blocked(
        jnp.asarray(x), jnp.asarray(c), interpret=True,
        precision=jax.lax.Precision.HIGHEST))
    out = k2.kron_blocked(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    assert out.shape == (NBLK, nq ** 3, CE)
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5),
                                        (np.float64, 1e-12)])
@pytest.mark.parametrize("nq", [(4, 4, 4), (8, 8, 8), (3, 4, 5)])
def test_kron_elem_major_matches_jax(nq, dtype, rtol):
    """Random dense C_em of the (nmTot, nqTot) shape at order nq."""
    nm_tot = int(np.prod([n - 1 for n in nq]))
    rng = np.random.default_rng(sum(nq))
    x = rng.standard_normal((2 * CE, nm_tot)).astype(dtype)
    c = rng.standard_normal((nm_tot, int(np.prod(nq)))).astype(dtype)
    ref = np.asarray(pl_bt2d.kron_elem_major(
        jnp.asarray(x), jnp.asarray(c), epb=CE, interpret=True,
        precision=jax.lax.Precision.HIGHEST))
    out = k2.kron_elem_major(torch.from_numpy(x), torch.from_numpy(c),
                             epb=CE).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def test_em_gemm_rejects_bad_input():
    x, s = torch.zeros(CE, 27), torch.zeros(27, 64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        k2.kron_elem_major(x.bfloat16(), s.bfloat16())
    with pytest.raises(ValueError, match="are not"):
        k2.one_stage_em(x, s.T.contiguous())
    with pytest.raises(TypeError):
        k2.one_stage_em(x, s.double())
    with pytest.raises(ValueError, match="elements per"):
        k2.kron_elem_major(x, s, epb=256)
    with pytest.raises(ValueError, match="no kernel for device"):
        k2.one_stage_em(x.to("meta"), s.to("meta"))


def test_kron_blocked_rejects_bad_input():
    c = torch.from_numpy(_kron_operator(4, np.float32))
    x = torch.zeros(NBLK, c.shape[1], CE)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        k2.kron_blocked(x.bfloat16(), c.bfloat16())
    with pytest.raises(ValueError):
        k2.kron_blocked(x[:, 1:], c)
    with pytest.raises(TypeError):
        k2.kron_blocked(x, c.double())
    with pytest.raises(ValueError, match="no kernel for device"):
        k2.kron_blocked(x.to("meta"), c.to("meta"))
