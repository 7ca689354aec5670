"""The port's kernels/ozaki.py against the JAX package's on the CPU: the
slice parameters and both splits bit for bit, kron_ozaki_pair and
kron_ozaki_band (plain versions) bit for bit in hi and lo against the JAX
kron_ozaki_pair in interpret mode, the f64 product against NumPy f64, the
pair norm, and the f64 tier's prepared operands of benchmarks 04/05."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bench.kernels import ozaki as jax_ozaki
from tpu_bench.utils import native
from tpu_bench_torch.benchmarks import benchmark04 as b04
from tpu_bench_torch.benchmarks import benchmark05 as b05
from tpu_bench_torch.core.config import Config
from tpu_bench_torch.kernels import ozaki

E = 256
# (K, nqTot) of the random operators: the b04 nq=8^2 and b05 nq=8^3 shapes,
# and nq=10^3's depth, where slice_params narrows the slices to T=11
RANDOM_SHAPES = [(49, 64), (343, 512), (729, 1000)]


def _operator(name):
    """(C (nqTot, K) f64) of a random shape or a benchmark's operator."""
    if name == "b04 nq=8^2":
        b = native.init_cos(7 * 8).reshape(7, 8)
        return np.ascontiguousarray(np.kron(b, b).T)
    if name == "b05 nq=8^3":
        b = native.init_cos(7 * 8).reshape(7, 8)
        return np.ascontiguousarray(np.kron(b, np.kron(b, b)).T)
    k, nq_tot = name
    return np.random.default_rng(k).standard_normal((nq_tot, k))


def _slices(c, x, t_c=None, t_x=None):
    """The operands split by the JAX package's split_f64_np, as float32
    arrays: (x slices (T_x, K, E), c slices (T_c, nqTot, K), scale)."""
    w, t = jax_ozaki.slice_params(c.shape[1])
    c_sl, s_c = jax_ozaki.split_f64_np(c, w, t_c or t)
    x_sl, s_x = jax_ozaki.split_f64_np(x, w, t_x or t)
    return x_sl, c_sl, s_c * s_x


def _jax_pair(x_sl, c_sl):
    hi, lo = jax_ozaki.kron_ozaki_pair(
        jnp.asarray(x_sl).astype(jnp.bfloat16),
        jnp.asarray(c_sl).astype(jnp.bfloat16), epb=128, interpret=True)
    return np.asarray(hi), np.asarray(lo)


def _port(fn, x_sl, c_sl):
    hi, lo = fn(torch.from_numpy(x_sl).bfloat16(),
                torch.from_numpy(c_sl).bfloat16())
    assert hi.dtype == lo.dtype == torch.float32
    return hi.numpy(), lo.numpy()


@pytest.mark.parametrize("k", [1, 9, 49, 169, 343, 729, 961])
def test_slice_params_and_split_match_jax(k):
    assert ozaki.slice_params(k) == jax_ozaki.slice_params(k)
    w, t = ozaki.slice_params(k)
    assert w * t >= 53 and t * k * 2 ** (2 * w) < 2 ** 24
    x = np.random.default_rng(k).standard_normal((k, 37)) * 3.7
    sl, scale = ozaki.split_f64_np(x, w, t)
    jsl, jscale = jax_ozaki.split_f64_np(x, w, t)
    assert scale == jscale and sl.dtype == jsl.dtype == np.float32
    np.testing.assert_array_equal(sl, jsl)


def test_slice_params_refuses_too_deep():
    with pytest.raises(ValueError, match="too deep"):
        ozaki.slice_params(2 ** 16)


@pytest.mark.parametrize("shape,w,t", [((5, 64), 7, 8), ((343, 40), 6, 9),
                                       ((1, 1), 5, 11)])
def test_torch_split_matches_jax_split(shape, w, t):
    """split_f64 on a torch f64 tensor equals the JAX package's split_f64
    (and so split_f64_np) bit for bit, bf16 slices and scale."""
    x = np.random.default_rng(sum(shape)).standard_normal(shape) * 2.37
    sl, scale = ozaki.split_f64(torch.from_numpy(x), w, t)
    jsl, jscale = jax_ozaki.split_f64(jnp.asarray(x), w, t)
    assert sl.dtype == torch.bfloat16 and isinstance(scale, float)
    assert scale == float(jscale)
    np.testing.assert_array_equal(sl.float().numpy(),
                                  np.asarray(jsl, np.float32))
    np_sl, np_scale = ozaki.split_f64_np(x, w, t)
    assert np_scale == scale
    np.testing.assert_array_equal(sl.float().numpy(), np_sl)


def test_split_zero_and_tiny():
    z, scale = ozaki.split_f64(torch.zeros(4, 128, dtype=torch.float64), 7,
                               8)
    assert not z.float().abs().max() and np.isfinite(scale)
    x = np.random.default_rng(1).standard_normal((4, 128)) * 1e-200
    for sl, scale in (ozaki.split_f64(torch.from_numpy(x), 7, 8),
                      ozaki.split_f64_np(x, 7, 8)):
        s64 = np.asarray(torch.as_tensor(sl).double())
        assert np.all(s64 == np.round(s64)) and np.abs(s64).max() <= 2 ** 7
        rec = scale * sum(s64[i] * 2.0 ** (-7 * (i + 1)) for i in range(8))
        # absolute, as in the JAX package: |rec - x| < scale * 2^-(wT+1)
        assert np.abs(rec - x).max() <= scale * 2.0 ** -56


@pytest.mark.parametrize("name", [*RANDOM_SHAPES, "b04 nq=8^2",
                                  "b05 nq=8^3"])
def test_pair_and_band_match_jax_bit_for_bit(name):
    """Both forms, plain on the CPU, against the JAX kron_ozaki_pair in
    interpret mode: hi and lo equal bit for bit."""
    c = _operator(name)
    x = np.random.default_rng(7).standard_normal((c.shape[1], E))
    x_sl, c_sl, _ = _slices(c, x)
    want = _jax_pair(x_sl, c_sl)
    for fn in (ozaki.kron_ozaki_pair, ozaki.kron_ozaki_band):
        got = _port(fn, x_sl, c_sl)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("t_c,t_x", [(5, 8), (8, 6)])
def test_band_form_with_unequal_slice_counts(t_c, t_x):
    """T_c != T_x: the band form bounds s by both counts, so it equals
    the port's pair form and the JAX pair kernel (whose band kernel
    bounds both indices by T_x and is not the reference here), and
    (hi, lo) holds every kept slice product exactly."""
    c = _operator((49, 64))
    x = np.random.default_rng(3).standard_normal((49, E))
    x_sl, c_sl, _ = _slices(c, x, t_c, t_x)
    pair = _port(ozaki.kron_ozaki_pair, x_sl, c_sl)
    band = _port(ozaki.kron_ozaki_band, x_sl, c_sl)
    want = _jax_pair(x_sl, c_sl)
    for got in (pair, band):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    w, _ = ozaki.slice_params(49)
    exact = sum(c_sl[s].astype(np.float64) @ x_sl[t].astype(np.float64)
                * 2.0 ** (-w * (s + t + 2))
                for s in range(t_c) for t in range(t_x)
                if s + t < max(t_c, t_x))
    got = pair[0].astype(np.float64) + pair[1].astype(np.float64)
    assert np.abs(got - exact).max() <= 2.0 ** -44 * np.abs(exact).max()


@pytest.mark.parametrize("m,k", [(64, 49), (512, 343), (1000, 729)])
def test_kron_coalesced_f64_matches_numpy(m, k):
    rng = np.random.default_rng(2)
    c, x = rng.standard_normal((m, k)), rng.standard_normal((k, E))
    out = ozaki.kron_coalesced_f64(torch.from_numpy(x), torch.from_numpy(c))
    assert out.dtype == torch.float64
    ref = c @ x
    rel = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
    assert rel < 5e-14, rel
    w, t = ozaki.slice_params(k)
    split = ozaki.split_f64(torch.from_numpy(c), w, t)
    again = ozaki.kron_coalesced_f64(torch.from_numpy(x), None,
                                     c_split=split)
    assert torch.equal(again, out)


@pytest.mark.parametrize("name", ["b04 nq=8^2", "b05 nq=8^3"])
def test_pair_norm_matches_f64_norm(name, monkeypatch):
    c = _operator(name)
    x = np.random.default_rng(4).standard_normal((c.shape[1], E))
    x_sl, c_sl, scale = _slices(c, x)
    pair = ozaki.kron_ozaki_pair(torch.from_numpy(x_sl).bfloat16(),
                                 torch.from_numpy(c_sl).bfloat16())
    want = float(np.linalg.norm(c @ x))
    assert abs(ozaki.pair_norm(pair, scale) - want) / want < 1e-13
    # a few rows at a time: the same norm
    monkeypatch.setattr(ozaki, "_NORM_CHUNK", 3 * E)
    assert abs(ozaki.pair_norm(pair, scale) - want) / want < 1e-13


def test_wrappers_reject_bad_input():
    x, c = torch.zeros(8, 49, 128), torch.zeros(8, 64, 49)
    with pytest.raises(TypeError, match="bf16"):
        ozaki.kron_ozaki_pair(x, c)
    with pytest.raises(ValueError, match="are not"):
        ozaki.kron_ozaki_band(x.bfloat16(), c[:, :, 1:].bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        ozaki.kron_ozaki_pair(x.bfloat16().transpose(1, 2).contiguous()
                              .transpose(1, 2), c.bfloat16())
    with pytest.raises(ValueError, match="no kernel for device"):
        ozaki.kron_ozaki_pair(x.bfloat16().to("meta"),
                              c.bfloat16().to("meta"))


@pytest.mark.parametrize("bench,nq", [(b04, (8, 8)), (b05, (8, 8, 8)),
                                      (b05, (3, 4, 5))])
def test_prepared_slices_recombine_to_the_element_stream(bench, nq):
    """prepare_f64_tier's in_slices and c_slices are split_f64_np's slices
    of in_coa and C_coa; recombined, in_slices equal in_coa to
    2^-(wT+1) of the scale, and the padding columns are zero."""
    nelmt = 200  # e_pad 256
    cfg = Config(dtype=torch.float64, device="cpu", f64_coales="ozaki")
    data = bench.prepare(*nq, nelmt, cfg)
    in_coa, x_sl = data["in_coa"].numpy(), data["in_slices"]
    c_coa = data["c_coa3" if bench is b05 else "c_coa"].numpy()
    w, t = ozaki.slice_params(in_coa.shape[0])
    assert x_sl.dtype == data["c_slices"].dtype == torch.bfloat16
    assert tuple(x_sl.shape) == (t, *in_coa.shape)
    assert not x_sl[:, :, nelmt:].float().abs().max()
    x_want, s_x = jax_ozaki.split_f64_np(in_coa, w, t)
    c_want, s_c = jax_ozaki.split_f64_np(c_coa, w, t)
    assert data["oz_scale"] == s_c * s_x
    np.testing.assert_array_equal(x_sl.float().numpy(), x_want)
    np.testing.assert_array_equal(data["c_slices"].float().numpy(), c_want)
    s64 = x_sl.double().numpy()
    rec = s_x * sum(s64[i] * 2.0 ** (-w * (i + 1)) for i in range(t))
    assert np.abs(rec - in_coa).max() <= s_x * 2.0 ** -(w * t + 1)
