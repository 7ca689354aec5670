"""The port's kernels/bwdtrans2d.py against the JAX package's Pallas
kernels in interpret mode, on kron and random dense operators and
numpy-seeded random per-element inputs: kron_blocked, kron_coalesced and
kron_elem_major,
and benchmark04's kernels (kron_wide4, kron_vpu_blocked, qp_shared, qp_w,
qp_w_flat, qp_mxu_grouped, qp_global, qp1d_shared, qp1d_global) against the
port's calls that serve them: k2.kron_wide4, K1 (k1.qp_shared3d and
k1.qp_shared3d_flat), k1.qp_global3d, k1.qp1d_fused and k2.qp1d_global.
K2's rule between its C-resident and dense configurations (kron_config)
is held at every order both benchmarks sweep."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bwdtrans3d import card_agree
from tpu_bench.kernels import bwdtrans2d as pl_bt2d
from tpu_bench.utils import native
from tpu_bench_torch.kernels import build
from tpu_bench_torch.kernels import bwdtrans2d as k2
from tpu_bench_torch.kernels import bwdtrans3d as k1

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


def _kron_operator_2d(nq, dtype):
    """C_coa = kron(B1, B0)^T, (nqTot, nmTot), from the cos basis."""
    b = native.init_cos((nq - 1) * nq).reshape(nq - 1, nq)
    return np.ascontiguousarray(np.kron(b, b).T, dtype=dtype)


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 5e-6),
                                        (np.float64, 1e-13)])
@pytest.mark.parametrize("op", ["b04 nq=8^2", "b05 nq=8^3"])
def test_kron_coalesced_matches_jax(op, dtype, rtol):
    """The flat coalesced layout (nmTot, E) through K2's (1, nmTot, E)
    view, at the b04 nq=8^2 and b05 nq=8^3 operators."""
    c = (_kron_operator_2d(8, dtype) if op.startswith("b04")
         else _kron_operator(8, dtype))
    x = np.random.default_rng(21).standard_normal(
        (c.shape[1], 2 * CE)).astype(dtype)
    ref = np.asarray(pl_bt2d.kron_coalesced(
        jnp.asarray(x), jnp.asarray(c), epb=CE, interpret=True,
        precision=jax.lax.Precision.HIGHEST))
    out = k2.kron_coalesced(torch.from_numpy(x), torch.from_numpy(c),
                            epb=CE).numpy()
    assert out.shape == ref.shape == (c.shape[0], 2 * CE)
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())
    with pytest.raises(ValueError, match="is not"):
        k2.kron_coalesced(torch.from_numpy(x)[None], torch.from_numpy(c))


def test_em_gemm_rejects_bad_input():
    x, s = torch.zeros(CE, 27), torch.zeros(27, 64)
    out = k2.kron_elem_major(x.bfloat16(), s.bfloat16())  # bf16 runs
    assert out.dtype == torch.bfloat16 and out.shape == (CE, 64)
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
    out = k2.kron_blocked(x.bfloat16(), c.bfloat16())  # bf16 runs
    assert out.dtype == torch.bfloat16
    assert out.shape == (NBLK, c.shape[0], CE)
    with pytest.raises(ValueError):
        k2.kron_blocked(x[:, 1:], c)
    with pytest.raises(TypeError):
        k2.kron_blocked(x, c.double())
    with pytest.raises(ValueError, match="no kernel for device"):
        k2.kron_blocked(x.to("meta"), c.to("meta"))


# ---- benchmark04's kernels -------------------------------------------------

# f32: both sides sum the same products in other orders; f64: to rounding.
TOLS = [(np.float32, 1e-5), (np.float64, 1e-12)]
HIGHEST = jax.lax.Precision.HIGHEST


def _close(out, ref, rtol):
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _qp_inputs(nq, dtype, seed, e=CE):
    """in (nm0, nm1, E), b0 (nm0, nq0), b1t (nq1, nm1), random."""
    nq0, nq1 = nq
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((nq0 - 1, nq1 - 1, e)).astype(dtype),
            rng.standard_normal((nq0 - 1, nq0)).astype(dtype),
            rng.standard_normal((nq1, nq1 - 1)).astype(dtype))


def _pad_rows(m, mult=8):
    """m with zero rows appended up to a multiple of mult (the JAX
    package's sublane-padded B1^T)."""
    return np.concatenate([m, np.zeros((-m.shape[0] % mult, m.shape[1]),
                                       m.dtype)])


@pytest.mark.parametrize("dtype,rtol", TOLS)
@pytest.mark.parametrize("name,nq", [("kron_wide4", (4, 4)),
                                     ("kron_wide4", (8, 8)),
                                     ("kron_vpu_blocked", (2, 2)),
                                     ("kron_vpu_blocked", (3, 3))])
def test_kron_4d_matches_jax(name, nq, dtype, rtol):
    """The 4D chunk layout (nblk, nmTot, ce/128, 128) through K2: both
    JAX kernels compute the one function kron_wide4 serves."""
    nm_tot, nq_tot = (nq[0] - 1) * (nq[1] - 1), nq[0] * nq[1]
    rng = np.random.default_rng(nm_tot)
    x = rng.standard_normal((NBLK, nm_tot, 2, 128)).astype(dtype)
    c = rng.standard_normal((nq_tot, nm_tot)).astype(dtype)
    ref = np.asarray(getattr(pl_bt2d, name)(
        jnp.asarray(x), jnp.asarray(c), interpret=True, precision=HIGHEST))
    out = k2.kron_wide4(torch.from_numpy(x), torch.from_numpy(c))
    assert tuple(out.shape) == ref.shape == (NBLK, nq_tot, 2, 128)
    _close(out.numpy(), ref, rtol)


@pytest.mark.parametrize("dtype,rtol", TOLS)
@pytest.mark.parametrize("nq", [(4, 4), (8, 8), (3, 5)])
def test_qp_shared_matches_jax(nq, dtype, rtol):
    x, b0, b1t = _qp_inputs(nq, dtype, seed=10)
    ref = np.asarray(pl_bt2d.qp_shared(
        jnp.asarray(x), jnp.asarray(b0), jnp.asarray(b1t), epb=CE,
        interpret=True, precision=HIGHEST))
    out = k1.qp_shared3d(*map(torch.from_numpy, (x, b0, b1t)))
    assert tuple(out.shape) == ref.shape == (nq[0], nq[1], CE)
    _close(out.numpy(), ref, rtol)


@pytest.mark.parametrize("dtype,rtol", TOLS)
@pytest.mark.parametrize("nq", [(11, 11), (10, 12)])
def test_qp_w_matches_jax(nq, dtype, rtol):
    """B1^T zero-padded to 16 rows (nq1 = 11, 12) for the JAX kernel; K1
    takes its first nq1 rows."""
    x, b0, b1t = _qp_inputs(nq, dtype, seed=11)
    b1tp = _pad_rows(b1t)
    assert b1tp.shape[0] == 16
    ref = np.asarray(pl_bt2d.qp_w(
        jnp.asarray(x), jnp.asarray(b0), jnp.asarray(b1tp), nq1=nq[1],
        epb=CE, interpret=True, precision=HIGHEST))
    out = k1.qp_shared3d(*map(torch.from_numpy, (x, b0, b1tp[:nq[1]])))
    _close(out.numpy(), ref, rtol)


@pytest.mark.parametrize("dtype,rtol", TOLS)
def test_qp_w_flat_matches_jax(dtype, rtol):
    """Both kernels given the p-major flat layout (nm0*nm1, E); the JAX
    column instead hands its kernel the q-major in_coa (ROADMAP Queue 3),
    so this holds the kernels, not the columns, against each other."""
    x, b0, b1t = _qp_inputs((11, 11), dtype, seed=12)
    flat, b1tp = x.reshape(-1, CE), _pad_rows(b1t)
    ref = np.asarray(pl_bt2d.qp_w_flat(
        jnp.asarray(flat), jnp.asarray(b0), jnp.asarray(b1tp), nm1=10,
        nq1=11, epb=CE, interpret=True, precision=HIGHEST))
    out = k1.qp_shared3d_flat(*map(torch.from_numpy, (flat, b0, b1tp[:11])),
                              nrq=10)
    assert tuple(out.shape) == ref.shape == (121, CE)
    _close(out.numpy(), ref, rtol)


@pytest.mark.parametrize("dtype,rtol", TOLS)
def test_qp_mxu_grouped_matches_jax(dtype, rtol):
    """nq=32: the JAX kernel takes the p-grouped layout and block-diagonal
    operators (g=2, nm0=31 zero-padded to 32) and returns (nq1, nq0, E);
    the port takes in_pcoa3 and returns (nq0, nq1, E)."""
    g, nq = 2, 32
    x, b0, b1t = _qp_inputs((nq, nq), dtype, seed=13)
    nm = nq - 1
    xp = np.concatenate([x, np.zeros((1, nm, CE), dtype)])  # p to 32
    in_g3 = xp.reshape(nq // g, g * nm, CE)
    b0t_p = np.concatenate([b0.T, np.zeros((nq, 1), dtype)], axis=1)
    s1g, s2g = (np.kron(np.eye(g, dtype=dtype), m) for m in (b1t, b0t_p))
    ref = np.asarray(pl_bt2d.qp_mxu_grouped(
        jnp.asarray(in_g3), jnp.asarray(s1g), jnp.asarray(s2g), nq0=nq,
        nq1=nq, g=g, epb=CE, interpret=True, precision=HIGHEST))
    out = k1.qp_shared3d(*map(torch.from_numpy, (x, b0, b1t)))
    assert ref.shape == (nq, nq, CE)
    _close(out.numpy(), ref.transpose(1, 0, 2), rtol)


@pytest.mark.parametrize("dtype,rtol", TOLS)
@pytest.mark.parametrize("nq", [(8, 8), (3, 5), (32, 32)])
def test_qp_global_matches_jax(nq, dtype, rtol):
    """K2 then K4; nq=32 has nm0 = 31, K4's 32 bucket on the card."""
    x, b0, b1t = _qp_inputs(nq, dtype, seed=14)
    ref = np.asarray(pl_bt2d.qp_global(
        jnp.asarray(x), jnp.asarray(b0), jnp.asarray(b1t), epb=CE,
        interpret=True, precision=HIGHEST))
    out = k1.qp_global3d(*map(torch.from_numpy, (x, b0, b1t)))
    assert tuple(out.shape) == ref.shape
    _close(out.numpy(), ref, rtol)


@pytest.mark.parametrize("dtype,rtol", TOLS)
@pytest.mark.parametrize("nq", [(4, 4), (8, 8), (3, 5), (32, 32)])
@pytest.mark.parametrize("name", ["qp1d_shared", "qp1d_global"])
def test_qp1d_matches_jax(name, nq, dtype, rtol):
    """Random dense stage operators of the 2D widths: (nmTot, nm1*nq0) and
    (nm1*nq0, nqTot); at nq=32 those are 961, 992 and 1024 wide."""
    nq0, nq1 = nq
    widths = ((nq0 - 1) * (nq1 - 1), (nq1 - 1) * nq0, nq0 * nq1)
    rng = np.random.default_rng(sum(nq))
    x = rng.standard_normal((CE, widths[0])).astype(dtype)
    s1, s2 = (rng.standard_normal((k, n)).astype(dtype)
              for k, n in zip(widths, widths[1:]))
    ref = np.asarray(getattr(pl_bt2d, name)(
        jnp.asarray(x), jnp.asarray(s1), jnp.asarray(s2), epb=CE,
        interpret=True, precision=HIGHEST))
    port = {"qp1d_shared": k1.qp1d_fused, "qp1d_global": k2.qp1d_global}
    out = port[name](*map(torch.from_numpy, (x, s1, s2)))
    assert tuple(out.shape) == ref.shape == (CE, widths[2])
    _close(out.numpy(), ref, rtol)


def test_2d_wrappers_reject_bad_input():
    x, b0, b1t = map(torch.from_numpy, _qp_inputs((4, 4), np.float32, 15))
    with pytest.raises(ValueError, match="contiguous"):
        k2.kron_wide4(torch.zeros(2, 9, 128, 2).transpose(2, 3),
                      torch.zeros(16, 9))
    with pytest.raises(ValueError, match="contiguous"):
        k2.kron_wide4(torch.zeros(9, 256), torch.zeros(16, 9))
    with pytest.raises(ValueError):
        k1.qp_shared3d(x, b0, b1t[:, :-1].contiguous())
    out = k1.qp_global3d(x.bfloat16(), b0.bfloat16(), b1t.bfloat16())
    assert out.dtype == torch.bfloat16  # bf16 runs
    em, s = torch.zeros(CE, 9), torch.zeros(9, 12)
    with pytest.raises(ValueError, match="do not chain"):
        k1.qp1d_fused(em, s, s)
    with pytest.raises(ValueError, match="element tiles"):
        k1.qp1d_fused(em, s, s.T.contiguous(), epb=4)
    meta = [t.to("meta") for t in (em, s, s.T.contiguous())]
    with pytest.raises(ValueError, match="no kernel for device"):
        k1.qp1d_fused(*meta)


# ---- K2's configurations (kernels/bwdtrans2d.kron_config) ------------------

# K2's products (M, K) at every benchmark05 order 2^3 .. 10^3 (Pallas(QP)
# stage 1 and the kron) and every benchmark04 order of scripts/run04.sh
# (stage 1 and kron_wide4)
K2_PRODUCTS = ([(f"b05 nq={n}^3 {use}", shape) for n in range(2, 11)
                for use, shape in (("QP stage 1", (n * n, (n - 1) ** 2)),
                                   ("kron", (n ** 3, (n - 1) ** 3)))]
               + [(f"b04 nq={n}^2 {use}", shape)
                  for n in (2, 4, 6, 8, 10, 12, 14, 16, 32)
                  for use, shape in (("QP stage 1", (n, n - 1)),
                                     ("kron", (n * n, (n - 1) ** 2)))])


@pytest.mark.parametrize("itemsize", [2, 4, 8])
@pytest.mark.parametrize("label,shape", K2_PRODUCTS)
def test_kron_config_fits_the_card(label, shape, itemsize):
    """kron_config gives 0 (dense) or a strip width of KRON_STRIPS whose
    C^T and ring fit 232,448 B, whole 4-column micro-tiles; the resident
    configuration is taken wherever some strip fits."""
    m, k = shape
    bn = k2.kron_config(itemsize, m, k)
    fits = [w for w in k2.KRON_STRIPS
            if k2.kron_resident_smem(itemsize, m, k, w) <= 232448]
    assert bool(bn) == bool(fits)
    if bn:
        assert bn in fits and bn % k2.KRON_TILE == 0


def test_kron_config_rule():
    """The narrowest strip whose 4 x 4 micro-tiles fill the 256 threads
    (512 for M = 8, 64 for M = 64), narrowed until C^T and the ring fit;
    the threshold at K = 128 in f32 lies where C^T and a ring of 64-wide
    strips pass 232,448 B."""
    assert k2.kron_config(4, 8, 7) == 512
    assert k2.kron_config(4, 64, 49) == 64
    assert k2.kron_config(4, 20, 12) == 256
    assert k2.kron_config(4, 512, 343) == 0
    assert k2.kron_resident_smem(4, 64, 49, 64) == 4 * (49 * 64 + 3 * 49 * 64)
    assert k2.kron_resident_smem(8, 6, 7, 512) == 8 * (7 * 8 + 3 * 7 * 512)
    # 4 * (128 * M + 3 * 128 * 64) <= 232448 up to M = 260
    assert k2.kron_config(4, 260, 128) == 64
    assert k2.kron_config(4, 264, 128) == 0
    # a strip that does not fit is narrowed: M = 16 fills the block at 256
    # columns, which do not fit at K = 100 in f32; 128 do
    assert k2.kron_resident_smem(4, 16, 100, 256) > 232448
    assert k2.kron_config(4, 16, 100) == 128


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16], ids=["f32", "f64",
                                                         "bf16"])
@pytest.mark.parametrize("kernel", ["kron_blocked", "em_gemm"])
def test_launch_passes_the_rule_configuration(monkeypatch, kernel, dtype):
    """The wrapper decides the configuration and the kernel runs what it is
    given: with the knob None, _launch (K2) and _em_launch (K3) pass
    kron_config's or em_config's choice (0, dense, for the b05 nq=8^3
    product; a resident width for the b04 nq=8^2 one), a given knob (0 or
    a resident width other than the rule's) as it is, and never a
    negative value, on launches into a stand-in for the library; K2 passes
    its dense body after it (1, wgmma, for the f32 dense launches, whose
    rows of 40 values are whole 16-byte words; else 0)."""
    calls = []
    monkeypatch.setattr(build, "run", lambda *args: calls.append(args))
    monkeypatch.setattr(build, "smem_limits",
                        lambda index: (232448, 233472))
    size = dtype.itemsize
    if kernel == "kron_blocked":
        dense = (torch.zeros(1, 343, 40, dtype=dtype),
                 torch.zeros(512, 343, dtype=dtype))
        resident = (torch.zeros(7, 49, 40, dtype=dtype),
                    torch.zeros(64, 49, dtype=dtype))
        rule = k2.kron_config(size, 64, 49)
        assert k2.kron_config(size, 512, 343) == 0
        other = 128

        def launch(ops, knob):
            return k2._launch(ops[0], ops[1], knob)
    else:
        dense = (torch.zeros(40, 343, dtype=dtype),
                 torch.zeros(343, 512, dtype=dtype))
        resident = (torch.zeros(40, 49, dtype=dtype),
                    torch.zeros(49, 64, dtype=dtype))
        rule = k2.em_config(size, 49, 64)
        assert k2.em_config(size, 343, 512) == 0
        other = 32

        def launch(ops, knob):
            return k2._em_launch("one_stage_em", ops[0], ops[1], knob)
    assert rule > 0 and other != rule
    for ops, knob in ((dense, None), (dense, 0), (resident, None),
                      (resident, 0), (resident, other)):
        launch(ops, knob)
    assert [args[0] for args in calls] == [kernel] * 5
    if kernel == "kron_blocked":
        wgmma = int(dtype == torch.float32)
        assert [args[-1] for args in calls] == [wgmma, wgmma, 0, wgmma, 0]
        calls = [args[:-1] for args in calls]
    assert [args[-1] for args in calls] == [0, 0, rule, 0, other]


def test_kron_blocked_rejects_unknown_strip():
    c = torch.from_numpy(_kron_operator(4, np.float32))
    x = torch.zeros(NBLK, c.shape[1], CE)
    with pytest.raises(ValueError, match="strip=96"):
        k2.kron_blocked(x, c, strip=96)
    assert torch.equal(k2.kron_blocked(x, c, strip=0),
                       k2.kron_blocked_plain(x, c))


@pytest.mark.cuda
@pytest.mark.parametrize("itemsize", [2, 4, 8])
def test_kron_blocked_both_configs_on_card(itemsize):
    """K2 in both configurations against its plain version on E = 1000 and
    131071 columns (neither a multiple of a strip or a tile): Pallas(QP)
    stage 1 at b05 nq=8^3 at every strip and dense, the b05 nq=8^3 kron
    (dense), C (M x 128) just either side of the C-resident threshold,
    and the dense tile's edges, C of 512 and 500 rows by K = 343 and 344;
    the dense body's cases: the b05 nq=8^3 kron at ce 8192, the b04 dense
    orders 16^2 and 32^2 and kron_coalesced at b05 (one chunk of 131072),
    each on the body dense_body gives (in f32 the wgmma body; E = 131071
    and in off a 16-byte boundary fall back to mma.sync, counted), and
    in f32 each wgmma case again with in copied one value off a 16-byte
    boundary, which takes it to the mma.sync body;
    1e-5 (f32), 1e-12 (f64), 2^-7 (bf16), relative to the largest
    output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dtype = {2: torch.bfloat16, 4: torch.float32, 8: torch.float64}[itemsize]
    tol = {2: 2**-7, 4: 1e-5, 8: 1e-12}[itemsize]
    gen = torch.Generator(device="cuda").manual_seed(itemsize)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    threshold = 4
    while k2.kron_config(itemsize, threshold + 4, 128):
        threshold += 4
    for e in (1000, 131071):
        cases = [(rnd(7, 49, e), rnd(64, 49), w)
                 for w in (None, 0, *k2.KRON_STRIPS)
                 if not w or k2.kron_resident_smem(itemsize, 64, 49, w)
                 <= 232448]
        cases += [(rnd(1, 343, e), rnd(512, 343), None)]
        cases += [(rnd(2, 128, e), rnd(m, 128), None)
                  for m in (threshold, threshold + 4)]
        # the dense tile's edges: M 512 and 500 (not a multiple of 128), K
        # 343 (8-byte copies) and 344, chunks of E columns (not a multiple
        # of 64)
        cases += [(rnd(2, k, e), rnd(m, k), None)
                  for m in (512, 500) for k in (343, 344)]
        for x, c, w in cases:
            card_agree(k2.kron_blocked(x, c, strip=w),
                       k2.kron_blocked_plain(x, c), dtype, tol,
                       (tuple(c.shape), e, w))
    dense = [(rnd(2, k, e), rnd(m, k)) for e in (1000, 131071)
             for m in (512, 500) for k in (343, 344)]
    dense += [(rnd(16, 343, 8192), rnd(512, 343)),
              (rnd(3, 225, 8192), rnd(256, 225)),
              (rnd(2, 961, 8192), rnd(1024, 961))]
    # in one value off a 16-byte boundary
    dense += [(rnd(2 * 343 * 1000 + 1)[1:].view(2, 343, 1000),
               rnd(512, 343))]
    for x, c in dense:
        body = k2.dense_body(dtype, x.shape[2], x.data_ptr())
        assert body == ("wgmma" if itemsize == 4 and x.shape[2] % 4 == 0
                        and x.data_ptr() % 16 == 0 else "mma")
        before = k2.dense_bodies[(build.SUFFIXES[dtype], body)]
        ref = k2.kron_blocked_plain(x, c)
        card_agree(k2.kron_blocked(x, c, strip=0), ref, dtype, tol,
                   (tuple(x.shape), tuple(c.shape), body))
        assert k2.dense_bodies[(build.SUFFIXES[dtype], body)] == before + 1
        if body == "wgmma":
            off = torch.empty(x.numel() + 1, dtype=dtype,
                              device="cuda")[1:].view(x.shape)
            off.copy_(x)
            assert k2.dense_body(dtype, x.shape[2], off.data_ptr()) == "mma"
            card_agree(k2.kron_blocked(off, c, strip=0), ref, dtype, tol,
                       (tuple(x.shape), tuple(c.shape), "mma"))
    x, c = rnd(343, 131072), rnd(512, 343)
    card_agree(k2.kron_coalesced(x, c), k2.kron_coalesced_plain(x, c), dtype,
               tol, ("kron_coalesced", tuple(x.shape)))


# ---- K2's dense bodies (kernels/bwdtrans2d.dense_body) ---------------------

@pytest.mark.parametrize("dtype,ce,offset,body", [
    (torch.float32, 8192, 0, "wgmma"), (torch.float32, 1000, 0, "wgmma"),
    (torch.float32, 131072, 0, "wgmma"), (torch.float32, 131071, 0, "mma"),
    (torch.float32, 8192, 4, "mma"), (torch.float32, 8192, 8, "mma"),
    (torch.float64, 8192, 0, "mma"), (torch.bfloat16, 8192, 0, "mma")],
    ids=["f32-8192", "f32-1000", "f32-131072", "f32-ragged",
         "f32-off4", "f32-off8", "f64", "bf16"])
def test_dense_body_rule(dtype, ce, offset, body):
    """The wgmma body for f32 whose rows of in[b] the TMA can read (ce a
    multiple of 4, in on a 16-byte boundary); mma.sync for f64, bf16,
    ragged rows and in off a 16-byte boundary."""
    assert k2.dense_body(dtype, ce, 1 << 20 | offset) == body


def _dense_f32_products():
    """K2's products that run the dense configuration in f32, at every
    order K2_PRODUCTS holds."""
    return [(label, shape) for label, shape in K2_PRODUCTS
            if not k2.kron_config(4, *shape)]


@pytest.mark.parametrize("label,shape", _dense_f32_products())
def test_wgmma_tile_fits_the_card(label, shape):
    """K2's f32 body on wgmma (WGMMA_F32), the one tile of every product
    that runs dense in f32: a ring of three stages (C's big and small
    halves, 2 x 16,512 B; in's tile, 17,408 B), two consumer groups'
    staging (2 x 34,816 B) and six mbarriers, 220,976 B, fit the 232,448 B
    a block may opt in to; two consumer warp groups of 64 elements on
    wgmma's m64n128k8 and a producer group; the pads keep the fragment
    loads and stores conflict-free."""
    t = k2.WGMMA_F32
    assert k2.wgmma_smem(t) == 4 * (3 * (2 * 8 * (128 * 4 + 4) + 32 * 136)
                                    + 2 * 128 * 68) + 48 == 220976
    assert k2.wgmma_smem(t) <= 232448
    assert t.threads == 3 * 128 and t.be == 2 * 64
    assert t.bm % 8 == 0 and t.bm <= 256 and t.bk % 8 == 0
    # in's rows 8 mod 32 banks apart, the staging's 4 mod 16, the halves'
    # k groups 4 banks past a whole number of 32
    assert (t.be + t.in_pad) % 32 == 8 and (t.be // 2 + t.out_pad) % 16 == 4
    assert (t.bm * 4 + t.c_pad) % 32 == 4
    assert shape[0] > 0 and shape[1] > 0, label


@pytest.mark.parametrize("dtype,shape,offset,c_rows,flag,counted", [
    (torch.float32, (1, 343, 40), 0, 512, 1, ("f32", "wgmma")),
    (torch.float32, (1, 343, 41), 0, 512, 0, ("f32", "mma")),
    (torch.float32, (1, 343, 40), 1, 512, 0, ("f32", "mma")),
    (torch.float64, (1, 343, 40), 0, 512, 0, ("f64", "mma")),
    (torch.bfloat16, (1, 343, 40), 0, 512, 0, ("bf16", "mma")),
    (torch.float32, (7, 49, 40), 0, 64, 0, None)],
    ids=["f32", "f32-ragged", "f32-off4", "f64", "bf16", "resident"])
def test_dense_body_of_each_launch(monkeypatch, dtype, shape, offset, c_rows,
                                   flag, counted):
    """Each K2 launch passes the body dense_body gives for its input (1,
    wgmma, for f32 rows of whole 16-byte words on a 16-byte boundary; else
    0) and is counted in dense_bodies by (dtype, body) if it runs the
    dense configuration: a ragged row, in one value off a 16-byte
    boundary, f64 and bf16 take mma.sync; a C-resident launch is not
    counted."""
    calls = []
    monkeypatch.setattr(build, "run", lambda *args: calls.append(args))
    monkeypatch.setattr(build, "smem_limits",
                        lambda index: (232448, 233472))
    monkeypatch.setattr(k2, "dense_bodies", collections.Counter())
    n = int(np.prod(shape))
    x = torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)
    c = torch.zeros(c_rows, shape[1], dtype=dtype)
    k2._launch(x, c, None)
    assert len(calls) == 1 and calls[0][-1] == flag
    assert (calls[0][-2] == 0) == (counted is not None)
    assert k2.dense_bodies == ({counted: 1} if counted else {})


# ---- K3's configurations (kernels/bwdtrans2d.em_config) --------------------

def _em_products():
    """K3's products (K, N) at every benchmark05 order 2^3 .. 10^3 and
    (3,4,5), and every benchmark04 order of scripts/run04.sh and (10, 12):
    kron_elem_major (nmTot x nqTot) and each QP-1D stage."""
    products = []
    for nq in [(n, n, n) for n in range(2, 11)] + [(3, 4, 5)]:
        nm = [n - 1 for n in nq]
        widths = [nm[0] * nm[1] * nm[2], nm[2] * nm[1] * nq[0],
                  nm[2] * nq[1] * nq[0], nq[0] * nq[1] * nq[2]]
        products.append((f"b05 nq={nq} kron", (widths[0], widths[-1])))
        products += [(f"b05 nq={nq} QP-1D stage {i + 1}", kn)
                     for i, kn in enumerate(zip(widths, widths[1:]))]
    for nq in [(n, n) for n in (2, 4, 6, 8, 10, 12, 14, 16, 32)] + [(10, 12)]:
        nm = [n - 1 for n in nq]
        widths = [nm[0] * nm[1], nm[1] * nq[0], nq[0] * nq[1]]
        products.append((f"b04 nq={nq} kron", (widths[0], widths[-1])))
        products += [(f"b04 nq={nq} QP-1D stage {i + 1}", kn)
                     for i, kn in enumerate(zip(widths, widths[1:]))]
    return products


@pytest.mark.parametrize("itemsize", [2, 4, 8])
@pytest.mark.parametrize("label,shape", _em_products())
def test_em_config_fits_the_card(label, shape, itemsize):
    """em_config gives 0 (dense) or a tile height of EM_TILES whose S and
    ring fit 232,448 B, whole warp units of rows; S is resident wherever
    some tile height fits."""
    k, n = shape
    be = k2.em_config(itemsize, k, n)
    fits = [h for h in k2.EM_TILES
            if k2.em_resident_smem(itemsize, k, n, h) <= 232448]
    assert bool(be) == bool(fits)
    if be:
        assert be in fits and be % k2.EM_UNIT[0] == 0


def _dense_f64_products():
    """K2's and K3's products that run the dense configuration in f64, at
    every order K2_PRODUCTS and _em_products hold."""
    k2_dense = [(f"K2 {label}", shape) for label, shape in K2_PRODUCTS
                if not k2.kron_config(8, *shape)]
    k3_dense = [(f"K3 {label}", shape) for label, shape in _em_products()
                if not k2.em_config(8, *shape)]
    return k2_dense + k3_dense


@pytest.mark.parametrize("label,shape", _dense_f64_products())
def test_dense_f64_tile_fits_the_card(label, shape):
    """The f64 dense tile (DENSE_F64), the one tile of every product that
    runs dense in f64: its ring of padded A and B tiles, 66,048 B, fits the
    232,448 B a block may opt in to, twice over in an SM's 233,472 (1 KB a
    block reserved), and it is whole m16n8k8 tiles: rows of 16, columns of
    pairs of 8 (a 16-byte load of B feeds two), depth of 8."""
    t = k2.DENSE_F64
    assert t.mma == (16, 8, 8)
    smem = k2.dense_smem(t)
    assert smem == 8 * 2 * (128 * 24 + 16 * 66) == 66048
    assert smem <= 232448 and t.blocks * (smem + 1024) <= 233472
    assert t.bm % t.mma[0] == 0 and t.bn % (2 * t.mma[1]) == 0
    assert t.bk % t.mma[2] == 0
    # the rows' pads keep 16-byte rows and conflict-free fragment loads: A
    # rows 8 mod 16 bank pairs apart, B rows 2 mod 16
    assert (t.bk + t.a_pad) % 16 == 8 and (t.bn + t.b_pad) % 16 == 2
    assert shape[0] > 0 and shape[1] > 0, label


def test_em_config_rule():
    """The narrowest tile height whose 32 x 64 warp units fill the 8 warps
    (256 rows for N <= 64, 32 from N = 193), narrowed until S and a ring
    of two tiles fit; b04 nq=8^2 and b05 to 6^3 keep S resident in f32,
    b05 nq=8^3 runs dense."""
    assert k2.em_config(4, 49, 64) == 256
    assert k2.em_config(8, 49, 64) == 256
    assert k2.em_config(4, 49, 56) == 256
    assert k2.em_config(4, 56, 64) == 256
    assert k2.em_config(8, 56, 64) == 128
    assert k2.em_config(4, 125, 216) == 64
    assert k2.em_config(4, 27, 100) == 128
    assert k2.em_resident_smem(4, 49, 64, 256) == 4 * (49 * 64
                                                      + 2 * 256 * 49)
    assert k2.em_resident_smem(8, 49, 56, 32) == 8 * (49 * 64 + 2 * 32 * 49)
    for k, n in ((343, 512), (343, 392), (392, 448), (448, 512)):
        assert k2.em_config(4, k, n) == 0
    # a tile that does not fit is narrowed: 128 rows of K = 200 with S
    # (200 x 64) pass 232,448 B in f32; 64 fit
    assert k2.em_resident_smem(4, 200, 64, 128) > 232448
    assert k2.em_config(4, 200, 64) == 64


def test_em_gemm_rejects_unknown_tile():
    x, s = torch.zeros(CE, 27), torch.zeros(27, 64)
    with pytest.raises(ValueError, match="tile=96"):
        k2.kron_elem_major(x, s, tile=96)
    assert torch.equal(k2.one_stage_em(x, s, tile=0),
                       k2.kron_elem_major_plain(x, s))


@pytest.mark.cuda
@pytest.mark.parametrize("itemsize", [2, 4, 8])
def test_em_gemm_both_configs_on_card(itemsize):
    """K3 in both configurations against its plain version on E = 1000 and
    131071 rows (neither a multiple of a tile): b04 nq=8^2 kron_elem_major
    (49 x 64) at every tile height and dense, and its QP-1D stages; the b05
    nq=8^3 kron and QP-1D stages (dense; K = 343 rows are not whole
    16-byte words); S (128 x N) just either side of the resident
    threshold; X off a 16-byte boundary; the dense tile's edges, S of K =
    343 and 344 by N = 512 and 500; 1e-5 (f32), 1e-12 (f64), 2^-7 (bf16),
    relative to the largest output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dtype = {2: torch.bfloat16, 4: torch.float32, 8: torch.float64}[itemsize]
    tol = {2: 2**-7, 4: 1e-5, 8: 1e-12}[itemsize]
    gen = torch.Generator(device="cuda").manual_seed(itemsize + 2)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    threshold = 64
    while k2.em_config(itemsize, 128, threshold + 64):
        threshold += 64
    for e in (1000, 131071):
        cases = [(rnd(e, 49), rnd(49, 64), h)
                 for h in (None, 0, *k2.EM_TILES)
                 if not h or k2.em_resident_smem(itemsize, 49, 64, h)
                 <= 232448]
        cases += [(rnd(e, k), rnd(k, n), None)
                  for k, n in ((49, 56), (56, 64), (343, 512), (343, 392),
                               (392, 448), (448, 512))]
        cases += [(rnd(e, 128), rnd(128, n), None)
                  for n in (threshold, threshold + 64)]
        cases += [(rnd(e * 49 + 1)[1:].view(e, 49), rnd(49, 64), h)
                  for h in (None, 0)]
        # the dense tile's edges: N 512 and 500 (not a multiple of 64), K
        # 343 (8-byte copies) and 344, E rows (not a multiple of 128)
        cases += [(rnd(e, k), rnd(k, n), None)
                  for n in (512, 500) for k in (343, 344)]
        for x, s, h in cases:
            card_agree(k2.one_stage_em(x, s, tile=h),
                       k2.kron_elem_major_plain(x, s), dtype, tol,
                       (tuple(s.shape), e, h))


# ---- K4 at benchmark04's orders (kernels/bwdtrans3d.qp2_*) -----------------

B04_ORDERS = [(n, n) for n in (2, 4, 6, 8, 10, 12, 14, 16, 32)] + [(10, 12)]


@pytest.mark.parametrize("itemsize", [2, 4, 8])
@pytest.mark.parametrize("e", [1000, 1048576])
@pytest.mark.parametrize("nq", B04_ORDERS)
def test_qp2_deals_every_vector_once_at_b04_orders(nq, e, itemsize):
    """K4 as benchmark04's Pallas(QP) stage 2, w (nm0, nq1, E): at every
    unroll it takes there (qp2_unrolls: at most QP2_CHUNKED_UNROLL above
    nm0 = QP2_EXACT, half of each in bf16) and at 1, 3 and 8 blocks an SM of 132, one wave, the units
    dealt in order, each once, shares equal to within one."""
    nm0, nkj = nq[0] - 1, nq[1]
    f = nkj * e
    for vector in {False, build.vector16(f, itemsize, 0, 0)}:
        nv = k1.qp2_units(f, itemsize, vector)
        unrolls = k1.qp2_unrolls(itemsize, nm0) if vector else (1,)
        assert unrolls
        for unroll in unrolls:
            for wave in (132, 396, 1056):
                blocks = k1.qp2_grid(nv, unroll, wave)
                shares = k1.qp2_shares(nv, blocks)
                assert 1 <= blocks <= wave
                assert [s for s, _ in shares[1:]] == [t for _, t in
                                                      shares[:-1]]
                assert shares[0][0] == 0 and shares[-1][1] == nv
                sizes = [t - s for s, t in shares]
                assert max(sizes) - min(sizes) <= 1


def test_qp_global_default_unroll_serves_every_b04_order():
    """The default unroll is one the kernel takes at every benchmark04
    order, the chunked ones (nm0 > QP2_EXACT) included."""
    for nq0, nq1 in B04_ORDERS:
        x = torch.zeros(nq0 - 1, nq1 - 1, 8)
        out = k1.qp_global3d(x, torch.zeros(nq0 - 1, nq0),
                             torch.zeros(nq1, nq1 - 1))
        assert out.shape == (nq0, nq1, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [(2, 2), (8, 8), (10, 12), (16, 16),
                                (32, 32)])
def test_qp_stage2_every_b04_order_on_card(nq):
    """K4 as benchmark04's stage 2 at an order of chip_smoke.py's phase 3,
    on E = 1000 and 1,048,576, at every unroll it takes there, against
    its plain version: 1e-5 (f32), 1e-12 (f64), 2^-7 (bf16), relative to
    the largest output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(sum(nq) + 50)
    nm0, nq0, nkj = nq[0] - 1, nq[0], nq[1]
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12),
                       (torch.bfloat16, 2**-7)):
        unrolls = k1.qp2_unrolls(dtype.itemsize, nm0)
        b0 = torch.randn(nm0, nq0, generator=gen, device="cuda",
                         dtype=dtype)
        for e in (1000, 1048576):
            w = torch.randn(nm0, nkj, e, generator=gen, device="cuda",
                            dtype=dtype)
            ref = k1.qp_stage2_3d_plain(w, b0)
            for unroll in unrolls:
                out = k1.qp_stage2_3d(w, b0, unroll=unroll)
                torch.cuda.synchronize()
                err = float((out.double() - ref.double()).abs().max()
                            / ref.double().abs().max())
                assert err <= tol, (dtype, e, unroll, err)


# ---- the shared memory the rules count, against the library's --------------

@pytest.mark.cuda
@pytest.mark.parametrize("itemsize", [2, 4, 8])
def test_smem_sizes_agree_with_the_library_on_card(itemsize):
    """The rules of kernels/ decide each configuration from the shared
    memory they count, so each count equals the library's own (csrc/): K1's
    qp_smem and tbt_qp_fused3d_smem at every element tile, plane group,
    depth, stage-2 body and place of C12T, K2's kron_resident_smem and tbt_kron_resident_smem at every
    strip (QP stage 1 and the kron), K3's em_resident_smem and
    tbt_em_resident_smem at every tile height (the kron and each QP-1D
    stage), K5's qp1d_smem and tbt_qp1d_smem at every element tile, at
    every benchmark05 order 2^3 .. 10^3 and (3,4,5) and every benchmark04
    order of scripts/run04.sh and (10, 12); and the f64 dense tile's
    dense_smem and tbt_dense_f64_smem and the f32 wgmma body's wgmma_smem
    and tbt_dense_wgmma_smem, within one block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lib = build.library()
    assert k2.dense_smem(k2.DENSE_F64) == lib.tbt_dense_f64_smem() <= 232448
    assert k2.wgmma_smem() == lib.tbt_dense_wgmma_smem() <= 232448
    orders = [(n, n, n) for n in range(2, 11)] + [(3, 4, 5)] + B04_ORDERS
    for nq in orders:
        nm = [n - 1 for n in nq]
        if len(nq) == 2:
            k1_shape = (nm[0], nm[1], nq[0], nq[1])
            widths = [nm[0] * nm[1], nm[1] * nq[0], nq[0] * nq[1]]
        else:
            k1_shape = (nm[0], nm[1] * nm[2], nq[0], nq[1] * nq[2])
            widths = [nm[0] * nm[1] * nm[2], nm[2] * nm[1] * nq[0],
                      nm[2] * nq[1] * nq[0], nq[0] * nq[1] * nq[2]]
        for et in k1.QP_TILES[itemsize]:
            for g in k1.QP_PLANE_GROUPS:
                for depth in (1, 2):
                    for body, where, s1 in k1.QP_ENTRY_BODIES:
                        if body not in k1.qp_built_bodies(itemsize, et):
                            continue
                        assert k1.qp_smem(itemsize, et, g, *k1_shape, depth,
                                          body, where, s1) == \
                            lib.tbt_qp_fused3d_smem(
                                itemsize, et, g, *k1_shape, depth,
                                k1.QP_ENTRY_BODIES[body, where, s1]), (
                                    nq, et, g, depth, body, where, s1)
        stage1 = (k1_shape[3], k1_shape[1])
        for m, k in (stage1, (widths[-1], widths[0])):
            for w in k2.KRON_STRIPS:
                assert k2.kron_resident_smem(itemsize, m, k, w) == \
                    lib.tbt_kron_resident_smem(itemsize, m, k, w), (m, k, w)
        for k, n in [(widths[0], widths[-1]), *zip(widths, widths[1:])]:
            for h in k2.EM_TILES:
                assert k2.em_resident_smem(itemsize, k, n, h) == \
                    lib.tbt_em_resident_smem(itemsize, k, n, h), (k, n, h)
        n2 = widths[2] if len(widths) == 4 else 0
        for et in k1.QP1D_TILES[itemsize]:
            assert k1.qp1d_smem(itemsize, et, widths[0], widths[1], n2) == \
                lib.tbt_qp1d_smem(itemsize, et, widths[0], widths[1],
                                  n2), (nq, et)
