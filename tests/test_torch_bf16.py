"""bf16 through benchmarks 04 and 05 (K1-K5 built for bf16, f32 sums).

The port's bf16 operands are the JAX package's bit for bit; each kernel's
plain bf16 version (the CPU path of its wrapper) agrees with the JAX Pallas
function it replaces, run in interpret mode on the same bf16 inputs; K1's
f32 v keeps its accuracy against the f64 oracle; the eleven columns of
both benchmarks agree with each other, with the oracle, with the JAX
package's columns and with its committed bf16 logs; and the rules K1-K5
use take bf16 at every order both benchmarks sweep.

Tolerances: elementwise 2^-7 of the largest output (a bf16 rounding that
falls the other side of a tie on f32 sums taken in another order moves a
value by one bf16 ulp, 2^-8 of it), norms 1e-4 (the sums of squares
average those ulps out; a wrong cast point moves a norm by 3e-4 to 7e-4,
artifacts/bf16/b05/nq8x8x8.log), columns 5e-2 of each other and of the
oracle (tpu_bench/core/validate.py's bf16 tolerance).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bench.benchmarks import benchmark04 as jax_b04
from tpu_bench.benchmarks import benchmark05 as jax_b05
from tpu_bench.core.config import Config as JaxConfig
from tpu_bench.core.validate import l2norm as jax_l2norm
from tpu_bench.kernels import bwdtrans2d as pl2
from tpu_bench.kernels import bwdtrans3d as pl3
from tpu_bench_torch import convert
from tpu_bench_torch.benchmarks import benchmark04 as b04
from tpu_bench_torch.benchmarks import benchmark05 as b05
from tpu_bench_torch.core.config import Config
from tpu_bench_torch.core.validate import l2norm
from tpu_bench_torch.kernels import build
from tpu_bench_torch.kernels import bwdtrans2d as k2
from tpu_bench_torch.kernels import bwdtrans3d as k1
from tpu_bench_torch.ops import bwdtrans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = torch.bfloat16
HIGHEST = jax.lax.Precision.HIGHEST
ELEM_TOL, NORM_TOL, COLUMN_TOL = 2**-7, 1e-4, 5e-2
E, EPB = 256, 128
HAND = [label for label in b05.LABELS if label.startswith("Pallas")]


def _benches(nq):
    return (b05, jax_b05) if len(nq) == 3 else (b04, jax_b04)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


def _jax_bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int16)


def _jax_cfg():
    return JaxConfig(dtype=jnp.bfloat16, n_tests=2)


def _cfg():
    return Config(dtype=BF16, n_tests=2, device="cpu")


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


# ---- operands: bit-equal to the JAX package's ------------------------------

ORDERS = [(4, 4, 4), (6, 6, 6), (8, 8, 8), (4, 4), (8, 8)]


@pytest.mark.parametrize("nq", ORDERS, ids=lambda nq: "x".join(map(str, nq)))
def test_bf16_operands_are_the_jax_bits(nq):
    """The bases, the element data, the operators (torch.kron in bf16, as
    jnp.kron) and every layout of the element stream, at 256 elements (two
    chunks of 128, the last 56 zero-padded at 200 live elements)."""
    bench, jax_bench = _benches(nq)
    data = bench.prepare(*nq, 200, _cfg())
    jdata = jax_bench.prepare(*nq, 200, _jax_cfg())
    basis, jbasis = data["basis"], jdata["basis"]
    if len(nq) == 3:
        keys, blk = convert.B05_KEYS, "in_blk"
        elem = bwdtrans.element_data3d(basis, BF16)
        jelem = jax_b05.bwdtrans.element_data3d(jbasis, jnp.bfloat16)
    else:
        keys, blk = convert.B04_KEYS, "in_blk_w4"
        elem = bwdtrans.element_data2d(basis, BF16)
        jelem = jax_b04.bwdtrans.element_data2d(jbasis, jnp.bfloat16)
    np.testing.assert_array_equal(_bits(elem), _jax_bits(jelem))
    for k in keys:
        if k == blk:
            continue
        assert data[k].dtype == BF16 and data[k].is_contiguous(), k
        np.testing.assert_array_equal(_bits(data[k]), _jax_bits(jdata[k]),
                                      err_msg=k)
    jblk = np.asarray(jdata[blk])
    ce = jblk.shape[2] * (jblk.shape[3] if jblk.ndim == 4 else 1)
    np.testing.assert_array_equal(
        _bits(bwdtrans.blocked_coa(data["in_coa"], ce)),
        jblk.view(np.int16).reshape(jblk.shape[0], jblk.shape[1], ce))


@pytest.mark.parametrize("nq", [(8, 8, 8), (8, 8)], ids=["b05", "b04"])
def test_bf16_arrays_carry_across_by_their_bits(nq):
    """np.asarray of a JAX bf16 array has ml_dtypes' bfloat16, which
    torch.from_numpy refuses; data_from_numpy moves its bits, for every
    operand the two packages share."""
    _, jax_bench = _benches(nq)
    jdata = jax_bench.prepare(*nq, E, _jax_cfg())
    keys = convert.B05_KEYS if len(nq) == 3 else convert.B04_KEYS
    arrays = {k: np.asarray(jdata[k]) for k in keys}
    assert all(a.dtype.name == "bfloat16" for a in arrays.values())
    with pytest.raises(TypeError):
        torch.from_numpy(np.array(arrays["b0"]))
    t = convert.data_from_numpy(arrays, device="cpu", dtype=BF16)
    for k in keys:
        assert t[k].dtype == BF16 and tuple(t[k].shape) == arrays[k].shape
        np.testing.assert_array_equal(_bits(t[k]), arrays[k].view(np.int16),
                                      err_msg=k)


# ---- each kernel's plain bf16 version against its JAX Pallas function -------


def _rnd(rng, *shape):
    """A bf16 tensor of standard normal values and the same bits as a JAX
    array."""
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    t = t.to(BF16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _agree(out: torch.Tensor, ref, label):
    ref = np.asarray(ref).astype(np.float64)
    assert out.dtype == BF16, label
    got = out.double().numpy().reshape(ref.shape)
    top = np.abs(ref).max()
    assert np.abs(got - ref).max() <= ELEM_TOL * top, label
    assert _rel(float(np.linalg.norm(got)), float(np.linalg.norm(ref))) \
        <= NORM_TOL, label


def _cases_3d(nq, rng):
    """(label, the port's call, the JAX Pallas call) for every b05 kernel
    use, on random operators of order nq."""
    nq0, nq1, nq2 = nq
    nm0, nrq, nkj = nq0 - 1, (nq1 - 1) * (nq2 - 1), nq1 * nq2
    nm_tot, nq_tot = nm0 * nrq, nq0 * nkj
    n1, n2 = nrq * nq0, (nq2 - 1) * nq1 * nq0
    x, jx = _rnd(rng, nm0, nrq, E)
    b0, jb0 = _rnd(rng, nm0, nq0)
    c12t, jc12t = _rnd(rng, nkj, nrq)
    c, jc = _rnd(rng, nq_tot, nm_tot)
    blk, jblk = _rnd(rng, 2, nm_tot, EPB)
    em, jem = _rnd(rng, E, nm_tot)
    c_em, jc_em = _rnd(rng, nm_tot, nq_tot)
    (s1, js1), (s2, js2), (s3, js3) = (_rnd(rng, *s) for s in (
        (nm_tot, n1), (n1, n2), (n2, nq_tot)))
    xf, jxf = x.reshape(nm_tot, E), jx.reshape(nm_tot, E)
    kw = dict(interpret=True, precision=HIGHEST)
    return [
        ("K1 qp_shared3d", lambda: k1.qp_shared3d(x, b0, c12t),
         lambda: pl3.qp_shared3d(jx, jb0, jc12t, epb=EPB, **kw)),
        ("K1 qp_shared3d_flat",
         lambda: k1.qp_shared3d_flat(xf, b0, c12t, nrq=nrq),
         lambda: pl3.qp_shared3d_flat(jxf, jb0, jc12t, nrq=nrq, epb=EPB,
                                      **kw)),
        ("K2 + K4 qp_global3d", lambda: k1.qp_global3d(x, b0, c12t),
         lambda: pl3.qp_global3d(jx, jb0, jc12t, epb=EPB, **kw)),
        ("K2 kron_blocked", lambda: k2.kron_blocked(blk, c),
         lambda: pl2.kron_blocked(jblk, jc, **kw)),
        ("K2 kron_wide4", lambda: k2.kron_wide4(blk.reshape(2, nm_tot, 1, EPB),
                                                c),
         lambda: pl2.kron_wide4(jblk.reshape(2, nm_tot, 1, EPB), jc, **kw)),
        ("K2 kron_coalesced", lambda: k2.kron_coalesced(xf, c),
         lambda: pl2.kron_coalesced(jxf, jc, epb=EPB, **kw)),
        ("K3 kron_elem_major", lambda: k2.kron_elem_major(em, c_em),
         lambda: pl2.kron_elem_major(jem, jc_em, epb=EPB, **kw)),
        ("K3 x3 qp1d_global3d", lambda: k1.qp1d_global3d(em, s1, s2, s3),
         lambda: pl3.qp1d_global3d(jem, js1, js2, js3, epb=EPB, **kw)),
        ("K5 qp1d_shared3d", lambda: k1.qp1d_shared3d(em, s1, s2, s3),
         lambda: pl3.qp1d_shared3d(jem, js1, js2, js3, epb=EPB, **kw)),
    ]


def _cases_2d(nq, rng):
    """The same for every b04 kernel use; K1 against the JAX package's own
    v-first kernel on the 2D operands (nm2 = 1)."""
    nq0, nq1 = nq
    nm0, nm1 = nq0 - 1, nq1 - 1
    nm_tot, nq_tot, n1 = nm0 * nm1, nq0 * nq1, nm1 * nq0
    x, jx = _rnd(rng, nm0, nm1, E)
    b0, jb0 = _rnd(rng, nm0, nq0)
    b1t, jb1t = _rnd(rng, nq1, nm1)
    c, jc = _rnd(rng, nq_tot, nm_tot)
    blk4, jblk4 = _rnd(rng, 2, nm_tot, 1, EPB)
    em, jem = _rnd(rng, E, nm_tot)
    (s1, js1), (s2, js2) = _rnd(rng, nm_tot, n1), _rnd(rng, n1, nq_tot)
    kw = dict(interpret=True, precision=HIGHEST)
    cases = [
        ("K1 qp_shared3d on the 2D operands",
         lambda: k1.qp_shared3d(x, b0, b1t),
         lambda: pl3.qp_shared3d(jx, jb0, jb1t, epb=EPB, **kw)),
        ("K2 + K4 qp_global", lambda: k1.qp_global3d(x, b0, b1t),
         lambda: pl2.qp_global(jx, jb0, jb1t, epb=EPB, **kw)),
        ("K2 kron_wide4", lambda: k2.kron_wide4(blk4, c),
         lambda: pl2.kron_wide4(jblk4, jc, **kw)),
        ("K3 x2 qp1d_global", lambda: k2.qp1d_global(em, s1, s2),
         lambda: pl2.qp1d_global(jem, js1, js2, epb=EPB, **kw)),
        ("K5 qp1d_shared", lambda: k1.qp1d_fused(em, s1, s2),
         lambda: pl2.qp1d_shared(jem, js1, js2, epb=EPB, **kw)),
    ]
    if nm_tot * nq_tot <= pl2.VPU_KRON_MAX:
        cases.append(("K2 kron_vpu_blocked", lambda: k2.kron_wide4(blk4, c),
                      lambda: pl2.kron_vpu_blocked(jblk4, jc,
                                                   interpret=True)))
    return cases


def _case_ids():
    ids = []
    for nq in [(4, 4, 4), (8, 8, 8)]:
        ids += [(nq, i) for i in range(9)]
    for nq in [(2, 2), (4, 4), (8, 8)]:
        n = 6 if nq == (2, 2) else 5
        ids += [(nq, i) for i in range(n)]
    return ids


@pytest.mark.parametrize("nq,index", _case_ids(),
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_bf16_plain_versions_match_jax_pallas(nq, index):
    """Each kernel use's plain bf16 version (the wrapper on CPU tensors)
    against the Pallas function it replaces in interpret mode, on the same
    random bf16 operators and element data (E = 256)."""
    rng = np.random.default_rng(100 * sum(nq) + index)
    cases = (_cases_3d if len(nq) == 3 else _cases_2d)(nq, rng)
    label, run, ref = cases[index]
    _agree(run(), ref(), f"{label} nq={nq}")


# ---- accuracy against the f64 oracle ---------------------------------------


def test_bf16_f32v_accuracy():
    """The port's form of tests/test_benchmark05.py::test_bf16_f32v_accuracy:
    K1 keeps v in f32 and rounds it once, so at nq=6^3, nelmt=256 its norm
    stays within 5e-4 of the f64 oracle (a bf16 v summed in bf16 gave
    9.7e-4 there)."""
    nq, nelmt = 6, 256
    data = b05.prepare(nq, nq, nq, nelmt, _cfg())
    oracle = float(np.linalg.norm(bwdtrans.reference3d(data["basis"],
                                                       nelmt)))
    out = k1.qp_shared3d(data["in_pcoa3"], data["b0"], data["c12t"])
    assert out.dtype == BF16
    assert _rel(l2norm(out), oracle) <= 5e-4


# ---- the eleven columns ----------------------------------------------------


@pytest.mark.parametrize("nq", [(4, 4, 4), (8, 8, 8), (4, 4), (8, 8)],
                         ids=lambda nq: "x".join(map(str, nq)))
def test_bf16_columns_match_jax_and_the_oracle(nq):
    """build_variants in bf16 at nelmt 256: all eleven columns within 5e-2
    of each other and of the f64 oracle, and each hand column within 1e-4
    of the JAX package's column of the same label (Pallas in interpret
    mode), but b04 Pallas(QP/Shared), whose JAX kernel rounds elsewhere
    (test_b04_qp_shared_bf16_rounds_where_k1_rounds)."""
    bench, jax_bench = _benches(nq)
    data = bench.prepare(*nq, E, _cfg())
    norms = {label: l2norm(fn(*args))
             for label, fn, args in bench.build_variants(data, _cfg())}
    assert list(norms) == bench.LABELS
    reference = (bwdtrans.reference3d if len(nq) == 3
                 else bwdtrans.reference2d)(data["basis"], E)
    oracle = float(np.linalg.norm(reference))
    for label, norm in norms.items():
        assert _rel(norm, norms["XLA(Uncoales)"]) <= COLUMN_TOL, label
        assert _rel(norm, oracle) <= COLUMN_TOL, label
    jdata = jax_bench.prepare(*nq, E, _jax_cfg())
    jax_norms = {label: jax_l2norm(fn(*args)) for label, fn, args
                 in jax_bench.build_variants(jdata, _jax_cfg())}
    for label in HAND:
        if len(nq) == 2 and label == "Pallas(QP/Shared)":
            continue
        assert _rel(norms[label], jax_norms[label]) <= NORM_TOL, label


def _log_norms(path, nelmt=128) -> dict:
    with open(path) as f:
        for line in f:
            if line.startswith(f"nelmt {nelmt} Case:"):
                labels = line.split()[3:]
            elif line.startswith(f"nelmt {nelmt} norm:"):
                return dict(zip(labels, map(float, line.split()[3:])))
    raise ValueError(f"no nelmt {nelmt} row in {path}")


@pytest.mark.parametrize("nq", [(8, 8, 8), (2, 2, 2), (8, 8), (2, 2)],
                         ids=lambda nq: "x".join(map(str, nq)))
def test_bf16_hand_columns_match_committed_jax_logs(nq):
    """At nelmt 128 each hand column is within 1e-4 of the same column of
    the JAX package's committed bf16 log (TPU), but b04 Pallas(QP/Shared)."""
    bench, _ = _benches(nq)
    name = "x".join(map(str, nq))
    logged = _log_norms(os.path.join(
        REPO, "artifacts", "bf16", "b05" if len(nq) == 3 else "b04",
        f"nq{name}.log"))
    data = bench.prepare(*nq, 128, _cfg())
    for label, fn, args in bench.build_variants(data, _cfg()):
        if label not in HAND or (len(nq) == 2
                                 and label == "Pallas(QP/Shared)"):
            continue
        assert _rel(l2norm(fn(*args)), logged[label]) <= NORM_TOL, label


# b04 Pallas(QP/Shared) at nelmt 128, f64 oracle: the port's K1 (v-first,
# v rounded once), which equals the staged library column XLA(QP) (the same
# two roundings), against the JAX package's kernel there (qp_shared at 8^2,
# nm0 roundings into a bf16 output; qp_w from 10^2)
QP_SHARED_ORDERS = [(8, 8), (10, 10), (16, 16)]


@pytest.mark.parametrize("nq", QP_SHARED_ORDERS,
                         ids=lambda nq: "x".join(map(str, nq)))
def test_b04_qp_shared_bf16_rounds_where_k1_rounds(nq):
    """The port's b04 Pallas(QP/Shared) is K1, whose cast points are the
    JAX package's 3D accuracy fix (v in f32, rounded once): it equals the
    port's XLA(QP) column, lies closer to the f64 oracle than the JAX
    package's 2D kernel, and differs from that kernel by more than the
    1e-4 the other hand columns are held to (ROADMAP Queue 3)."""
    data = b04.prepare(*nq, 128, _cfg())
    oracle = float(np.linalg.norm(bwdtrans.reference2d(data["basis"], 128)))
    specs = {label: (fn, args)
             for label, fn, args in b04.build_variants(data, _cfg())}
    port = l2norm(specs["Pallas(QP/Shared)"][0](
        *specs["Pallas(QP/Shared)"][1]))
    assert port == l2norm(specs["XLA(QP)"][0](*specs["XLA(QP)"][1]))
    jdata = jax_b04.prepare(*nq, 128, _jax_cfg())
    (_, fn, args), = [v for v in jax_b04.build_variants(jdata, _jax_cfg())
                      if v[0] == "Pallas(QP/Shared)"]
    jax_value = jax_l2norm(fn(*args))
    assert _rel(port, oracle) < _rel(jax_value, oracle)
    assert _rel(port, jax_value) > NORM_TOL
    assert _rel(port, oracle) <= COLUMN_TOL


# ---- the rules K1-K5 use, in bf16 ------------------------------------------

B05_ORDERS = [(n, n, n) for n in range(2, 11)]
B04_ORDERS = [(n, n) for n in (2, 4, 6, 8, 10, 12, 14, 16, 32)]


def _chain(nq):
    nm = [n - 1 for n in nq]
    if len(nq) == 2:
        return nm[0] * nm[1], nm[1] * nq[0], 0
    return (nm[0] * nm[1] * nm[2], nm[2] * nm[1] * nq[0],
            nm[2] * nq[1] * nq[0])


@pytest.mark.parametrize("itemsize", [2, 4, 8])
@pytest.mark.parametrize("nq", B05_ORDERS + B04_ORDERS,
                         ids=lambda nq: "x".join(map(str, nq)))
def test_qp1d_tiles_fit_at_every_order(nq, itemsize):
    """K5 takes an element tile at every order both benchmarks sweep: the
    first of QP1D_TILES whose buffers fit the H100's 232,448 B of a
    block; the tiles are multiples of the mma tile's M side."""
    k0, n1, n2 = _chain(nq)
    fits = k1.qp1d_fits(itemsize, k0, n1, n2)
    assert fits and set(fits) <= set(k1.QP1D_TILES[itemsize])
    for et in fits:
        assert et % (8 if itemsize == 8 else 16) == 0
        assert k1.qp1d_smem(itemsize, et, k0, n1, n2) <= 232448


def test_qp1d_smem_counts_each_buffer():
    """K5's shared memory at b05 nq=8^3, tile 64: w1 (392 wide) and buffer
    B (X 343, then w2 448 wide), rows padded to whole BK steps plus the row
    padding, and the ring of three BK x BN S tiles plus their padding."""
    assert k1.qp1d_smem(4, 64, 343, 392, 448) == 4 * (
        64 * ((416 + 4) + (448 + 4)) + 3 * 32 * (128 + 8))
    assert k1.qp1d_smem(2, 64, 343, 392, 448) == 2 * (
        64 * ((416 + 8) + (448 + 8)) + 3 * 32 * (128 + 8))
    assert k1.qp1d_smem(8, 32, 49, 56, 0) == 8 * (
        32 * ((56 + 4) + (56 + 4)) + 3 * 8 * (64 + 8))


@pytest.mark.parametrize("nq", B05_ORDERS + B04_ORDERS,
                         ids=lambda nq: "x".join(map(str, nq)))
def test_qp2_bf16_unroll_and_b0_fit(nq):
    """K4 in bf16 at every order: B0 fits the 48 KiB it takes without an
    opt-in, and the unrolls it is built for hold as many f32 registers of
    w as f32's: 1 and 2 (1 above nm0 = QP2_EXACT), the default among
    them."""
    nm0, nq0 = nq[0] - 1, nq[0]
    assert k1.qp2_smem(2, nm0, nq0) <= k1.QP2_MAX_B0_BYTES
    takes = k1.qp2_unrolls(2, nm0)
    assert takes == ((1, 2) if nm0 <= k1.QP2_EXACT else (1,))
    assert all(2 * u in k1.qp2_unrolls(4, nm0) for u in takes)
    w = torch.zeros(nm0, 2, 8, dtype=BF16)
    assert k1.qp_stage2_3d(w, torch.zeros(nm0, nq0, dtype=BF16)).dtype == BF16
    with pytest.raises(ValueError, match="at most"):
        k1.qp_stage2_3d(w, torch.zeros(nm0, nq0, dtype=BF16), unroll=4)


def test_kron_resident_smem_keeps_the_ring_on_16_bytes():
    """In bf16 an odd K leaves C^T's values short of a 16-byte word; K2's
    ring starts at the next word (b04 nq=4^2 stage 1: C 4 x 3)."""
    assert k2.kron_resident_smem(2, 4, 3, 512) == 2 * (16 + 3 * 3 * 512)
    assert k2.kron_resident_smem(4, 4, 3, 512) == 4 * (12 + 3 * 3 * 512)


# ---- on the card ----------------------------------------------------------


def _card_cases(rnd):
    """(kernel, the wrapper's call, its plain version) for every K1-K5
    entry at b05 nq=8^3 (b04 nq=8^2 for the two-stage K5), E = 1000."""
    e = 1000
    x, b0, c12t = rnd(7, 49, e), rnd(7, 8), rnd(64, 49)
    blk, c = rnd(1, 343, e), rnd(512, 343)
    w = rnd(7, 64, e)
    em, s1, s2, s3 = rnd(e, 343), rnd(343, 392), rnd(392, 448), rnd(448, 512)
    em2, t1, t2 = rnd(e, 49), rnd(49, 56), rnd(56, 64)
    return {
        "qp_fused3d": (lambda: k1.qp_shared3d(x, b0, c12t),
                       lambda: k1.qp_shared3d_plain(x, b0, c12t)),
        "kron_blocked": (lambda: k2.kron_blocked(blk, c),
                         lambda: k2.kron_blocked_plain(blk, c)),
        "em_gemm": (lambda: k2.one_stage_em(em, s1),
                    lambda: k2.kron_elem_major_plain(em, s1)),
        "qp_stage2_3d": (lambda: k1.qp_stage2_3d(w, b0),
                         lambda: k1.qp_stage2_3d_plain(w, b0)),
        "qp1d_fused3d": (lambda: k1.qp1d_shared3d(em, s1, s2, s3),
                         lambda: k1.qp1d3d_plain(em, s1, s2, s3)),
        "qp1d_fused2d": (lambda: k1.qp1d_fused(em2, t1, t2),
                         lambda: k2.qp1d_plain(em2, t1, t2)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", list(build.BF16_KERNELS))
def test_bf16_kernels_match_plain_on_card(kernel):
    """Each bf16 instance against its plain version on the card: the
    output is bf16, within 2^-7 of the largest output, and the launch is
    counted under the bf16 instance's name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=BF16)

    run, plain = _card_cases(rnd)[kernel]
    before = build.launches[f"{kernel}_bf16"]
    out, ref = run(), plain()
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype == BF16
    err = (out.double() - ref.double()).abs().max() / ref.double().abs().max()
    assert float(err) <= ELEM_TOL
    assert build.launches[f"{kernel}_bf16"] == before + 1
