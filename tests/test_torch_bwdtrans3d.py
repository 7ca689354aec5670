"""The port's 3D QP wrappers (tpu_bench_torch.kernels.bwdtrans3d) against
the JAX package's Pallas kernels in interpret mode, on the same numpy-seeded
random inputs, which vary per element so an element-axis bug shows, and
random dense stage operators, so the kernels' generality shows too.  K1's
element tile and plane group (qp_config) are held to the card's shared
memory at every order both benchmarks sweep."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bench.kernels import bwdtrans3d as pl_bt
from tpu_bench_torch.kernels import build
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
    out = k1.qp_global3d(x.bfloat16(), b0.bfloat16(), c12t.bfloat16())
    assert out.dtype == torch.bfloat16  # bf16 runs
    out = k1.qp1d_shared3d(em.bfloat16(), *(o.bfloat16() for o in ops))
    assert out.dtype == torch.bfloat16
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
    out = k1.qp_shared3d(x.bfloat16(), b0.bfloat16(), c12t.bfloat16())
    assert out.dtype == torch.bfloat16  # bf16 runs
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


# ---- K1's element tile and plane group (kernels/bwdtrans3d.qp_config) ------

# K1's shapes (nm0, nrq, nq0, nkj) at every benchmark05 order 2^3 .. 10^3
# and every benchmark04 order of scripts/run04.sh
B05_ORDERS = list(range(2, 11))
RUN04_ORDERS = [2, 4, 6, 8, 10, 12, 14, 16, 32]
K1_SHAPES = ([(f"b05 nq={n}^3", (n - 1, (n - 1) ** 2, n, n * n))
              for n in B05_ORDERS]
             + [(f"b04 nq={n}^2", (n - 1, n - 1, n, n))
                for n in RUN04_ORDERS])


@pytest.mark.parametrize("itemsize", [2, 4, 8])
@pytest.mark.parametrize("label,shape", K1_SHAPES)
def test_qp_config_fits_the_card(label, shape, itemsize):
    """At every order both benchmarks sweep, in bf16, f32 and f64, qp_config
    gives one of K1's tiles, plane groups, forms, stage-2 bodies and
    places of C12T, whose buffers, slab slots included, fit the H100's
    232,448 B of a block, and the tile is a whole number of 4-element
    micro-tiles; stage 1 on a body built beside that setting."""
    et, g, depth, threads, body, where, stage1 = k1.qp_config(itemsize,
                                                              *shape)
    assert et in k1.QP_TILES[itemsize]
    assert g in (*k1.QP_PLANE_GROUPS, k1.QP_S1_PLANES)
    assert (depth, threads) in k1.qp_forms(itemsize, et, body)
    assert body in k1.qp_built_bodies(itemsize, et)
    assert where in k1.qp_c12t_places(body, shape[1], shape[3])
    assert stage1 in k1.qp_stage1_places(itemsize, et, g, depth, threads,
                                         body, where, shape[0], shape[1],
                                         shape[3])
    assert et % k1.QP_TE == 0
    assert k1.qp_smem(itemsize, et, g, *shape, depth, body, where,
                      stage1) <= 232448


def test_qp_smem_counts_each_buffer():
    """K1's shared memory at b05 nq=8^3, f32, tile 32, 4 planes: the slab
    (343 x 32), V (4 x 49 x 32), C12T^T (49 x 64) and B0 (7 x 8)."""
    assert k1.qp_smem(4, 32, 4, 7, 49, 8, 64) == 4 * (
        343 * 32 + 4 * 49 * 32 + 49 * 64 + 7 * 8)
    # nkj padded to the 8-row micro-tile, nq0 to the plane group
    assert k1.qp_smem(8, 16, 8, 2, 12, 3, 20) == 8 * (
        24 * 16 + 8 * 12 * 16 + 12 * 24 + 2 * 8)
    # depth 2: a second slab, and the 16 bytes of the slots' tiles first
    assert k1.qp_smem(8, 16, 8, 7, 49, 8, 64, 2) == 16 + 8 * (
        2 * 343 * 16 + 8 * 49 * 16 + 49 * 64 + 7 * 8)
    assert k1.qp_smem(4, 32, 4, 7, 49, 8, 64, 2) == \
        k1.qp_smem(4, 32, 4, 7, 49, 8, 64) + 16 + 4 * 343 * 32
    # DMMA: V unpadded (nrq x et a plane, its columns swizzled); C12T held
    # in registers takes no buffer
    assert k1.qp_smem(8, 16, 4, 9, 81, 10, 100, 1, "dmma", "regs") == 8 * (
        729 * 16 + 4 * 81 * 16 + 9 * 12) == 135648
    assert k1.qp_smem(8, 16, 4, 9, 81, 10, 100, 2, "dmma", "regs") == \
        16 + 8 * (2 * 729 * 16 + 4 * 81 * 16 + 9 * 12) == 228976
    assert k1.qp_smem(8, 16, 8, 7, 49, 8, 64, 2, "dmma", "regs") == \
        16 + 8 * (2 * 343 * 16 + 8 * 49 * 16 + 7 * 8)
    # staged, C12T's rows padded to 16 (100 -> 112), each of 88 values (8
    # mod 16)
    assert k1.qp_smem(8, 16, 4, 9, 81, 10, 100, 1, "dmma") == 8 * (
        729 * 16 + 4 * 81 * 16 + 112 * 88 + 9 * 12) == 214496
    assert k1.qp_smem(8, 16, 8, 7, 49, 8, 64, 2, "dmma", "smem") == \
        16 + 8 * (2 * 343 * 16 + 8 * 49 * 16 + 64 * 56 + 7 * 8)
    # nrq = 12 pads to 16, a multiple of 16, so C12T's rows take 24 values
    assert k1.qp_smem(8, 16, 8, 2, 12, 3, 20, 1, "dmma") == 8 * (
        24 * 16 + 8 * 12 * 16 + 32 * 24 + 2 * 8)
    assert k1.qp_smem(8, 16, 8, 2, 12, 3, 20, 1, "dmma", "regs") == 8 * (
        24 * 16 + 8 * 12 * 16 + 2 * 8)


@pytest.mark.parametrize("nrq,lda", [(81, 88), (49, 56), (12, 24), (7, 8),
                                     (16, 24), (31, 40), (1, 8)])
def test_qp_lda_pads_c12t_rows_to_8_mod_16(nrq, lda):
    """The staged DMMA form's C12T rows: nrq padded to the mma's 8-deep k
    step, then to 8 mod 16 values, so a quarter warp's 16-byte A loads of
    two rows 8 apart land in distinct banks."""
    assert k1.qp_lda(nrq) == lda
    assert lda >= nrq and lda % 16 == 8


@pytest.mark.parametrize("nrq,nkj,takes", [
    (81, 100, True), (49, 64, True), (88, 128, True), (12, 20, True),
    (31, 32, True), (89, 100, False), (81, 129, False), (100, 121, False)])
def test_qp_dmma_takes_what_its_warps_hold(nrq, nkj, takes):
    """DMMA holds C12T in registers where each of a block's 8 warps holds
    one m tile of 16 kj rows (nkj <= 128) as 11 k steps of 8 rq (nrq <=
    88), which covers every b05 order to 10^3 and b04 to 32^2.  Past that
    the sweep has only the staged form and the launch refuses "regs"."""
    assert k1.qp_dmma_takes(nrq, nkj) is takes
    shape = (1, nrq, 4, nkj)
    places = {c.c12t for c in k1.qp_settings(8, *shape) if c.body == "dmma"}
    assert places == ({"smem", "regs"} if takes else {"smem"})
    assert k1.qp_c12t_places("simt", nrq, nkj) == ("smem",)


def test_qp_config_prefers_two_blocks_and_refuses_what_does_not_fit():
    """Outside the measured table: the largest tile whose buffers fit two
    blocks an SM while stage 1 keeps half the block busy, else the largest
    that fits one, else None."""
    # (3, 4, 5) is not in the table: tile 128 fits two blocks in f32
    assert (4, 2, 12, 3, 20) not in k1.QP_MEASURED
    et, g, depth, threads, *_ = k1.qp_config(4, 2, 12, 3, 20)
    assert (et, depth, threads) == (128, 1, k1.QP_THREADS)
    assert 2 * (k1.qp_smem(4, et, g, 2, 12, 3, 20) + k1.SMEM_RESERVED) \
        <= k1.SMEM_SM
    # 31 x 31 rows with 30 outputs a plane: tile 16 fits two blocks but
    # leaves stage 1 more than half idle (31 * 16 / 4 < 128 positions), so
    # the largest tile that fits one block, 32
    shape = (31, 31, 32, 30)
    assert 2 * (k1.qp_smem(4, 16, 8, *shape) + k1.SMEM_RESERVED) <= k1.SMEM_SM
    assert k1.qp_config(4, *shape) == (32, 8, 1, k1.QP_THREADS, "simt",
                                       "smem", "simt")
    # a 32^3 slab (961 x 31 rows) fits no tile at all
    assert k1.qp_config(4, 31, 961, 32, 1024) is None
    assert k1.qp_config(4, 7, 49, 8, 64, block_limit=1024) is None


def test_qp_measured_settings_fit_and_are_the_configs():
    for (itemsize, *shape), cfg in k1.QP_MEASURED.items():
        assert type(cfg) is k1.QPConfig
        et, g, depth, threads, body, where, stage1 = cfg
        assert et in k1.QP_TILES[itemsize]
        assert g in (*k1.QP_PLANE_GROUPS, k1.QP_S1_PLANES)
        assert (depth, threads) in k1.qp_forms(itemsize, et, body)
        assert body in k1.qp_built_bodies(itemsize, et)
        assert where in k1.qp_c12t_places(body, shape[1], shape[3])
        assert stage1 in k1.qp_stage1_places(itemsize, et, g, depth,
                                             threads, body, where, shape[0],
                                             shape[1], shape[3])
        assert k1.qp_smem(itemsize, et, g, *shape, depth, body,
                          where, stage1) <= 232448
        assert k1.qp_config(itemsize, *shape) == cfg


# The bf16 shapes of K1_SHAPES whose C12T fills an m16n8k16 tile (nkj >=
# 16, nrq >= 16), where qp_config takes HMMA: b05 5^3 .. 10^3 and b04 32^2
HMMA_SHAPES = {f"b05 nq={n}^3" for n in range(5, 11)} | {"b04 nq=32^2"}


# The f32 shapes (nm0, nrq, nq0, nkj) where the sweep measured K1's TF32
# body (3xTF32 on wgmma) faster than SIMT, which QP_MEASURED names
TF32_MEASURED = {(7, 49, 8, 64)}


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("label,shape", K1_SHAPES)
def test_qp_config_keeps_simt_outside_f64(label, shape, itemsize):
    """DMMA is f64's alone: in f32 qp_config gives the SIMT body at every
    order both benchmarks sweep but where QP_MEASURED names the TF32 body
    (TF32_MEASURED), and the sweep has no DMMA or HMMA.  In bf16 it gives
    the bf16 tensor cores' body (HMMA) where C12T fills an m16n8k16 tile
    (HMMA_SHAPES), else SIMT, and the sweep has no DMMA."""
    bodies = {c.body for c in k1.qp_settings(itemsize, *shape)}
    if itemsize == 4:
        assert k1.qp_config(itemsize, *shape).body == (
            "tf32" if shape in TF32_MEASURED else "simt")
        assert bodies <= {"simt", "tf32"}
    else:
        assert k1.qp_config(itemsize, *shape).body == (
            "hmma" if label in HMMA_SHAPES else "simt")
        assert bodies <= {"simt", "hmma"}


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("label,shape", K1_SHAPES)
def test_qp_config_takes_no_hmma_outside_bf16(label, shape, itemsize):
    """HMMA is bf16's alone: neither qp_config nor the sweep takes it in
    f32 or f64."""
    assert k1.qp_config(itemsize, *shape).body != "hmma"
    assert "hmma" not in {c.body for c in k1.qp_settings(itemsize, *shape)}


@pytest.mark.parametrize("itemsize", [2, 8])
@pytest.mark.parametrize("label,shape", K1_SHAPES)
def test_qp_config_takes_no_tf32_outside_f32(label, shape, itemsize):
    """TF32 is f32's alone: neither qp_config nor the sweep takes it in
    bf16 or f64."""
    assert k1.qp_config(itemsize, *shape).body != "tf32"
    assert "tf32" not in {c.body for c in k1.qp_settings(itemsize, *shape)}


@pytest.mark.parametrize("shape", sorted(key[1:] for key in k1.QP_MEASURED
                                         if key[0] == 4))
def test_qp_config_takes_tf32_only_where_measured(shape):
    """In f32 qp_config takes the TF32 body only where QP_MEASURED names
    it (b05 8^3, TF32_MEASURED), and SIMT at every other f32 row the sweep
    left there (b04 8^2 among them, whose 8 x 7 C12T fills no m64 tile):
    the TF32 form C12T held, at one of its tiles with the plane group of
    its two warp groups' 128 columns, in blocks of 256 threads whose
    buffers fit two an SM."""
    cfg = k1.qp_config(4, *shape)
    assert cfg == k1.QP_MEASURED[(4, *shape)]
    if shape not in TF32_MEASURED:
        assert cfg.body == "simt"
        return
    assert cfg.body == "tf32" and cfg.c12t == "regs"
    assert k1.qp_tf32_takes(shape[1], shape[3])
    assert cfg.et in k1.QP_TF32_TILES and cfg.threads == k1.QP_THREADS
    assert cfg.planes * cfg.et == k1.QP_TF32_COLUMNS
    smem = k1.qp_smem(4, cfg.et, cfg.planes, *shape, cfg.depth, cfg.body,
                      cfg.c12t)
    assert 2 * (smem + k1.SMEM_RESERVED) <= k1.SMEM_SM


def test_qp_smem_counts_tf32_buffers():
    """The TF32 body's shared memory: V as two halves (big and small) of
    its 7 k steps of 8 rows by the plane group's 128 columns whatever nrq
    (rows past nrq zero); no C12T buffer (held in registers); the rest as
    SIMT's.  The ring's (16, 8) fits two blocks an SM, (32, 4) at depth 2
    only one."""
    v = 2 * 56 * 128
    # b05 8^3: the slab(s) (343 x et), V, B0
    assert k1.qp_smem(4, 16, 8, 7, 49, 8, 64, 2, "tf32", "regs") == \
        16 + 4 * (2 * 343 * 16 + v + 7 * 8) == 101488
    assert k1.qp_smem(4, 16, 8, 7, 49, 8, 64, 1, "tf32", "regs") == 4 * (
        343 * 16 + v + 7 * 8) == 79520
    assert k1.qp_smem(4, 32, 4, 7, 49, 8, 64, 1, "tf32", "regs") == 4 * (
        343 * 32 + v + 7 * 8) == 101472
    assert k1.qp_smem(4, 32, 4, 7, 49, 8, 64, 2, "tf32", "regs") == 145392
    assert 2 * (101488 + k1.SMEM_RESERVED) <= k1.SMEM_SM
    assert 2 * (145392 + k1.SMEM_RESERVED) > k1.SMEM_SM
    # b05 6^3: nrq = 25, V the same; nq0 = 6 pads to the group's 8 planes
    # of B0
    assert k1.qp_smem(4, 16, 8, 5, 25, 6, 36, 1, "tf32", "regs") == 4 * (
        125 * 16 + v + 5 * 8)
    # b04 8^2: nrq = 7
    assert k1.qp_smem(4, 32, 4, 7, 7, 8, 8, 1, "tf32", "regs") == 4 * (
        49 * 32 + v + 7 * 8)


@pytest.mark.parametrize("nrq,nkj,takes", [
    (49, 64, True), (56, 64, True), (25, 36, True), (31, 32, True),
    (7, 8, True), (57, 64, False), (49, 65, False), (81, 100, False)])
def test_qp_tf32_takes_what_its_warps_hold(nrq, nkj, takes):
    """The TF32 body holds C12T in registers as one m64 tile (nkj <= 64),
    7 k steps of 8 rq (nrq <= 56): b05 to 8^3 and b04 to 32^2, not b05
    10^3.  It has no staged form, so past that it has no place for C12T
    and the sweep has no TF32 setting; its settings are the ring's tiles
    with the plane group of 128 columns, in blocks of 256 threads, at
    either depth."""
    assert k1.qp_tf32_takes(nrq, nkj) is takes
    assert k1.qp_c12t_places("tf32", nrq, nkj) == (("regs",) if takes
                                                   else ())
    tf32 = {c for c in k1.qp_settings(4, 1, nrq, 4, nkj) if c.body == "tf32"}
    assert {c.c12t for c in tf32} == ({"regs"} if takes else set())
    assert {(c.et, c.planes) for c in tf32} == (
        {(16, 8), (32, 4)} if takes else set())
    assert {(c.depth, c.threads) for c in tf32} == (
        {(1, 256), (2, 256)} if takes else set())


@pytest.mark.parametrize("itemsize", [2, 8])
def test_qp_launch_config_refuses_tf32_outside_f32(itemsize):
    """The body knob takes "tf32" in f32 only: bf16 and f64 have no such
    instance."""
    with pytest.raises(ValueError, match="body='tf32' is not one of"):
        k1.qp_launch_config(itemsize, 7, 49, 8, 64, 16, 8, body="tf32")


def test_qp_launch_config_takes_tf32_in_f32():
    """In f32 the knob takes TF32 at its tiles, each with the plane group
    of 128 columns unless one is given, C12T held (its one place), and
    refuses another plane group, a tile it is not built for, the
    512-thread ring, C12T staged and a shape past what its warps hold.
    The entry's body code is the kernel's QP_TF32, 4."""
    assert k1.QP_ENTRY_BODIES["tf32", "regs", "simt"] == 4
    assert k1.qp_built_bodies(4, 16) == k1.qp_built_bodies(4, 32) == \
        ("simt", "tf32")
    assert "tf32" not in k1.qp_built_bodies(4, 64) + k1.qp_built_bodies(4, 128)
    assert k1.qp_forms(4, 16, "tf32") == ((1, 256), (2, 256))
    assert k1.qp_tf32_planes(16) == 8 and k1.qp_tf32_planes(32) == 4
    assert k1.qp_launch_config(4, 7, 49, 8, 64, 16, None, body="tf32") == \
        k1.QPConfig(16, 8, 1, 256, "tf32", "regs")
    assert k1.qp_launch_config(4, 7, 49, 8, 64, 32, None, depth=2,
                               body="tf32") == \
        k1.QPConfig(32, 4, 2, 256, "tf32", "regs")
    # b04 8^2, whose rule is SIMT: TF32 asked for at a tile of its own
    assert k1.qp_launch_config(4, 7, 7, 8, 8, 32, None, body="tf32") == \
        k1.QPConfig(32, 4, 1, 256, "tf32", "regs")
    with pytest.raises(ValueError, match="planes=8 with body='tf32'"):
        k1.qp_launch_config(4, 7, 49, 8, 64, 32, 8, body="tf32")
    with pytest.raises(ValueError, match="bodies"):
        k1.qp_launch_config(4, 7, 49, 8, 64, 64, None, body="tf32")
    with pytest.raises(ValueError, match="forms"):
        k1.qp_launch_config(4, 7, 49, 8, 64, 16, None, depth=2, threads=512,
                            body="tf32")
    with pytest.raises(ValueError, match=r"where='smem' is not one of"):
        k1.qp_launch_config(4, 7, 49, 8, 64, 16, None, body="tf32",
                            where="smem")
    with pytest.raises(ValueError, match=r"is not one of \(\)"):
        k1.qp_launch_config(4, 9, 81, 10, 100, 16, None, body="tf32")
    # the SIMT body asked for where the rule takes TF32: the rule's tile,
    # group and form, C12T staged
    assert k1.qp_launch_config(4, 7, 49, 8, 64, None, None,
                               body="simt") == \
        k1.QPConfig(32, 4, 1, 256, "simt", "smem")


@pytest.mark.parametrize("shape,body", [
    ((5, 25, 6, 36), "hmma"), ((7, 49, 8, 64), "hmma"),
    ((31, 31, 32, 32), "hmma"), ((4, 16, 5, 25), "hmma"),
    ((7, 7, 8, 8), "simt"), ((15, 15, 16, 16), "simt"),
    ((3, 9, 4, 16), "simt"), ((9, 81, 10, 100), "hmma"),
    ((1, 97, 2, 100), "simt"), ((8, 64, 9, 144), "simt")])
def test_qp_config_takes_hmma_where_c12t_fills_its_tile(shape, body):
    """In bf16 qp_config takes HMMA, C12T held in registers, where C12T
    fills a whole m16n8k16 tile (nkj >= 16 and nrq >= 16) and
    qp_hmma_takes the shape: b05 6^3, 8^3 and 10^3 (QP_MEASURED's), b04
    32^2 (nrq = 31) and b05 5^3 (nrq = 16); SIMT at b04 8^2 (nkj = 8) and
    16^2 (nrq = 15), b05 4^3 (nrq = 9) and past what the warps hold (nrq =
    97, nkj = 144)."""
    cfg = k1.qp_config(2, *shape)
    assert cfg.body == body
    assert cfg.c12t == ("regs" if body == "hmma" else "smem")
    assert k1.qp_smem(2, cfg.et, cfg.planes, *shape, cfg.depth, cfg.body,
                      cfg.c12t) <= k1.SMEM_BLOCK
    if body == "hmma":
        assert cfg.et in k1.QP_HMMA_TILES


def test_qp_smem_counts_hmma_buffers():
    """The HMMA body's shared memory: V's rows in whole pairs (nrq rounded
    up to even), no C12T buffer (held in registers), the rest as SIMT's."""
    # b05 8^3, tile 64, 4 planes: the slab (343 x 64), V (4 x 50 x 64), B0
    assert k1.qp_smem(2, 64, 4, 7, 49, 8, 64, 1, "hmma", "regs") == 2 * (
        343 * 64 + 4 * 50 * 64 + 7 * 8) == 69616
    assert k1.qp_smem(2, 32, 8, 7, 49, 8, 64, 2, "hmma", "regs") == \
        16 + 2 * (2 * 343 * 32 + 8 * 50 * 32 + 7 * 8) == 69632
    # SIMT at the same tile: V of 49 rows, C12T^T (49 x 64)
    assert k1.qp_smem(2, 64, 4, 7, 49, 8, 64) == 2 * (
        343 * 64 + 4 * 49 * 64 + 49 * 64 + 7 * 8)
    # b05 10^3: nrq = 81 pads to 82 rows, nq0 = 10 to 16 planes of B0
    assert k1.qp_smem(2, 16, 8, 9, 81, 10, 100, 1, "hmma", "regs") == 2 * (
        729 * 16 + 8 * 82 * 16 + 9 * 16)
    # b04 32^2: nrq = 31 pads to 32
    assert k1.qp_smem(2, 32, 8, 31, 31, 32, 32, 1, "hmma", "regs") == 2 * (
        961 * 32 + 8 * 32 * 32 + 31 * 32)
    # an even nrq takes no pad row
    assert k1.qp_smem(2, 16, 4, 5, 36, 7, 49, 1, "hmma", "regs") == 2 * (
        180 * 16 + 4 * 36 * 16 + 5 * 8)


@pytest.mark.parametrize("nrq,nkj,takes", [
    (49, 64, True), (81, 100, True), (96, 128, True), (31, 32, True),
    (7, 8, True), (97, 100, False), (81, 129, False), (100, 121, False)])
def test_qp_hmma_takes_what_its_warps_hold(nrq, nkj, takes):
    """HMMA holds C12T in registers, each of a block's 8 warps one m tile
    of 16 kj rows (nkj <= 128) as 6 k steps of 16 rq (nrq <= 96): every
    b05 order to 10^3 and b04 to 32^2.  It has no staged form, so past
    that it has no place for C12T and the sweep has no HMMA setting; its
    blocks are of 256 threads at either depth."""
    assert k1.qp_hmma_takes(nrq, nkj) is takes
    assert k1.qp_c12t_places("hmma", nrq, nkj) == (("regs",) if takes
                                                   else ())
    shape = (1, nrq, 4, nkj)
    hmma = {c for c in k1.qp_settings(2, *shape) if c.body == "hmma"}
    assert {c.c12t for c in hmma} == ({"regs"} if takes else set())
    assert {c.et for c in hmma} <= set(k1.QP_HMMA_TILES)
    assert {c.threads for c in hmma} <= {k1.QP_THREADS}


@pytest.mark.parametrize("itemsize", [4, 8])
def test_qp_launch_config_refuses_hmma_outside_bf16(itemsize):
    """The body knob takes "hmma" in bf16 only: f32 and f64 have no such
    instance, at qp_config's tile or a given one."""
    with pytest.raises(ValueError, match="body='hmma' is not one of"):
        k1.qp_launch_config(itemsize, 7, 49, 8, 64, None, None,
                            body="hmma")
    with pytest.raises(ValueError, match="body='hmma' is not one of"):
        k1.qp_launch_config(itemsize, 7, 49, 8, 64, 16, 8, body="hmma")


def test_qp_launch_config_takes_hmma_in_bf16():
    """In bf16 the knob takes HMMA at its tiles, C12T held (its one
    place), and refuses it at a tile it is not built for, with C12T
    staged, and past what its warps hold."""
    assert k1.qp_launch_config(2, 7, 49, 8, 64, 16, 8, body="hmma") == \
        k1.QPConfig(16, 8, 1, 256, "hmma", "regs")
    assert k1.qp_launch_config(2, 7, 49, 8, 64, 32, 8, depth=2,
                               body="hmma") == \
        k1.QPConfig(32, 8, 2, 256, "hmma", "regs")
    # no ring of 512 threads on HMMA (SIMT has one)
    with pytest.raises(ValueError, match="forms"):
        k1.qp_launch_config(2, 7, 49, 8, 64, 32, 8, depth=2, threads=512,
                            body="hmma")
    assert k1.qp_launch_config(2, 7, 49, 8, 64, 32, 8, depth=2,
                               threads=512).body == "simt"
    # b04 8^2, whose rule is SIMT: HMMA asked for at a tile of its own
    assert k1.qp_launch_config(2, 7, 7, 8, 8, 16, 8, body="hmma") == \
        k1.QPConfig(16, 8, 1, 256, "hmma", "regs")
    with pytest.raises(ValueError, match="bodies"):
        k1.qp_launch_config(2, 7, 49, 8, 64, 128, 4, body="hmma")
    with pytest.raises(ValueError, match="forms"):
        k1.qp_launch_config(2, 7, 49, 8, 64, 64, 4, depth=2, body="hmma")
    with pytest.raises(ValueError, match=r"where='smem' is not one of"):
        k1.qp_launch_config(2, 7, 49, 8, 64, 16, 8, body="hmma",
                            where="smem")
    with pytest.raises(ValueError, match=r"is not one of \(\)"):
        k1.qp_launch_config(2, 1, 97, 2, 100, 16, 8, body="hmma")


def test_qp_config_takes_dmma_at_10_cubed_f64():
    """At b05 10^3 in f64 (cell hex10-f64-qp) K1's stage 2, 92% of its
    FLOP, runs on the FP64 tensor units: the sweep's (16, 4) in the slab
    ring on DMMA, which fits a block (228,976 B) since C12T is held in
    registers and V is unpadded."""
    assert k1.qp_config(8, 9, 81, 10, 100) == k1.QPConfig(16, 4, 2, 256,
                                                          "dmma", "regs")
    assert k1.qp_smem(8, 16, 4, 9, 81, 10, 100, 2, "dmma", "regs") == \
        228976 <= k1.SMEM_BLOCK


@pytest.mark.parametrize("shape,body", [
    ((8, 64, 9, 81), "dmma"), ((6, 36, 7, 49), "dmma"),
    ((4, 4, 5, 5), "simt"), ((1, 1, 2, 4), "simt"), ((13, 13, 14, 14),
                                                     "simt"),
    ((1, 90, 2, 100), "dmma"), ((8, 64, 9, 144), "dmma")])
def test_qp_config_default_rule_for_f64(shape, body):
    """Off the measured table, f64 takes DMMA with C12T staged where C12T
    holds a whole m16n8k8 tile (nkj >= 16, nrq >= 8) and a tile of
    QP_DMMA_TILES fits, also past what the held form serves (nrq = 90, nkj
    = 144), with the SIMT rule's choice of tile and group among those;
    else SIMT."""
    assert (8, *shape) not in k1.QP_MEASURED
    cfg = k1.qp_config(8, *shape)
    assert cfg.body == body and cfg.depth == 1 and cfg.c12t == "smem"
    assert cfg.et in (k1.QP_DMMA_TILES if body == "dmma" else
                      k1.QP_TILES[8])
    assert cfg.planes == k1.qp_planes(cfg.et, shape[3])
    assert k1.qp_smem(8, cfg.et, cfg.planes, *shape, 1, body) <= \
        k1.SMEM_BLOCK


@pytest.mark.parametrize("itemsize,shape,depth", [
    (4, (5, 25, 6, 36), 2), (8, (7, 49, 8, 64), 2),
    (8, (31, 31, 32, 32), 1), (8, (9, 81, 10, 100), 2)])
def test_qp_config_takes_the_ring_where_measured(itemsize, shape, depth):
    """Depth 2 at b05 nq=6^3 in f32 (SIMT), at the benchmark's b05 nq=8^3
    in f64 and at 10^3 in f64 (on DMMA), where the sweep measured the ring
    faster (at 8^3 in f32 the TF32 body's depth 1 beat its ring); depth 1
    at b04 nq=32^2, where two slabs of the chosen tile do not fit a block.
    Either way the buffers, slots included, fit one block's shared
    memory."""
    cfg = k1.qp_config(itemsize, *shape)
    assert cfg.depth == depth
    assert k1.qp_smem(itemsize, cfg.et, cfg.planes, *shape,
                      cfg.depth, cfg.body, cfg.c12t,
                      cfg.stage1) <= k1.SMEM_BLOCK
    if depth == 1:
        assert k1.qp_smem(itemsize, cfg.et, cfg.planes, *shape,
                          2, cfg.body, cfg.c12t,
                          cfg.stage1) > k1.SMEM_BLOCK


# ---- K1's stage 1 on DMMA (QP_DMMA_S1) -------------------------------------

# The DMMA stage 1's element tile (the m16 side of its products)
S1_ET = 16


def _v_col(rq, e):
    """csrc/qp_fused3d.cuh qp_v_col: DMMA's V column of element e, row rq."""
    return e ^ ((rq & 7) << 1)


def _v_col_s1(g, rq, e):
    """qp_v_col_s1: the DMMA stage 1's V column of element e, row rq of
    plane g: qp_v_col's, its 16-byte word also XORed with 2 (g / 2 % 4)."""
    return _v_col(rq, e) ^ ((g >> 1 & 3) << 2)


def _banks(offsets):
    """The bank groups (16 bytes of the 128 of a row of banks) of 16-byte
    accesses at `offsets` (doubles, each on a 16-byte boundary)."""
    assert all(o % 2 == 0 for o in offsets)
    return [o // 2 % 8 for o in offsets]


def _stage1_dmma(slab, b0, nq0, i0, planes):
    """qp_stage1_dmma emulated lane by lane at one plane group [i0, i0 +
    planes) of one tile: the slab (nm0, nrq, 16) copied into shared memory
    at rows of qp_slab_ld values, NaN wherever the copy writes nothing (the
    pads and past the last p), B0 (nm0, nq0) staged with nq0 padded to the
    group, the units (rq rows) dealt to 8 warps in turn, and each k step's
    A, B and D fragments placed at the m16n8k8 f64 positions of
    tbt::mma_f64_16x8x8 (a[i] at (g + 8 (i % 2), t + 4 (i / 2)), b[i] at
    (t + 4i, g), d[i] at (g + 8 (i / 2), 2t + i % 2)).  Returns V (planes
    of nrq x 16 at their swizzled columns), each quarter warp's 16-byte
    loads and stores (offsets in doubles) and the units of each warp."""
    nm0, nrq, et = slab.shape
    ld = k1.qp_slab_ld(et, "dmma")
    ps = nrq * ld
    smem = np.full((nm0 + 1) * ps, np.nan)
    for p in range(nm0):
        for rq in range(nrq):
            smem[p * ps + rq * ld:p * ps + rq * ld + et] = slab[p, rq]
    nq0p = -(-nq0 // planes) * planes
    s_b0 = np.zeros((nm0, nq0p))
    s_b0[:, :nq0] = b0
    v = np.full(planes * nrq * et, np.nan)
    loads, stores, dealt = [], [], {}
    for w in range(8):
        for rq in range(w, nrq, 8):
            dealt.setdefault(w, []).append(rq)
            acc = np.zeros((planes // 8, 32, 4))
            for s in range(k1.QP_S1_STEPS):
                if s * k1.QP_MMA_K >= nm0:
                    break
                a = np.zeros((16, 8))
                b = np.zeros((planes // 8, 8, 8))
                step = []
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    p = s * k1.QP_MMA_K + 2 * t
                    x = p * ps + rq * ld + 2 * g
                    lo = smem[x:x + 2] if p < nm0 else np.zeros(2)
                    hi = smem[x + ps:x + ps + 2] if p + 1 < nm0 else \
                        np.zeros(2)
                    step.append((x, x + ps))
                    af = [lo[0], lo[1], hi[0], hi[1]]
                    for i in range(4):
                        a[g + 8 * (i % 2), t + 4 * (i // 2)] = af[i]
                    for n in range(planes // 8):
                        for i in range(2):
                            b[n, t + 4 * i, g] = (
                                s_b0[p + i, i0 + 8 * n + g]
                                if p + i < nm0 else 0.0)
                loads += [[step[lane][h] for lane in range(q, q + 8)]
                          for q in range(0, 32, 8) for h in range(2)]
                for n in range(planes // 8):
                    d = a @ b[n]
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        for i in range(4):
                            acc[n, lane, i] += d[g + 8 * (i // 2),
                                                 2 * t + i % 2]
            for n in range(planes // 8):
                put = []
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    at = [(pl * nrq + rq) * et + _v_col_s1(pl, rq, 2 * g)
                          for pl in (8 * n + 2 * t, 8 * n + 2 * t + 1)]
                    v[at[0]:at[0] + 2] = acc[n, lane, [0, 2]]
                    v[at[1]:at[1] + 2] = acc[n, lane, [1, 3]]
                    put.append(at)
                stores += [[put[lane][h] for lane in range(q, q + 8)]
                           for q in range(0, 32, 8) for h in range(2)]
    return v, loads, stores, dealt


@pytest.mark.parametrize("nm0,nrq,nq0,planes", [
    (31, 31, 32, 16), (31, 31, 32, 8), (5, 7, 6, 16), (9, 81, 10, 8)],
    ids=["b04 32^2", "b04 32^2 G=8", "ragged", "b05 10^3 G=8"])
def test_qp_stage1_dmma_lane_map_forms_v(nm0, nrq, nq0, planes):
    """The DMMA stage 1's lane map, emulated lane by lane (_stage1_dmma):
    with k slots t and t + 4 at p = 2t and 2t + 1 in A and B, m rows g and
    g + 8 at elements 2g and 2g + 1, p past nm0 zero in registers (the
    emulated shared memory holds NaN there and in the rows' pads, so a
    read of it would show), V at qp_v_col_s1, it forms every plane group's
    V within 1e-14 of einsum, planes past nq0 zero, and deals each rq row
    to one warp once: at b04 32^2 in the cell's groups of 16 planes (nm0 =
    31: the last k step holds one p past nm0) and in groups of 8, a ragged
    shape (nm0 = 5 in one partial k step, nrq = 7 rows for 8 warps, nq0 =
    6 in a group of 16) and b05 10^3 (nm0 = 9, nrq = 81: warp 0 takes one
    row more than the others)."""
    rng = np.random.default_rng(nm0 * nrq)
    slab = rng.standard_normal((nm0, nrq, S1_ET))
    b0 = rng.standard_normal((nm0, nq0))
    for i0 in range(0, nq0, planes):
        v, _, _, dealt = _stage1_dmma(slab, b0, nq0, i0, planes)
        assert sorted(rq for units in dealt.values() for rq in units) == \
            list(range(nrq))
        valid = min(planes, nq0 - i0)
        ref = np.zeros((planes, nrq, S1_ET))
        ref[:valid] = np.einsum("pi,pre->ire", b0[:, i0:i0 + valid], slab)
        got = np.array([[[v[(g * nrq + rq) * S1_ET + _v_col_s1(g, rq, e)]
                          for e in range(S1_ET)] for rq in range(nrq)]
                        for g in range(planes)])
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-14 * np.abs(ref).max())


def test_qp_stage1_dmma_hits_distinct_banks():
    """At b04 32^2 every 16-byte access of a quarter warp in the DMMA
    stage 1 hits its own bank group: the A loads (p = 2t apart at rows of
    18 values, 31 x 36 t = 4t mod 16 values) and the stores into V (planes
    8n + 2t and 8n + 2t + 1 of one row at qp_v_col_s1); stage 2's B loads
    of V at the same columns stay conflict-free, and read each value where
    stage 1 stored it.  At rows of 16 values the loads would conflict 4
    ways, and so would the stores at qp_v_col alone."""
    nm0, nrq, nq0, planes = 31, 31, 32, 16
    slab = np.ones((nm0, nrq, S1_ET))
    _, loads, stores, _ = _stage1_dmma(slab, np.ones((nm0, nq0)), nq0, 0,
                                       planes)
    for group in loads + stores:
        assert sorted(_banks(group)) == list(range(8)), group
    assert len(set(_banks([2 * t * nrq * S1_ET + 2 * g for g in (0, 1)
                           for t in range(4)]))) == 2
    assert len(set(_banks([(2 * t * nrq + 5) * S1_ET + _v_col(5, 2 * g)
                           for g in (0, 1) for t in range(4)]))) == 2
    # stage 2 (qp_stage2_dmma, C12T held): lane 4g + t of a unit loads
    # rows k + 2t + r of one plane at elements 2g, 2g + 1
    for plane in range(planes):
        for k in range(0, nrq, k1.QP_MMA_K):
            for r in range(2):
                for q in range(0, 32, 8):
                    at = []
                    for lane in range(q, q + 8):
                        g, t = lane // 4, lane % 4
                        base = (plane * nrq + 2 * t + r) * S1_ET + \
                            _v_col_s1(plane, 2 * t + r, 2 * g)
                        at.append(base + k * S1_ET)
                        rq = k + 2 * t + r
                        assert base + k * S1_ET == (plane * nrq + rq) * \
                            S1_ET + _v_col_s1(plane, rq, 2 * g)
                    assert sorted(_banks(at)) == list(range(8))


def test_qp_config_takes_the_dmma_stage_1_only_at_b04_32_squared():
    """QP_MEASURED names stage 1 on DMMA at (8, 31, 31, 32, 32) alone, the
    plane view at 32^2 in f64 (cell quad32-f64-qp), beside the held DMMA
    stage 2 at (16, 16, 1, 256); every other measured shape and every
    order both benchmarks sweep keeps the SIMT stage 1 in any dtype."""
    assert [key for key, cfg in k1.QP_MEASURED.items()
            if cfg.stage1 == "dmma"] == [(8, 31, 31, 32, 32)]
    assert k1.qp_config(8, 31, 31, 32, 32) == k1.QPConfig(
        16, 16, 1, 256, "dmma", "regs", "dmma")
    assert k1.qp_entry_body(k1.qp_config(8, 31, 31, 32, 32)) == 5
    for (itemsize, *shape), cfg in k1.QP_MEASURED.items():
        if (itemsize, *shape) != (8, 31, 31, 32, 32):
            assert k1.qp_config(itemsize, *shape).stage1 == "simt"
    for _, shape in K1_SHAPES:
        for itemsize in (2, 4, 8):
            if (itemsize, *shape) != (8, 31, 31, 32, 32):
                assert k1.qp_config(itemsize, *shape).stage1 == "simt"


@pytest.mark.parametrize("itemsize,shape,settings", [
    (8, (31, 31, 32, 32), 1), (8, (7, 49, 8, 64), 1),
    (8, (9, 81, 10, 100), 0), (8, (7, 7, 8, 8), 1), (8, (1, 90, 2, 100), 0),
    (8, (33, 33, 34, 34), 0), (4, (31, 31, 32, 32), 0),
    (2, (31, 31, 32, 32), 0)])
def test_qp_smem_counts_the_dmma_stage_1(itemsize, shape, settings):
    """The DMMA stage 1's slab rows are QP_S1_PAD values longer than the
    SIMT form's (b04 32^2: 961 x 2 doubles, 15,376 B), its persistent
    blocks keep the slots' tiles in front, and its one setting, (16, 16,
    1, 256) beside DMMA with C12T held, is in the sweep wherever it is
    built and fits SMEM_BLOCK: in f64, where C12T is held (nrq <= 88, nkj
    <= 128) and nm0 <= 32; not at b05 10^3 (272,032 B), past what the
    warps hold (nrq = 90), past 32 p (nm0 = 33), nor in f32 or bf16."""
    nm0, nrq, nq0, nkj = shape
    held = k1.qp_smem(itemsize, 16, 16, *shape, 1, "dmma", "regs")
    dmma = k1.qp_smem(itemsize, 16, 16, *shape, 1, "dmma", "regs", "dmma")
    assert dmma - held == 16 + itemsize * nm0 * nrq * k1.QP_S1_PAD
    assert k1.qp_slab_ld(16, "dmma") == 18 and k1.qp_slab_ld(16) == 16
    found = [c for c in k1.qp_settings(itemsize, *shape)
             if c.stage1 == "dmma"]
    assert found == [k1.QPConfig(16, 16, 1, 256, "dmma", "regs",
                                 "dmma")] * settings
    assert not [c for c in k1.qp_settings(itemsize, *shape)
                if (c.planes == 16) != (c.stage1 == "dmma")]
    if itemsize == 8 and shape != (9, 81, 10, 100):
        assert k1.qp_s1_dmma_takes(nm0, nrq, nkj) is (settings == 1)
    if shape == (9, 81, 10, 100):
        assert dmma == 272_032 > k1.SMEM_BLOCK
    for c in found:
        assert k1.qp_smem(itemsize, c.et, c.planes, *shape, c.depth, c.body,
                          c.c12t, c.stage1) == dmma <= k1.SMEM_BLOCK


@pytest.mark.parametrize("itemsize", [2, 4])
def test_qp_launch_config_refuses_the_dmma_stage_1_outside_f64(itemsize):
    """The stage1 knob takes "dmma" in f32 and bf16 at no setting: they
    have no such instance."""
    with pytest.raises(ValueError, match="stage1='dmma' is not one of"):
        k1.qp_launch_config(itemsize, 31, 31, 32, 32, 16, 16, stage1="dmma")
    with pytest.raises(ValueError, match="stage1='dmma' is not one of"):
        k1.qp_launch_config(itemsize, 31, 31, 32, 32, None, None,
                            stage1="dmma")


@pytest.mark.parametrize("knobs", [
    dict(body="simt"), dict(body="dmma", where="smem"),
    dict(body="dmma", where="regs", epb=32),
    dict(body="dmma", where="regs", planes=8),
    dict(body="dmma", where="regs", depth=2)],
    ids=["simt", "dmma-staged", "tile-32", "planes-8", "depth-2"])
def test_qp_launch_config_refuses_the_dmma_stage_1_off_its_form(knobs):
    """In f64 the stage1 knob takes "dmma" only beside DMMA with C12T held
    at (16, 16, 1, 256), its one instance: not beside the SIMT stage 2, nor
    with C12T staged, nor at another tile, plane group or depth."""
    epb, planes = knobs.pop("epb", 16), knobs.pop("planes", 16)
    with pytest.raises(ValueError, match="stage1='dmma' is not one of"):
        k1.qp_launch_config(8, 31, 31, 32, 32, epb, planes, stage1="dmma",
                            **knobs)


def test_qp_launch_config_takes_the_dmma_stage_1_in_f64():
    """The knobs force the DMMA stage 1 (its group of 16 planes unless
    planes are given) beside the held DMMA stage 2, also at a shape whose
    rule keeps SIMT (b05 8^3); a group of 16 planes is the DMMA stage 1's
    alone; the rule's setting at b04 32^2 takes it with no knob; a shape
    past 32 p refuses it."""
    forced = k1.QPConfig(16, 16, 1, 256, "dmma", "regs", "dmma")
    assert k1.qp_launch_config(8, 31, 31, 32, 32, 16, 16, depth=1,
                               body="dmma", where="regs",
                               stage1="dmma") == forced
    assert k1.qp_launch_config(8, 31, 31, 32, 32, None, None) == forced
    assert k1.qp_launch_config(8, 7, 49, 8, 64, 16, None, body="dmma",
                               where="regs", stage1="dmma") == forced
    assert k1.qp_launch_config(8, 7, 49, 8, 64, 16, 16, body="dmma",
                               where="regs") == forced
    assert k1.qp_launch_config(8, 7, 49, 8, 64, 16, 8, body="dmma",
                               where="regs").stage1 == "simt"
    with pytest.raises(ValueError, match="stage1='simt' is not one of"):
        k1.qp_launch_config(8, 31, 31, 32, 32, None, None, stage1="simt")
    with pytest.raises(ValueError, match="stage1='simt' is not one of"):
        k1.qp_launch_config(8, 7, 49, 8, 64, 16, 16, body="simt")
    with pytest.raises(ValueError, match="nm0 <= 32"):
        k1.qp_launch_config(8, 33, 33, 34, 34, 16, 16, body="dmma",
                            where="regs", stage1="dmma")
    with pytest.raises(ValueError, match="planes=12 is not one of"):
        k1.qp_launch_config(8, 7, 49, 8, 64, 16, 12)


@pytest.mark.parametrize("et,nkj,planes", [(32, 64, 4), (16, 64, 8),
                                           (128, 8, 8), (16, 100, 4),
                                           (32, 32, 8), (64, 16, 8)])
def test_qp_planes_fills_stage_2(et, nkj, planes):
    """8 planes a pass where 4 would leave more than half of the block's
    256 threads without a stage-2 micro-tile (8 kj rows x 4 elements)."""
    assert k1.qp_planes(et, nkj) == planes


@pytest.mark.cuda
@pytest.mark.parametrize("nq,sizes", [
    ((8, 8, 8), (1000, 131071)), ((3, 4, 5), (1000, 131071)),
    ((32, 32), (1000, 131071)), ((10, 12), (1000, 131071)),
    ((10, 10, 10), (1000,)), ((8, 8, 8), (4099,)), ((5, 6, 7), (1000,))])
def test_qp_fused3d_every_config_on_card(nq, sizes):
    """K1 at every (element tile, plane group, depth, threads, body, C12T's
    place) that fits, and qp_config's, on E elements that are no multiple of a tile:
    within 1e-5 (f32), 1e-12 (f64) and 2^-7 (bf16, whose rounding of v and
    of each output may fall either side of a tie on other f32 sums) of the
    plain version, relative to the largest output.  The f64 DMMA body
    (C12T staged, and held in registers) at
    b05 10^3 (E = 1000, a ragged last tile, and in the ring fewer tiles
    than blocks), 8^3 (E = 4099) and on shapes whose nkj and nrq are no
    multiples of 16 and 8 ((3, 4, 5): 20 and 12; (5, 6, 7): 42 and 30),
    where its held C12T fragments are zero past nkj and nrq and its last
    k step is masked.  Each depth-2 form also runs twice back to back on
    one stream with no synchronisation between: the second launch takes
    its tiles from the counter the first set back to zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if len(nq) == 3:
        nm0, nrq, nq0, nkj = nq[0] - 1, (nq[1] - 1) * (nq[2] - 1), nq[0], \
            nq[1] * nq[2]
    else:
        nm0, nrq, nq0, nkj = nq[0] - 1, nq[1] - 1, nq[0], nq[1]
    gen = torch.Generator(device="cuda").manual_seed(sum(nq))
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12),
                       (torch.bfloat16, 2**-7)):
        size = dtype.itemsize
        for e in sizes:
            x, b0, c = (torch.randn(*s, generator=gen, device="cuda",
                                    dtype=dtype)
                        for s in ((nm0, nrq, e), (nm0, nq0), (nkj, nrq)))
            ref = k1.qp_shared3d_plain(x, b0, c)
            configs = [(None,) * 7] + k1.qp_settings(
                size, nm0, nrq, nq0, nkj)
            for et, g, d, t, body, where, s1 in configs:
                out = k1.qp_shared3d(x, b0, c, epb=et, planes=g, depth=d,
                                     threads=t, body=body, where=where,
                                     stage1=s1)
                card_agree(out, ref, dtype, tol, (e, et, g, d, t, body,
                                                  where, s1))
            for et, g, d, t, body, where, s1 in configs[1:]:
                if d == 2:
                    outs = [k1.qp_shared3d(x, b0, c, epb=et, planes=g,
                                           depth=d, threads=t, body=body,
                                           where=where, stage1=s1)
                            for _ in range(2)]
                    for n, out in enumerate(outs):
                        card_agree(out, ref, dtype, tol,
                                   (e, et, g, d, t, body, where, s1, n))


@pytest.mark.cuda
@pytest.mark.parametrize("nq,e", [
    ((8, 8, 8), 4099), ((8, 8, 8), 4104), ((10, 10, 10), 1000),
    ((5, 6, 7), 1000), ((32, 32), 1000)],
    ids=["b05 8^3 E=4099", "b05 8^3 E=4104", "b05 10^3", "(5,6,7)",
         "b04 32^2"])
def test_qp_fused3d_hmma_on_card(nq, e):
    """K1's bf16 tensor-core body (HMMA) at every (tile, planes, depth,
    threads) it is built for, and qp_config's choice, against the plain
    version in bf16 within 2^-7 of the largest output and the norms within
    1e-4: at b05 8^3 on E = 4099 (rows of out off 16-byte boundaries, so
    every store is masked per value, and a last tile of 3 elements) and E
    = 4104 (16-byte stores, a ragged last tile), 10^3 (nrq = 81, nkj =
    100: a partial last k step, an odd nrq, and a partial last m tile of
    4 rows), (5, 6, 7) (nrq = 30, nkj = 42, nq0 = 5: planes past nq0 in a
    group) and b04 32^2 on the plane view (nrq = 31, nkj = 32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if len(nq) == 3:
        nm0, nrq, nq0, nkj = nq[0] - 1, (nq[1] - 1) * (nq[2] - 1), nq[0], \
            nq[1] * nq[2]
    else:
        nm0, nrq, nq0, nkj = nq[0] - 1, nq[1] - 1, nq[0], nq[1]
    gen = torch.Generator(device="cuda").manual_seed(e + sum(nq))
    x, b0, c = (torch.randn(*s, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
                for s in ((nm0, nrq, e), (nm0, nq0), (nkj, nrq)))
    ref = k1.qp_shared3d_plain(x, b0, c)
    settings = [v for v in k1.qp_settings(2, nm0, nrq, nq0, nkj)
                if v.body == "hmma"]
    assert len(settings) >= 6
    for v in [None, *settings]:
        out = (k1.qp_shared3d(x, b0, c) if v is None else
               k1.qp_shared3d(x, b0, c, epb=v.et, planes=v.planes,
                              depth=v.depth, threads=v.threads, body=v.body,
                              where=v.c12t))
        card_agree(out, ref, torch.bfloat16, 2**-7, (e, v))


# The f64 shapes (nm0, nrq, nq0, nkj) where the card test runs K1's DMMA
# stage 1: b04 32^2 (its rule's), b05 8^3 (nm0 = 7: one partial k step)
# and b05 at nq = (5, 6, 7) (nm0 = 4, nrq = 30: even, nq0 = 5 in a group
# of 16 planes, nkj = 42: a partial m tile)
S1_DMMA_SHAPES = [(31, 31, 32, 32), (7, 49, 8, 64), (4, 30, 5, 42)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", S1_DMMA_SHAPES,
                         ids=["b04 32^2", "b05 8^3", "b05 (5, 6, 7)"])
def test_qp_fused3d_s1_dmma_on_card(shape):
    """K1 with stage 1 on DMMA, forced through the knobs at (16, 16, 1)
    beside the held DMMA stage 2, its persistent blocks taking tiles from
    the stream's counter, on E = 1005 (a ragged last tile of 13
    elements, rows of out off 16-byte boundaries) and E = 4096 (whole
    tiles), the four launches on one stream with no synchronisation
    between: within 1e-12 of the plain version and of the held DMMA form
    with the SIMT stage 1 at (16, 8, 1), relative to the largest output;
    qp_stage1_bodies counts each launch under its stage-1 body, and at b04
    32^2 the rule's launch (no knob) is one on DMMA too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    nm0, nrq, nq0, nkj = shape
    gen = torch.Generator(device="cuda").manual_seed(nm0 * nrq)
    knobs = dict(epb=16, depth=1, threads=256, body="dmma", where="regs")
    ins = [[torch.randn(*s, generator=gen, device="cuda",
                        dtype=torch.float64)
            for s in ((nm0, nrq, e), (nm0, nq0), (nkj, nrq))]
           for e in (1005, 4096)]
    before = k1.qp_stage1_bodies.copy()
    outs = [k1.qp_shared3d(*xs, **knobs, planes=16, stage1="dmma")
            for xs in ins]
    simt = [k1.qp_shared3d(*xs, **knobs, planes=8, stage1="simt")
            for xs in ins]
    assert k1.qp_stage1_bodies - before == {("f64", "dmma"): 2,
                                            ("f64", "simt"): 2}
    for xs, out, other in zip(ins, outs, simt):
        e = xs[0].shape[2]
        card_agree(out, k1.qp_shared3d_plain(*xs), torch.float64, 1e-12,
                   (shape, e, "plain"))
        card_agree(out, other, torch.float64, 1e-12, (shape, e, "simt"))
    if shape == (31, 31, 32, 32):
        before = k1.qp_stage1_bodies.copy()
        out = k1.qp_shared3d(*ins[0])
        assert k1.qp_stage1_bodies - before == {("f64", "dmma"): 1}
        card_agree(out, outs[0], torch.float64, 1e-12, (shape, "rule"))


# The f32 shapes (nm0, nrq, nq0, nkj) where K1's TF32 body runs: b05 8^3
# and every shape QP_MEASURED gives it
TF32_SHAPES = sorted({(7, 49, 8, 64)} | {
    key[1:] for key, cfg in k1.QP_MEASURED.items() if cfg.body == "tf32"})
# K1's f32 output from the TF32 body against the f64 product of the same
# f32 inputs, relative to its largest output: f32 level (the SIMT body
# and K2's 3xTF32 read 2.5-4.4e-7 in the benchmark), where one TF32 pass
# reads about 3e-4
TF32_F64_RTOL = 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("e", [4096, 4099, 15],
                         ids=["whole tiles", "ragged", "under a tile"])
@pytest.mark.parametrize("shape", TF32_SHAPES, ids=str)
def test_qp_fused3d_tf32_on_card(shape, e):
    """K1's f32 stage 2 as 3xTF32 on wgmma at every (tile, planes, depth)
    it is built for, and qp_config's choice, on E a whole number of every
    tile, E no multiple of a tile (rows of out off 16-byte boundaries, so
    every store is masked per value) and E under one tile: within 1e-5 of
    the plain version and TF32_F64_RTOL of the f64 product, relative to
    the largest output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    nm0, nrq, nq0, nkj = shape
    gen = torch.Generator(device="cuda").manual_seed(e + nrq)
    x, b0, c = (torch.randn(*s, generator=gen, device="cuda")
                for s in ((nm0, nrq, e), (nm0, nq0), (nkj, nrq)))
    ref = k1.qp_shared3d_plain(x, b0, c)
    ref64 = k1.qp_shared3d_plain(x.double(), b0.double(), c.double())
    settings = [v for v in k1.qp_settings(4, nm0, nrq, nq0, nkj)
                if v.body == "tf32"]
    assert len(settings) >= 3
    for v in [None, *settings]:
        out = (k1.qp_shared3d(x, b0, c) if v is None else
               k1.qp_shared3d(x, b0, c, epb=v.et, planes=v.planes,
                              depth=v.depth, threads=v.threads, body=v.body,
                              where=v.c12t))
        card_agree(out, ref, torch.float32, 1e-5, (e, v))
        err = float((out.double() - ref64).abs().max() / ref64.abs().max())
        assert err <= TF32_F64_RTOL, (e, v, err)


# bf16's norm tolerance (test_torch_bf16's NORM_TOL): it catches a bias of
# one rounding step, which the elementwise 2^-7 lets through.
BF16_NORM_TOL = 1e-4


def card_agree(out, ref, dtype, tol, label):
    """A card kernel's out against its plain version's ref: both of
    `dtype` and ref's shape, out finite, the largest |out - ref| within tol
    of the largest |ref| (taken in f64), and in bf16 the norms within
    BF16_NORM_TOL."""
    torch.cuda.synchronize()
    label = (str(dtype), *label)
    assert out.dtype == ref.dtype == dtype, (label, out.dtype, ref.dtype)
    assert out.shape == ref.shape, (label, out.shape, ref.shape)
    assert bool(torch.isfinite(out).all()), label
    out, ref = out.double(), ref.double()
    err = float((out - ref).abs().max() / ref.abs().max())
    assert err <= tol, (label, err)
    if dtype == torch.bfloat16:
        norm = abs(float(out.norm()) / float(ref.norm()) - 1)
        assert norm <= BF16_NORM_TOL, (label, norm)


# ---- K4's work dealing (kernels/bwdtrans3d.qp2_grid, qp2_shares) -----------

# the blocks an H100 holds at once for K4's instances: 132 SMs times 1, 3
# and 8 blocks an SM
WAVES = [132, 396, 1056]


def k4_deal_holds(nm0, nkj, e, itemsize):
    """For the vector form (where F = nkj*E values are whole 16-byte
    vectors) and the scalar form, at every unroll and wave: one wave, the
    units dealt to the blocks in order, each exactly once, shares equal
    to within one unit, and a grid below a wave only where every block
    holds at most one tile."""
    f = nkj * e
    forms = [False] + ([True] if build.vector16(f, itemsize, 0, 0) else [])
    for vector in forms:
        nv = k1.qp2_units(f, itemsize, vector)
        assert nv * (16 // itemsize if vector else 1) == f
        for unroll in (k1.qp2_unrolls(itemsize, nm0) if vector else (1,)):
            for wave in WAVES:
                blocks = k1.qp2_grid(nv, unroll, wave)
                shares = k1.qp2_shares(nv, blocks)
                assert 1 <= blocks <= wave
                assert shares[0][0] == 0 and shares[-1][1] == nv
                assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
                sizes = [end - start for start, end in shares]
                assert max(sizes) - min(sizes) <= 1
                assert blocks == wave or \
                    max(sizes) <= k1.QP2_THREADS * unroll


@pytest.mark.parametrize("itemsize", [2, 4, 8])
@pytest.mark.parametrize("e", [1000, 131072])
@pytest.mark.parametrize("nq", [(n, n, n) for n in B05_ORDERS] + [(3, 4, 5)])
def test_qp2_deals_every_vector_once_in_one_wave(nq, e, itemsize):
    """K4 at every benchmark05 order: w (nm0, nq2*nq1, E)."""
    k4_deal_holds(nq[0] - 1, nq[1] * nq[2], e, itemsize)


def test_qp2_vector_form_needs_whole_aligned_vectors():
    assert build.vector16(64 * 131072, 4, 0, 256)
    assert not build.vector16(3 * 1001, 4, 0, 0)  # F not whole vectors
    assert not build.vector16(3 * 1002, 4, 0, 0)  # 3006 floats
    assert build.vector16(3 * 1002, 8, 0, 0)      # 3006 doubles
    assert not build.vector16(1024, 4, 4, 0)      # w off a boundary
    assert not build.vector16(1024, 8, 0, 8)      # out off a boundary
    assert k1.qp2_units(1024, 4, True) == 256
    assert k1.qp2_units(1024, 8, True) == 512
    assert k1.qp2_units(1001, 4, False) == 1001


def test_qp2_smem_pads_only_the_chunked_form():
    assert k1.qp2_smem(4, 7, 8) == 4 * 7 * 8
    assert k1.qp2_smem(8, 9, 10) == 8 * 9 * 10
    assert k1.qp2_smem(4, 15, 16) == 4 * 16 * 16
    assert k1.qp2_smem(8, 31, 32) == 8 * 32 * 32


@pytest.mark.parametrize("label,kwargs,nm0,error", [
    ("unroll 3", dict(unroll=3), 3, "unroll=3"),
    ("unroll 4 chunked", dict(unroll=4), 15, "at most 2"),
    ("out shape", dict(out=torch.zeros(4, 15, E)), 3, "is not"),
    ("out strided", dict(out=torch.zeros(4, 16, 2 * E)[:, :, ::2]), 3,
     "contiguous"),
    ("out dtype", dict(out=torch.zeros(5, 16, E, dtype=torch.float64)), 4,
     "one dtype")])
def test_qp_stage2_3d_rejects_bad_knobs(label, kwargs, nm0, error):
    w, b0 = torch.zeros(nm0, 16, E), torch.zeros(nm0, nm0 + 1)
    with pytest.raises((ValueError, TypeError), match=error):
        k1.qp_stage2_3d(w, b0, **kwargs)


def test_qp_stage2_3d_takes_any_nkj_and_writes_out():
    """kj no longer runs on the grid's y axis, so nkj above 65535 is taken;
    `out` receives the result."""
    rng = np.random.default_rng(9)
    w = torch.from_numpy(rng.standard_normal((2, 70000, 3)))
    b0 = torch.from_numpy(rng.standard_normal((2, 3)))
    out = torch.empty(3, 70000, 3, dtype=torch.float64)
    assert k1.qp_stage2_3d(w, b0, out=out) is out
    np.testing.assert_allclose(out.numpy(),
                               k1.qp_stage2_3d_plain(w, b0).numpy(),
                               rtol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [(n, n, n) for n in B05_ORDERS] + [(3, 4, 5)])
def test_qp_stage2_3d_every_b05_order_on_card(nq):
    """K4 at a benchmark05 order on E = 1000 and 131072, against its plain
    version; also on w and out one element off a 16-byte boundary, on F =
    3 x 1001 (not whole vectors) and on nkj = 70000, E = 8 (above the
    first design's grid limit); each at every unroll: 1e-5 (f32), 1e-12
    (f64), 2^-7 (bf16), relative to the largest output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(sum(nq) + 40)
    nm0, nq0, nkj = nq[0] - 1, nq[0], nq[1] * nq[2]
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12),
                       (torch.bfloat16, 2**-7)):
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device="cuda",
                               dtype=dtype)

        b0 = rnd(nm0, nq0)
        w = rnd(nm0 * nkj * 1000 + 1)[1:].view(nm0, nkj, 1000)
        operands = [(rnd(nm0, nkj, 1000), None),
                    (rnd(nm0, nkj, 131072), None),
                    (w, None), (rnd(nm0, 3, 1001), None),
                    (rnd(nm0, nkj, 1000), torch.empty(
                        nq0 * nkj * 1000 + 1, device="cuda",
                        dtype=dtype)[1:].view(nq0, nkj, 1000)),
                    (rnd(nm0, 70000, 8), None)]
        cases = [(w, out, u) for w, out in operands
                 for u in k1.qp2_unrolls(dtype.itemsize, nm0)]
        for w, out, unroll in cases:
            got = k1.qp_stage2_3d(w, b0, unroll=unroll, out=out)
            card_agree(got, k1.qp_stage2_3d_plain(w, b0), dtype, tol,
                       (tuple(w.shape), unroll))
