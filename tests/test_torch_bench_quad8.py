"""The benchmark's b04 configuration at nq=8^2 in float32 (port_bench's
quad-nq8-f32, cells quad8-f32-qp and quad8-f32-kron) on the CPU: the cells
resolve, each path runs through the port's plain version and meets the
plain reference (the kron path across its chunks), its limit parts the
program from the control, the yardstick's counts at the configuration,
and which form of K1 and K2 the cells run."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench import check, run, spec  # noqa: E402
from tpu_bench_torch.benchmarks import benchmark04  # noqa: E402
from tpu_bench_torch.core.config import Config  # noqa: E402
from tpu_bench_torch.kernels import bwdtrans2d as k2  # noqa: E402
from tpu_bench_torch.kernels import bwdtrans3d as k1  # noqa: E402
from tpu_bench_torch.ops import bwdtrans  # noqa: E402

CPU = torch.device("cpu")
CONFIG = "quad-nq8-f32"
OP = spec.load("operations", "b04")
# cell: (traffic, the per-layer metrics that only it of the two reports)
CELLS = {
    "quad8-f32-qp": ("qp_shared2d", {"qp_fused3d_roofline", "qp_ring_pct"}),
    "quad8-f32-kron": ("kron_wide4", {"kron_blocked_roofline",
                                      "kron_resident_pct"}),
}
PATHS = [traffic for traffic, _ in CELLS.values()]


def _config(**changes):
    return dict(spec.cell("quad8-f32-qp").config, **changes)


def _cell(config, path):
    return spec.Cell(name="test", chips=1, config=config,
                     traffic={"path": path}, end_to_end=[], per_layer=[])


def _max_err(config, path, seed):
    cell = _cell(config, path)
    fn, args = run.prepare(cell, seed, CPU)
    [err] = check.output_errors(OP, config, cell.path, seed, CPU,
                                [fn(*args)])
    return err


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_resolves_to_the_configuration(name):
    traffic, own = CELLS[name]
    cell = spec.cell(name)
    assert cell.chips == 1
    assert cell.traffic == {"path": traffic}
    assert cell.config["operation"] == "b04"
    assert cell.config["nq"] == [8, 8]
    assert cell.config["nelmt"] == 1048576
    assert cell.config["dtype"] == "float32"
    assert cell.config["reduced"] == []
    assert "49 modes and 64 points" in cell.config["assumed"]["element"]
    per_layer = {m["name"] for m in cell.per_layer}
    others = set().union(*(o for n, (_, o) in CELLS.items() if n != name))
    assert own | {"out_block_spread_pct", "call_us", "launch_us"} <= per_layer
    assert not others & per_layer
    assert "kron_wgmma_pct" not in per_layer
    [conf] = [c for c in spec.benchmark()["configs"] if c["name"] == CONFIG]
    assert conf["source"] == cell.config["source"]
    assert conf["reduced"] == cell.config["reduced"]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-6), ("float64", 1e-14)])
def test_path_through_the_plain_version(path, dtype, tol):
    """float32: a few roundings of sums of 7 products (2^-23 each) apart
    from the float64 reference; float64: the same sums in double."""
    assert _max_err(_config(nelmt=256, dtype=dtype), path, 2**35 + 1) <= tol


@pytest.mark.parametrize("path", PATHS)
def test_layout_is_the_programs_own(path):
    """Where every element holds the same coefficients, the path lays them
    out as benchmark04.prepare does for its column."""
    nelmt = 1024
    cfg = Config(dtype=torch.float32, device=CPU)
    data = benchmark04.prepare(8, 8, nelmt, cfg)
    basis = data["basis"]
    elem = bwdtrans.element_data2d(basis, torch.float32)
    coef = elem.expand(nelmt, -1).contiguous()
    path = spec.load("paths", path)
    _, ops = spec.load("programs", "b04").operators(
        _config(nelmt=nelmt), {"b0": basis.b0, "b1": basis.b1})
    _, keys = spec.load("programs", "b04").column(path.LABEL, basis,
                                                  torch.float32, CPU)
    operands = path.layout(coef, basis, ops)
    for key in keys:
        assert torch.equal(operands[key], data[key]), key


@pytest.mark.parametrize("e0,e1", [(0, 16384), (8191, 8193), (3, 12289),
                                   (8192, 16384), (1, 8191)])
def test_kron_rows_across_chunks(e0, e1):
    """At 16,384 elements the kron path runs two chunks of 8192; rows()
    reads any span of elements, across the chunks' boundary and at odd
    ends, as the reference's rows."""
    config = _config(nelmt=16384)
    cell = _cell(config, "kron_wide4")
    seed = 2**41 + 17
    fn, args = run.prepare(cell, seed, CPU)
    out = fn(*args)
    assert out.shape == (2, 64, 64, 128)
    x = OP.inputs(config, seed, CPU)
    coef = x.pop("coef")
    want = OP.reference(config, coef[e0:e1], **x)
    got = cell.path.rows(out, OP.orders(config), e0, e1)
    assert got.shape == want.shape
    assert (got.double() - want).abs().max().item() <= 2e-6 * want.abs().max()


def test_control_fails_the_limit_and_the_program_meets_it():
    config = _config(nelmt=512)
    limit = config["limits"]["max_err"]
    for seed in (1, 2**31 + 5, 2**33 + 7):
        assert check.control_error(OP, config, seed, CPU) > 3 * limit
    for path in PATHS:
        assert _max_err(config, path, 2**31 + 5) < limit / 3


def test_yardstick_counts_at_the_configuration():
    config = _config()
    assert OP.dof(config) == 51_380_224
    assert OP.least_bytes(config) == 473_956_800
    # two stages, p or q first: 2 (7*7*8 + 8*7*8) = 1680 FLOP an element,
    # under the kron GEMM's 2 * 49 * 64 = 6272
    assert OP.least_flop(config) == 1680 * 1048576 == 1_761_607_680
    assert OP.least_flop(_config(nq=[3, 5], nelmt=1)) == min(
        2 * (4 * 2 * 3 + 3 * 4 * 5), 2 * (2 * 4 * 5 + 5 * 2 * 3),
        3 * 8 * 15)


def test_reference_is_the_single_kron_gemm():
    config = _config(nq=[3, 5], nelmt=7, dtype="float64")
    x = OP.inputs(config, 11, CPU)
    basis = bwdtrans.Basis2D(3, 5, x["b0"], x["b1"])
    c_em = bwdtrans.operators2d(basis)[0]
    got = OP.reference(config, x["coef"], x["b0"], x["b1"])
    assert got.dtype == torch.float64 and got.shape == (7, 15)
    assert torch.allclose(got, x["coef"] @ c_em, rtol=0, atol=1e-13)


def test_k1_runs_its_depth_1_form():
    """QP_MEASURED's setting for the 2D plane view at 8^2 in f32 (nm0 = 7,
    nrq = nm1 = 7, nq0 = 8, nkj = nq1 = 8): 128-element tiles, groups of
    4 planes, depth 1 (the slab ring is built for tiles of 32 and 16
    only)."""
    assert k1.qp_config(4, 7, 7, 8, 8) == k1.QPConfig(128, 4, 1, 256)
    assert 128 not in k1.QP_RING_TILES


def test_k2_holds_c_resident():
    """kron_config for b04 8^2's C (64 points x 49 modes) in f32: strips
    of 64, not the dense configuration."""
    assert k2.kron_config(4, 64, 49) == 64
    assert k2.kron_resident_smem(4, 64, 49, 64) <= k2.SMEM_BLOCK
