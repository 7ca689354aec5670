"""The benchmark's b04 configuration at nq=32^2 in float64 (port_bench's
quad-nq32-f64, cell quad32-f64-qp) on the CPU: the cell resolves, its path
runs at 32^2 through the port's plain version and meets the plain
reference, its limit parts the program from the control, the yardstick's
counts at the configuration, which form of K1 the cell runs, and why
nelmt is cut from the top of the upstream sweep."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench import check, roofline, run, spec, window  # noqa: E402
from tpu_bench_torch.kernels import bwdtrans3d as k1  # noqa: E402

CPU = torch.device("cpu")
CELL = "quad32-f64-qp"
CONFIG = "quad-nq32-f64"
OP = spec.load("operations", "b04")
# K1's shape on the 2D plane view at 32^2: (nm0, nrq = nm1, nq0, nkj = nq1);
# float64 is 8 bytes a value
SHAPE = (31, 31, 32, 32)
# The card's device memory (NVIDIA H100 80GB HBM3)
CARD_BYTES = 80 * 10**9


def _config(**changes):
    return dict(spec.cell(CELL).config, **changes)


def _cell(config):
    return spec.Cell(name="test", chips=1, config=config,
                     traffic={"path": "qp_shared2d"}, end_to_end=[],
                     per_layer=[])


def _max_err(config, seed):
    cell = _cell(config)
    fn, args = run.prepare(cell, seed, CPU)
    [err] = check.output_errors(OP, config, cell.path, seed, CPU,
                                [fn(*args)])
    return err


def test_cell_resolves_to_the_configuration():
    cell = spec.cell(CELL)
    assert cell.chips == 1
    assert cell.traffic == {"path": "qp_shared2d"}
    assert cell.config["operation"] == "b04"
    assert cell.config["nq"] == [32, 32]
    assert cell.config["nelmt"] == 524288
    assert cell.config["dtype"] == "float64"
    assert cell.config["reduced"] == ["nelmt"]
    assert cell.config["limits"]["max_err"] == 1e-10
    assert "1048576" in cell.config["assumed"]["nelmt"]
    assert "961 modes and 1024 points" in cell.config["assumed"]["element"]
    per_layer = {m["name"] for m in cell.per_layer}
    assert {"qp_fused3d_roofline", "qp_ring_pct", "qp_dmma_pct",
            "out_block_spread_pct", "call_us", "alloc_us", "launch_us",
            "device_allocs", "device_idle_pct"} <= per_layer
    assert not {"kron_blocked_roofline", "kron_wgmma_pct",
                "kron_resident_pct"} & per_layer
    [conf] = [c for c in spec.benchmark()["configs"] if c["name"] == CONFIG]
    assert conf["source"] == cell.config["source"]
    assert conf["reduced"] == cell.config["reduced"]


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-14), ("float32", 2e-6)])
def test_path_at_32_squared_through_the_plain_version(dtype, tol):
    """E = 1000: a last 16-element tile of 8.  float32: a few roundings of
    sums of 31 products apart from the float64 reference."""
    assert _max_err(_config(nelmt=1000, dtype=dtype), 2**35 + 1) <= tol


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**33 + 7])
def test_control_fails_the_limit_and_the_program_meets_it(seed):
    config = _config(nelmt=256)
    limit = config["limits"]["max_err"]
    assert check.control_error(OP, config, seed, CPU) > 3 * limit
    assert _max_err(config, seed) < limit / 3


def test_yardstick_counts_at_the_configuration():
    config = _config()
    assert OP.dof(config) == 503_840_768
    assert OP.least_bytes(config) == 8_325_709_312
    # two stages, p or q first: 2 (31*31*32 + 32*31*32) = 124,992 FLOP an
    # element, under the kron GEMM's 2 * 961 * 1024 = 1,968,128
    assert OP.least_flop(config) == 124_992 * 524288 == 65_531_805_696
    assert 124_992 < 2 * 961 * 1024 == 1_968_128
    # bound by bytes: 2.4853 ms at 3.35 TB/s against 0.98 ms of FLOP
    least = roofline.least_s(OP, config)
    assert least == OP.least_bytes(config) / roofline.HBM_BYTES_PER_S
    assert least == pytest.approx(2.4853e-3, abs=1e-7)


def test_k1_runs_dmma_at_depth_1_alone_on_an_sm():
    """QP_MEASURED's setting for the 2D plane view at 32^2 in f64: tiles of
    16, groups of 8 planes, depth 1, stage 2 on DMMA (C12T's 31 rq columns
    padded to 32, rows of qp_lda(31) = 40 values).  Its buffers fit one
    block, but not two an SM."""
    assert k1.qp_config(8, *SHAPE) == k1.QPConfig(16, 8, 1, 256, "dmma")
    assert k1.QP_MEASURED[(8, *SHAPE)] == k1.qp_config(8, *SHAPE)
    assert k1.qp_lda(31) == 40
    smem = k1.qp_smem(8, 16, 8, *SHAPE, 1, "dmma")
    assert smem == 178_048 <= k1.SMEM_BLOCK
    assert 2 * (smem + k1.SMEM_RESERVED) > k1.SMEM_SM
    # no two slabs of a ring tile fit at 32^2 in f64
    for g in k1.QP_PLANE_GROUPS:
        for body in k1.QP_BODIES:
            assert k1.qp_smem(8, 16, g, *SHAPE, 2, body) > k1.SMEM_BLOCK


@pytest.mark.parametrize("nelmt,fits", [(1048576, False), (524288, True)])
def test_held_outputs_fit_the_card_only_at_the_cut(nelmt, fits):
    """run.run_cell holds IN_FLIGHT + SAMPLES + 2 outputs at once beside
    the column's input, (nm0, nm1, E) in float64: at the top of the
    upstream sweep they would need 111 GB, at its next point 55.6 GB."""
    config = _config(nelmt=nelmt)
    nq0, nq1 = OP.orders(config)
    out_bytes = 8 * nq0 * nq1 * nelmt
    in_bytes = 8 * (nq0 - 1) * (nq1 - 1) * nelmt
    held = (window.IN_FLIGHT + run.SAMPLES + 2) * out_bytes + in_bytes
    assert (held <= CARD_BYTES) == fits
