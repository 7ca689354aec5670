"""The benchmark's b05 configuration at nq=10^3 in float64 (port_bench's
hex-nq10-f64, cell hex10-f64-qp) on the CPU: the cell resolves, its path
runs at 10^3 through the port's plain version and meets the plain
reference, its limit parts the program from the control, the yardstick's
counts at the configuration, and why K1 runs its depth-1 form there."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench import check, run, spec  # noqa: E402
from tpu_bench_torch.kernels import bwdtrans3d as k1  # noqa: E402

CPU = torch.device("cpu")
CELL = "hex10-f64-qp"
OP = spec.load("operations", "b05")
# K1's shape at b05 10^3: (nm0, nrq, nq0, nkj); float64 is 8 bytes a value
SHAPE = (9, 81, 10, 100)


def _config(**changes):
    return dict(spec.cell(CELL).config, **changes)


def _cell(config):
    return spec.Cell(name="test", chips=1, config=config,
                     traffic={"path": "qp_shared"}, end_to_end=[],
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
    assert cell.traffic == {"path": "qp_shared"}
    assert cell.config["operation"] == "b05"
    assert cell.config["nq"] == [10, 10, 10]
    assert cell.config["nelmt"] == 524288
    assert cell.config["dtype"] == "float64"
    assert cell.config["reduced"] == ["nelmt"]
    assert "1048576" in cell.config["assumed"]["nelmt"]
    assert "729 modes and 1000 points" in cell.config["assumed"]["element"]
    per_layer = {m["name"] for m in cell.per_layer}
    assert {"qp_fused3d_roofline", "qp_ring_pct",
            "out_block_spread_pct"} <= per_layer
    assert "kron_blocked_roofline" not in per_layer
    [conf] = [c for c in spec.benchmark()["configs"]
              if c["name"] == "hex-nq10-f64"]
    assert conf["source"] == cell.config["source"]
    assert conf["reduced"] == cell.config["reduced"]


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-14), ("float32", 2e-6)])
def test_path_at_10_cubed_through_the_plain_version(dtype, tol):
    assert _max_err(_config(nelmt=256, dtype=dtype), 2**35 + 1) <= tol


def test_control_fails_the_limit_and_the_program_meets_it():
    config = _config(nelmt=512)
    limit = config["limits"]["max_err"]
    for seed in (1, 2**31 + 5, 2**33 + 7):
        assert check.control_error(OP, config, seed, CPU) > 3 * limit
    assert _max_err(config, 2**31 + 5) < limit / 3


def test_k1_takes_its_depth_1_form_alone_on_an_sm():
    """No depth-2 form fits a block's shared memory at any ring tile, so
    qp_config keeps the sweep's (16, 4) at depth 1, whose buffers leave
    room for one block an SM."""
    assert k1.qp_config(8, *SHAPE) == k1.QPConfig(16, 4, 1, 256)
    for et in k1.QP_RING_TILES:
        for g in k1.QP_PLANE_GROUPS:
            assert k1.qp_smem(8, et, g, *SHAPE, 2) > k1.SMEM_BLOCK
    assert k1.qp_smem(8, 16, 4, *SHAPE, 2) == 296368
    alone = k1.qp_smem(8, 16, 4, *SHAPE)
    assert alone == 203040 <= k1.SMEM_BLOCK
    assert 2 * (alone + k1.SMEM_RESERVED) > k1.SMEM_SM


def test_yardstick_counts_at_the_configuration():
    config = _config()
    assert OP.least_bytes(config) == 7_251_953_776
    assert OP.least_flop(config) == 25_574_768_640
    assert OP.dof(config) == 382_205_952
