"""The benchmark's b05 configuration at nq=8^3 in bfloat16 (port_bench's
hex-nq8-bf16, cell hex8-bf16-qp) on the CPU: the cell resolves, its path
runs at 8^3 in bf16 through the port's plain version and meets the plain
reference, its limit parts the program from a control one precision
below bf16, the yardstick's counts at the configuration, which form of K1
the cell runs, and that the run's held outputs fit the card."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench import check, roofline, run, spec, window  # noqa: E402
from tpu_bench_torch.kernels import bwdtrans3d as k1  # noqa: E402

CPU = torch.device("cpu")
CELL = "hex8-bf16-qp"
CONFIG = "hex-nq8-bf16"
OP = spec.load("operations", "b05")
# K1's shape at b05 8^3: (nm0, nrq, nq0, nkj); bfloat16 is 2 bytes a value
SHAPE = (7, 49, 8, 64)
# The card's device memory (NVIDIA H100 80GB HBM3)
CARD_BYTES = 80 * 10**9
K1_METRICS = {"qp_fused3d_roofline", "qp_ring_pct", "qp_dmma_pct",
              "qp_hmma_pct", "qp_wait_pct", "qp_stage1_pct",
              "qp_stage2_pct", "qp_slot_idle_pct", "qp_tf32_pct",
              "qp_s1_dmma_pct"}


def _config(**changes):
    return dict(spec.cell(CELL).config, **changes)


def _cell(config):
    return spec.Cell(name="test", chips=1, config=config,
                     traffic={"path": "qp_shared"}, end_to_end=[],
                     per_layer=[])


def _max_err(config, seed):
    cell = _cell(config)
    fn, args = run.prepare(cell, seed, CPU)
    out = fn(*args)
    assert out.dtype == torch.bfloat16
    [err] = check.output_errors(OP, config, cell.path, seed, CPU, [out])
    return err


def _e4m3(t):
    """t rounded to float8 e4m3 (3 explicit mantissa bits, the H100's
    next tensor-core type below bf16), held in float32."""
    return t.to(torch.float32).to(torch.float8_e4m3fn).to(torch.float32)


def _control_error(config, seed):
    """max_err of the reference with each stage's operands rounded to
    e4m3 and its sums in float32."""
    def rows(coef, inputs, e0, e1):
        return OP._stages(coef, inputs["b0"], inputs["b1"], inputs["b2"],
                          OP.orders(config), _e4m3)

    return check.errors(OP, config, seed, CPU, [rows])[0]


def test_cell_resolves_to_the_configuration():
    cell = spec.cell(CELL)
    assert cell.chips == 1
    assert cell.traffic == {"path": "qp_shared"}
    assert cell.config["operation"] == "b05"
    assert cell.config["nq"] == [8, 8, 8]
    assert cell.config["nelmt"] == 1048576
    assert cell.config["dtype"] == "bfloat16"
    assert cell.config["reduced"] == []
    assert cell.config["limits"]["max_err"] == 1.6e-2
    assert "343 modes and 512 points" in cell.config["assumed"]["element"]
    assert "f32" in cell.config["assumed"]["dtype"]
    per_layer = {m["name"] for m in cell.per_layer}
    assert K1_METRICS <= per_layer
    assert {"out_block_spread_pct", "call_us", "alloc_us", "launch_us",
            "device_allocs", "device_idle_pct", "enqueue_us",
            "library_s"} <= per_layer
    assert len(per_layer) == 18
    assert not {"kron_blocked_roofline", "kron_wgmma_pct",
                "kron_resident_pct"} & per_layer
    [conf] = [c for c in spec.benchmark()["configs"] if c["name"] == CONFIG]
    assert conf["source"] == cell.config["source"]
    assert len(conf["source"]) <= 200
    assert conf["reduced"] == cell.config["reduced"]


@pytest.mark.parametrize("nelmt", [512, 1000])
def test_path_at_8_cubed_in_bf16_through_the_plain_version(nelmt):
    """E = 1000: a last 64-element tile of 40."""
    config = _config(nelmt=nelmt)
    assert _max_err(config, 2**35 + 1) < config["limits"]["max_err"] / 3


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**33 + 7])
def test_control_fails_the_limit_and_the_program_meets_it(seed):
    config = _config(nelmt=512)
    limit = config["limits"]["max_err"]
    assert _control_error(config, seed) > 3 * limit
    assert _max_err(config, seed) < limit / 3


def test_yardstick_counts_at_the_configuration():
    config = _config()
    assert OP.dof(config) == 359_661_568
    # 2 bytes a value: 343 coefficients and 512 points an element, and the
    # three 7 x 8 bases
    assert OP.least_bytes(config) == 2 * (1048576 * 855 + 3 * 56) \
        == 1_793_065_296
    assert OP.least_flop(config) == 19_847_446_528
    # bound by bytes: 0.5352 ms at 3.35 TB/s against 0.020 ms of FLOP at
    # the bf16 tensor cores' 989 TFLOP/s
    least = roofline.least_s(OP, config)
    assert least == OP.least_bytes(config) / roofline.HBM_BYTES_PER_S
    assert least == pytest.approx(0.5352e-3, abs=1e-7)
    assert OP.least_flop(config) / roofline.FLOP_PER_S["bfloat16"] < \
        least / 25


def test_k1_runs_the_rules_depth_1_simt_form():
    """QP_MEASURED's bf16 entry at 8^3, the fastest of the sweep back to
    back at the cell's 1,048,576 elements: (64, 4) at depth 1, stage 2 on
    the bf16 tensor cores (HMMA), C12T held in registers; the rule, which
    takes HMMA where C12T fills an m16n8k16 tile, gives the same.  Three
    blocks an SM fit its shared memory (the SIMT form this entry replaced
    fit three too, at 75,376 B)."""
    cfg = k1.QPConfig(64, 4, 1, 256, "hmma", "regs")
    assert k1.QP_MEASURED[(2, *SHAPE)] == cfg == k1.qp_config(2, *SHAPE)
    assert k1.qp_config.__wrapped__(2, *SHAPE) == cfg
    assert k1.qp_hmma_takes(49, 64)
    smem = k1.qp_smem(2, 64, 4, *SHAPE, 1, "hmma", "regs")
    assert smem == 69_616
    assert 3 * (smem + k1.SMEM_RESERVED) <= k1.SMEM_SM
    assert k1.qp_smem(2, 64, 4, *SHAPE) == 75_376
    # the 128-element tile has no HMMA instance
    assert "hmma" not in k1.qp_built_bodies(2, 128)


def test_held_outputs_fit_the_card():
    """run.run_cell holds IN_FLIGHT + SAMPLES + 2 outputs at once beside
    the column's input, (nq0 * nkj, E) and (nm0 * nrq, E) in bf16: 12 of
    1.074 GB and 0.719 GB, 13.6 GB of the card's 80."""
    config = _config()
    nq0, nq1, nq2 = OP.orders(config)
    nelmt = config["nelmt"]
    out_bytes = 2 * nq0 * nq1 * nq2 * nelmt
    in_bytes = 2 * (nq0 - 1) * (nq1 - 1) * (nq2 - 1) * nelmt
    held = (window.IN_FLIGHT + run.SAMPLES + 2) * out_bytes + in_bytes
    assert window.IN_FLIGHT + run.SAMPLES + 2 == 12
    assert out_bytes == 1_073_741_824
    assert held == 13_604_225_024
    assert held <= CARD_BYTES
