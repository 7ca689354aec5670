"""The benchmark's b04 configuration at nq=8^2 in bfloat16 (port_bench's
quad-nq8-bf16, cell quad8-bf16-qp) on the CPU: the cell resolves, its path
runs at 8^2 in bf16 through the port's plain version and meets the plain
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
CELL = "quad8-bf16-qp"
CONFIG = "quad-nq8-bf16"
OP = spec.load("operations", "b04")
# K1's shape on the plane view at b04 8^2: (nm0, nrq, nq0, nkj) with
# nrq = nm1 and nkj = nq1; bfloat16 is 2 bytes a value
SHAPE = (7, 7, 8, 8)
# The card's device memory (NVIDIA H100 80GB HBM3)
CARD_BYTES = 80 * 10**9
K1_METRICS = {"qp_fused3d_roofline", "qp_ring_pct", "qp_dmma_pct",
              "qp_wait_pct", "qp_stage1_pct", "qp_stage2_pct",
              "qp_slot_idle_pct", "qp_tf32_pct", "qp_s1_dmma_pct"}


def _config(**changes):
    return dict(spec.cell(CELL).config, **changes)


def _cell(config):
    return spec.Cell(name="test", chips=1, config=config,
                     traffic={"path": "qp_shared2d"}, end_to_end=[],
                     per_layer=[])


def _max_err(config, seed):
    cell = _cell(config)
    fn, args = run.prepare(cell, seed, CPU)
    out = fn(*args)
    assert out.dtype == torch.bfloat16
    assert out.shape == (8, 8, config["nelmt"])
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
        return OP._stages(coef, inputs["b0"], inputs["b1"],
                          OP.orders(config), _e4m3)

    return check.errors(OP, config, seed, CPU, [rows])[0]


def test_cell_resolves_to_the_configuration():
    cell = spec.cell(CELL)
    assert cell.chips == 1
    assert cell.traffic == {"path": "qp_shared2d"}
    assert cell.config["operation"] == "b04"
    assert cell.config["nq"] == [8, 8]
    assert cell.config["nelmt"] == 1048576
    assert cell.config["dtype"] == "bfloat16"
    assert cell.config["reduced"] == []
    assert cell.config["limits"]["max_err"] == 1.6e-2
    assert "49 modes and 64 points" in cell.config["assumed"]["element"]
    assert "f32" in cell.config["assumed"]["dtype"]
    per_layer = {m["name"] for m in cell.per_layer}
    assert K1_METRICS <= per_layer
    assert {"out_block_spread_pct", "call_us", "alloc_us", "launch_us",
            "device_allocs", "device_idle_pct", "enqueue_us",
            "library_s"} <= per_layer
    assert len(per_layer) == 17
    assert not {"qp_hmma_pct", "kron_blocked_roofline", "kron_wgmma_pct",
                "kron_resident_pct"} & per_layer
    [conf] = [c for c in spec.benchmark()["configs"] if c["name"] == CONFIG]
    assert conf["source"] == cell.config["source"]
    assert len(conf["source"]) <= 200
    assert conf["reduced"] == cell.config["reduced"]


@pytest.mark.parametrize("nelmt", [512, 1000])
def test_path_at_8_squared_in_bf16_through_the_plain_version(nelmt):
    """E = 1000: a last 128-element tile of 104."""
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
    assert OP.dof(config) == 51_380_224
    # 2 bytes a value: 49 coefficients and 64 points an element, and the
    # two 7 x 8 bases
    assert OP.least_bytes(config) == 2 * (1048576 * 113 + 2 * 56) \
        == 236_978_400
    assert OP.least_flop(config) == 1_761_607_680
    # bound by bytes: 0.07074 ms at 3.35 TB/s against 1.8 us of FLOP at
    # the bf16 tensor cores' 989 TFLOP/s
    least = roofline.least_s(OP, config)
    assert least == OP.least_bytes(config) / roofline.HBM_BYTES_PER_S
    assert least == pytest.approx(0.07074e-3, abs=1e-8)
    assert OP.least_flop(config) / roofline.FLOP_PER_S["bfloat16"] < \
        least / 25


def test_k1_runs_the_rules_simt_form():
    """No QP_MEASURED entry at the bf16 plane view of 8^2, so the rule
    decides: C12T (nkj x nrq = 8 x 7) fills no m16n8k16 tile, so stage 2
    stays on the SIMT body with C12T staged, at 128-element tiles in
    groups of 8 planes at depth 1 (the f32 cell runs groups of 4)."""
    cfg = k1.QPConfig(128, 8, 1, 256, "simt", "smem")
    assert (2, *SHAPE) not in k1.QP_MEASURED
    assert k1.qp_config(2, *SHAPE) == cfg
    nrq, nkj = SHAPE[1], SHAPE[3]
    assert nkj < k1.QP_MMA_M and nrq < k1.QP_HMMA_K
    assert k1.qp_config(4, *SHAPE).planes == 4
    assert 128 not in k1.QP_RING_TILES


def test_held_outputs_fit_the_card():
    """run.run_cell holds IN_FLIGHT + SAMPLES + 2 outputs at once beside
    the column's input, (nq0, nq1, E) and (nm0, nm1, E) in bf16: 12 of
    134.2 MB and 102.8 MB, 1.71 GB of the card's 80."""
    config = _config()
    nq0, nq1 = OP.orders(config)
    nelmt = config["nelmt"]
    out_bytes = 2 * nq0 * nq1 * nelmt
    in_bytes = 2 * (nq0 - 1) * (nq1 - 1) * nelmt
    held = (window.IN_FLIGHT + run.SAMPLES + 2) * out_bytes + in_bytes
    assert window.IN_FLIGHT + run.SAMPLES + 2 == 12
    assert out_bytes == 134_217_728
    assert held == 1_713_373_184
    assert held <= CARD_BYTES
