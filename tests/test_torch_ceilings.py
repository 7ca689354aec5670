"""The port's ceilings (core/roofline.py, benchmarks/ceilings.py) against the
JAX package's, on the CPU; the ceilings CLI's log format against the JAX
CLI's committed log; and the committed H100 ceilings log.

Every roofline function and derived_table is pure Python arithmetic in the
same order on both sides, so they must agree exactly."""

import contextlib
import io
import json
import math
import os

import pytest

from tpu_bench.benchmarks import ceilings as jax_ceilings
from tpu_bench.core import roofline as jax_roofline
from tpu_bench_torch.benchmarks import ceilings
from tpu_bench_torch.core import roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LOG = os.path.join(REPO, "artifacts", "ceilings", "ceilings.log")
H100_LOG = os.path.join(REPO, "artifacts", "h100", "ceilings", "ceilings.log")
HBM_GBS = 3350.0  # the H100 SXM's published device-memory rate
EXPAND = ("expand2", "expand4", "expand8")
# measured-rate sets: every probe; no expand probes (the ladder then
# interpolates from copy to write); the two directions alone; writes
# faster than reads
FULL = {"read_dma": 2990.5, "read_auto": 3080.25, "read": 3080.25,
        "write_dma": 2950.0, "write_auto": 2875.5, "write": 2950.0,
        "copy_2x": 2901.0, "scale_2x": 2890.75, "add_3x": 3010.5,
        "triad_3x": 3005.0, "expand2": 2920.0, "expand4": 2935.25,
        "expand8": 2940.5}
BWS = {
    "full": FULL,
    "no_expand": {k: v for k, v in FULL.items() if k not in EXPAND},
    "directions": {"read": 753.8, "write": 654.9},
    "write_faster": {"read": 1000.0, "write": 1200.0, "add_3x": 1050.0,
                     "copy_2x": 1100.0},
}
RATES = [(3080.25, 2950.0), (753.8, 654.9), (1000.0, 1200.0)]
MIXES = [(1, 0), (0, 1), (0, 0), (2, 1), (1, 1), (1, 2), (27, 64), (1, 8),
         (49, 64), (343, 512), (961, 1024)]
ORDERS = [(nq, dim) for dim in (2, 3) for nq in (2, 3, 4, 6, 8, 10, 16, 32)]


def _json_line(path):
    with open(path) as f:
        lines = [line for line in f if line.startswith("{")]
    assert lines, f"{path} has no JSON line"
    return json.loads(lines[-1])


@pytest.mark.parametrize("duplex", [False, True])
def test_mixed_bandwidth_matches_jax(duplex):
    for r, w in RATES:
        for rb, wb in MIXES:
            assert (roofline.mixed_bandwidth(r, w, rb, wb, duplex)
                    == jax_roofline.mixed_bandwidth(r, w, rb, wb, duplex))
        assert (roofline.stream_add_ceiling(r, w, duplex)
                == jax_roofline.stream_add_ceiling(r, w, duplex))
        assert (roofline.matvec_ceiling_gbs(r)
                == jax_roofline.matvec_ceiling_gbs(r))


@pytest.mark.parametrize("itemsize", [2, 4, 8])
@pytest.mark.parametrize("duplex", [False, True])
def test_bwdtrans_ceiling_matches_jax(duplex, itemsize):
    for r, w in RATES:
        for nq, dim in ORDERS:
            assert (roofline.bwdtrans_ceiling_gdofs(r, w, nq, dim, itemsize,
                                                    duplex)
                    == jax_roofline.bwdtrans_ceiling_gdofs(
                        r, w, nq, dim, itemsize, duplex))


def test_probe_ladder_matches_jax():
    assert roofline.PROBE_LADDER == jax_roofline.PROBE_LADDER


@pytest.mark.parametrize("name", sorted(BWS))
def test_empirical_and_honesty_caps_match_jax(name):
    bw = BWS[name]
    for rb, wb in MIXES:
        for fn in ("empirical_mix_bandwidth", "honesty_cap_mix"):
            assert (getattr(roofline, fn)(bw, rb, wb)
                    == getattr(jax_roofline, fn)(bw, rb, wb)), (fn, rb, wb)
    for nq, dim in ORDERS:
        for itemsize in (4, 8):
            for fn in ("empirical_bwdtrans_gdofs", "honesty_cap_bwdtrans"):
                assert (getattr(roofline, fn)(bw, nq, dim, itemsize)
                        == getattr(jax_roofline, fn)(bw, nq, dim, itemsize))


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("name", sorted(BWS))
def test_derived_table_matches_jax(name, itemsize):
    ours = ceilings.derived_table(BWS[name], itemsize)
    theirs = jax_ceilings.derived_table(BWS[name], itemsize)
    assert len(ours) == len(theirs) == 17
    for a, b in zip(ours, theirs):
        assert a == b


def test_measure_directions_on_cpu():
    """The 13 probes in the JAX package's order, each a finite positive
    rate, read and write the larger of their two probes."""
    bw = ceilings.measure_directions(128 * 64, n_tests=1, device="cpu")
    assert list(bw) == list(_json_line(JAX_LOG))[2:]
    assert all(math.isfinite(v) and v > 0 for v in bw.values()), bw
    assert bw["read"] == max(bw["read_dma"], bw["read_auto"])
    assert bw["write"] == max(bw["write_dma"], bw["write_auto"])


def _lines(path):
    with open(path) as f:
        return [line.rstrip("\n") for line in f]


def _measured(lines):
    out = {}
    for line in lines:
        if line.startswith("Measured "):
            key, value = line[len("Measured "):].split(" GB/s: ")
            out[key] = float(value)
    return out


def _ceiling_rows(lines):
    rows = []
    for line in lines:
        if line.startswith("Ceiling "):
            name_unit, values = line[len("Ceiling "):].split("): ")
            name, unit = name_unit.rsplit(" (", 1)
            shared, emp = (float(v) for v in values.split(" | "))
            rows.append((name, shared, emp, unit))
    return rows


def test_cli_on_cpu_matches_jax_log_format():
    """`--device cpu --size 131072 --ntests 2`: the JAX CLI's header,
    Measured lines in its key order, its 17 Ceiling rows (derived from the
    Measured lines) and its JSON keys."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ceilings.main(["--device", "cpu", "--size", "131072", "--ntests",
                       "2"])
    ours = buf.getvalue().splitlines()
    theirs = _lines(JAX_LOG)
    start = theirs.index("-" * 32)
    assert ours[:3] == theirs[start:start + 3]
    assert ours[3].startswith("device: cpu; buffer 0 MiB f32; ")
    measured = _measured(ours)
    assert list(measured) == list(_measured(theirs))
    rows = _ceiling_rows(ours)
    assert [r[0] for r in rows] == [r[0] for r in _ceiling_rows(theirs)]
    for got, want in zip(rows, ceilings.derived_table(measured)):
        assert got[0] == want[0] and got[3] == want[3]
        assert got[1] == pytest.approx(want[1], rel=1e-9)
        assert got[2] == pytest.approx(want[2], rel=1e-9)
    summary = json.loads(ours[-1])
    assert list(summary) == list(_json_line(JAX_LOG))
    assert summary["device"] == "cpu" and summary["f32_elems"] == 131072
    for key, value in measured.items():
        assert summary[key] == round(value, 1)


def test_committed_h100_ceilings():
    """artifacts/h100/ceilings/ceilings.log: one run of the port's CLI on
    the card, its provenance (commit, card name and power limit) first.
    Every rate, counted as its probe counts bytes, is positive and within
    5% of the H100's published 3.35 TB/s; the Ceiling rows are
    derived_table of the Measured lines."""
    lines = _lines(H100_LOG)
    assert lines[0].startswith("# provenance:")
    assert "NVIDIA" in lines[0] and " W" in lines[0]
    summary = _json_line(H100_LOG)
    assert list(summary) == list(_json_line(JAX_LOG))
    assert summary["device"].startswith("NVIDIA")
    assert summary["f32_elems"] == 128 * 2**20
    measured = _measured(lines)
    assert list(measured) == list(summary)[2:]
    for key, value in measured.items():
        assert 0 < value <= HBM_GBS * 1.05, (key, value)
        assert summary[key] == round(value, 1)
    assert measured["read"] == max(measured["read_dma"],
                                   measured["read_auto"])
    assert measured["write"] == max(measured["write_dma"],
                                    measured["write_auto"])
    rows = _ceiling_rows(lines)
    want = ceilings.derived_table(measured)
    assert len(rows) == len(want) == 17
    for got, exp in zip(rows, want):
        assert got[0] == exp[0] and got[3] == exp[3]
        assert got[1] == pytest.approx(exp[1], rel=1e-9)
        assert got[2] == pytest.approx(exp[2], rel=1e-9)
