"""The yardstick of b05 (operations/b05.py) and each column path's layout
through the port's plain versions, on the CPU."""

import itertools
import math

import pytest
import torch

from port_bench import check, roofline, run, spec

CPU = torch.device("cpu")
OP = spec.load("operations", "b05")
PATHS = ("qp_shared", "kron_blocked")


def _config(nq=(8, 8, 8), nelmt=256, dtype="float32"):
    return {"operation": "b05", "nq": list(nq), "nelmt": nelmt,
            "dtype": dtype, "limits": {"max_err": 1e-5}}


def _cell(config, path):
    return spec.Cell(name="test", chips=1, config=config,
                     traffic={"path": path},
                     end_to_end=[], per_layer=[])


def test_least_flop_at_8_cubed_is_the_three_stage_sum_factorization():
    config = _config(nelmt=1)
    assert OP.least_flop(config) == 18928
    # one direction at a time: p, then q, then r
    assert 2 * (49 * 7 * 8 + 7 * 8 * 7 * 8 + 64 * 7 * 8) == 18928
    assert OP.least_flop(_config(nelmt=131072)) == 18928 * 131072


def test_least_flop_never_above_any_three_stage_order():
    for nq in [(3, 4, 5), (8, 8, 8), (2, 9, 4)]:
        nm = [n - 1 for n in nq]
        config = _config(nq, nelmt=10)
        for order in itertools.permutations(range(3)):
            extent, flop = list(nm), 0
            for d in order:
                rest = math.prod(extent[x] for x in range(3) if x != d)
                flop += 2 * rest * nm[d] * nq[d]
                extent[d] = nq[d]
            assert OP.least_flop(config) <= 10 * flop


def test_least_times():
    f32 = _config(nelmt=131072)
    f64 = _config(nelmt=1048576, dtype="float64")
    assert round(roofline.least_s(OP, f32) * 1e3, 4) == 0.1338
    assert round(roofline.least_s(OP, f64) * 1e3, 3) == 2.141
    # bytes bind: the FLOP at the peak take less time
    assert OP.least_flop(f32) / roofline.FLOP_PER_S["float32"] < (
        OP.least_bytes(f32) / roofline.HBM_BYTES_PER_S)
    assert OP.dof(f32) == 131072 * 343


def test_inputs_follow_the_seed_and_differ_by_element():
    config = _config((4, 5, 6), nelmt=64)
    a, b = OP.inputs(config, 2**40 + 3, CPU), OP.inputs(config, 2**40 + 3, CPU)
    c = OP.inputs(config, 2**40 + 4, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["coef"], c["coef"])
    assert a["coef"].shape == (64, 3 * 4 * 5)
    assert not torch.equal(a["coef"][0], a["coef"][1])
    assert a["b0"].shape == (3, 4) and a["b2"].shape == (5, 6)


def test_reference_is_the_tensor_product():
    config = _config((3, 4, 5), nelmt=7, dtype="float64")
    x = OP.inputs(config, 11, CPU)
    want = torch.einsum("erqp,pi,qj,rk->ekji",
                        x["coef"].reshape(7, 4, 3, 2), x["b0"], x["b1"],
                        x["b2"]).reshape(7, -1)
    got = OP.reference(config, x["coef"], x["b0"], x["b1"], x["b2"])
    assert got.dtype == torch.float64
    assert torch.allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-6), ("float64", 1e-14)])
@pytest.mark.parametrize("nq", [(3, 4, 5), (8, 8, 8)])
def test_path_layout_through_the_plain_version(path, dtype, tol, nq):
    config = _config(nq, nelmt=256, dtype=dtype)
    cell = _cell(config, path)
    fn, args = run.prepare(cell, 2**35 + 1, CPU)
    out = fn(*args)
    [err] = check.output_errors(OP, config, cell.path, 2**35 + 1, CPU, [out])
    assert err <= tol


@pytest.mark.parametrize("name", ["hex-nq8-f32", "hex-nq8-f64"])
def test_control_fails_the_limit_and_the_program_meets_it(name):
    conf = [c for c in spec.benchmark()["configs"] if c["name"] == name][0]
    config = dict(spec.read_json(spec.ROOT / conf["file"]), nelmt=512)
    limit = config["limits"]["max_err"]
    for seed in (1, 2**31 + 5, 2**33 + 7):
        assert check.control_error(OP, config, seed, CPU) > 3 * limit
    for path in PATHS:
        cell = _cell(config, path)
        fn, args = run.prepare(cell, 2**31 + 5, CPU)
        [err] = check.output_errors(OP, config, cell.path, 2**31 + 5, CPU,
                                    [fn(*args)])
        assert err < limit / 3
