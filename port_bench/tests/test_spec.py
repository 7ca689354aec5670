"""BENCHMARK.json against the contract's limits, and every file it names
found by name."""

import json
import re

import pytest

from port_bench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(word) for word in BENCH["command"])


def test_names_units_and_lines():
    names = [e["name"] for e in BENCH["configs"] + BENCH["workloads"]
             + METRICS]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.fullmatch(name), name
    for w in BENCH["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    for c in BENCH["configs"]:
        assert _line(c["why"]) and _line(c["source"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
    for m in METRICS:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        # every cell reports every end-to-end metric (spec.cell)
        assert set(m) == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = spec.cell(name)
    for module in (cell.op, cell.program, cell.path):
        assert module is not None
    assert hasattr(cell.path, "LABEL") and cell.path.LAUNCHES
    assert cell.config["limits"]["max_err"] > 0
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.load("metrics", m["name"]).read)


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    assert conf["file"].startswith("port_bench/configs/")
    data = json.loads((spec.ROOT / conf["file"]).read_text())
    assert data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"]
    assert set(conf["reduced"]) <= set(data)


def test_files_named_from_name_characters():
    for path in spec.HERE.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(spec.ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
        assert len(rel) <= 200


def test_no_file_of_the_repo_outside_paths_in_command():
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
