"""BENCHMARK.json and the files it names, resolved for one cell.

A cell names a configuration and a traffic mix; the configuration names
its operation, the traffic its column path.  Each is a file of its own
under port_bench/, loaded by that name, so a later cell, path or metric is
a new file and an entry in BENCHMARK.json.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load(folder: str, name: str):
    """The module port_bench/<folder>/<name>.py, loaded once by its path
    (a metric's name may hold '.' or '-')."""
    key = f"port_bench.{folder}.{name}"
    if key not in sys.modules:
        path = HERE / folder / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no {folder} named {name!r}: {path}")
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return sys.modules[key]


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    """One cell and what it names: its configuration and traffic (the JSON
    files as dicts), the modules of its operation, program binding and
    column path, and the BENCHMARK.json entries of the metrics it
    reports."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @property
    def op(self):
        return load("operations", self.config["operation"])

    @property
    def program(self):
        return load("programs", self.config["operation"])

    @property
    def path(self):
        return load("paths", self.traffic["path"])


def _named(entries: list, name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")
    return found[0]


def cell(name: str, bench: dict | None = None) -> Cell:
    """Cell `name` of BENCHMARK.json (or of `bench`).  It reports every
    end-to-end metric, and the per-layer metrics that list it or, without
    a `workloads` key, move one of those."""
    bench = bench if bench is not None else benchmark()
    work = _named(bench["workloads"], name, "workload")
    conf = _named(bench["configs"], work["config"], "config")
    e2e = bench["end_to_end"]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(name=name, chips=int(work["chips"]),
                config=read_json(ROOT / conf["file"]),
                traffic=read_json(HERE / "traffic" / f"{work['traffic']}.json"),
                end_to_end=e2e, per_layer=per_layer)
