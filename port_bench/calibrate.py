"""The readings a cell's limit is set from, at the cell's own size on the
card: `max_err` of the program over many seeds (each a short run of the
cell, its window and check as the benchmark runs them) and of the control
(the operation's reference in the precision below the configuration's, in
the program's place) over a few.  One JSON line a reading.

    python3 -m port_bench.calibrate --workload <cell> [<cell> ...]
        --seeds <n> [<n> ...] --control-seeds <n> [<n> ...] [--seconds 1]

The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from port_bench import check, run, spec


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m port_bench.calibrate")
    parser.add_argument("--workload", nargs="+", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=1.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_bench: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    for name in args.workload:
        cell = spec.cell(name)
        for seed in args.seeds:
            result = run.run_cell(cell, seed, args.seconds, False, device,
                                  time.perf_counter())
            print(json.dumps({"workload": name, "seed": seed,
                              "kind": "program",
                              "max_err": result["checks"]["max_err"]["value"],
                              "correct": result["correct"],
                              "metrics": result["metrics"]}), flush=True)
            torch.cuda.empty_cache()
        for seed in args.control_seeds:
            err = check.control_error(cell.op, cell.config, seed, device)
            print(json.dumps({"workload": name, "seed": seed,
                              "kind": "control", "max_err": err}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
