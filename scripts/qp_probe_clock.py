"""K1's probe clock against the profiler's device records, in one qp cell
of the benchmark.

    PYTHONPATH=. python3 scripts/qp_probe_clock.py --workload hex8-f32-qp --seed 7

Sets the cell up as port_bench/run.py does (its seeded inputs, its column,
the same warm-up), then runs a profiled window as a traced run does
(PROFILER_WARM_SECONDS, then TRACE_SECONDS under the window's
annotation).  Every K1 launch of the process is then a probed one and has
both a CUPTI record and a probe span (kernels/bwdtrans3d.qp_phases: the
first block's %globaltimer at start to the last block's at exit), paired
in launch order.  Prints one JSON line: the launches, the median and
quartiles of the probe span's duration less CUPTI's (ns and as a share of
CUPTI's), the medians of both, the bound 2% + 2 us of the median CUPTI
duration, the least step between distinct %globaltimer stamps of the
newest launch's blocks (the timer's grain), the SM clock's rate over
its blocks with both stamps (cycles over ns), the blocks with a start
stamp and with both, and the four probe metrics of the run.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from port_bench import qp_probe, run, spec, trace, window
from tpu_bench_torch.kernels import bwdtrans3d as k1


def cupti_k1(prof) -> list:
    """(start_ns, end_ns) of every K1 device record, by start."""
    from torch.autograd import DeviceType

    return sorted((ev.start_ns(), ev.end_ns())
                  for ev in prof.profiler.kineto_results.events()
                  if ev.device_type() != DeviceType.CPU
                  and "qp_fused3d_kernel" in ev.name())


def grain_ns(blocks) -> int | None:
    """The least step between distinct %globaltimer stamps of `blocks`."""
    stamps = sorted({t for b in blocks for t in b[:2] if t})
    steps = [b - a for a, b in zip(stamps, stamps[1:])]
    return min(steps, default=None)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    args = parser.parse_args(argv)
    device = torch.device("cuda", 0)
    cell = spec.cell(args.workload)
    fn, fargs = run.prepare(cell, args.seed, device)
    held = [fn(*fargs) for _ in range(window.IN_FLIGHT + run.SAMPLES + 2)]
    window.synchronize(device)
    del held
    window.drive(fn, fargs, run.WARM_SECONDS, device, lambda out: None)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        window.drive(fn, fargs, run.PROFILER_WARM_SECONDS, device,
                     lambda out: None)
        with record_function(trace.WINDOW):
            window.drive(fn, fargs, run.TRACE_SECONDS, device,
                         lambda out: None)
    found = k1.qp_phases()
    records = cupti_k1(prof)
    spans_ns = found["spans"]
    n = min(len(records), len(spans_ns))
    pairs = list(zip(records[-n:], spans_ns[-n:]))
    diff = [(pe - ps) - (ce - cs) for (cs, ce), (ps, pe) in pairs]
    rel = [d / (ce - cs) for d, ((cs, ce), _) in zip(diff, pairs)]
    cupti = statistics.median(ce - cs for cs, ce in records[-n:])
    blocks = found["blocks"]
    both = [b for b in blocks if b[0] and b[1] > b[0]]
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(),
        "launches": found["launches"], "cupti_records": len(records),
        "paired": n,
        "diff_ns_quartiles": statistics.quantiles(diff, n=4),
        "diff_rel_quartiles": statistics.quantiles(rel, n=4),
        "median_abs_diff_ns": statistics.median(abs(d) for d in diff),
        "median_cupti_ns": cupti,
        "median_probe_ns": statistics.median(pe - ps for ps, pe in
                                             spans_ns[-n:]),
        "bound_ns": 0.02 * cupti + 2000,
        "globaltimer_grain_ns": grain_ns(blocks),
        "sm_ghz": sum(b[3] for b in both) / sum(b[1] - b[0] for b in both),
        "timed_blocks": [sum(1 for b in blocks if b[0]), len(both)],
        "grid": found["grid"], "slots": found["slots"],
        "qp_wait_pct": qp_probe.share("wait"),
        "qp_stage1_pct": qp_probe.share("stage1"),
        "qp_stage2_pct": qp_probe.share("stage2"),
        "qp_slot_idle_pct": qp_probe.slot_idle_pct(blocks, found["slots"]),
    }), flush=True)


if __name__ == "__main__":
    main()
