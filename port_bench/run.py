"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's inputs on the card from the seed (every element's
own coefficients and the bases B0, B1, B2), builds the derived operators
through the port's ops/bwdtrans.operators3d, lays the coefficients out in
the operands of the cell's column, resolves the column's callable by its
label through the port's benchmark05.variant_specs and warms it up.  The
window (window.py) then drives that callable for --seconds.  With
--trace 1 a second window of TRACE_SECONDS runs under torch.profiler, and
the line carries the per-layer metrics instead of the end-to-end ones.

Once the windows are closed and the program's operands freed, a sample of
their outputs, drawn from the seed, is held to the plain reference
(check.py).  The last line of standard output is one JSON object:
`attempted` counts the windows' calls, `failed` the sampled outputs that
miss the limit.  The numbers compared, each beside its limit, are the last
lines of standard error.  Without a CUDA device, or with fewer than the cell asks for, the
run prints no result and exits with 1.
"""

from __future__ import annotations

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

_TORCH = time.perf_counter()

from port_bench import check, spec, trace, window  # noqa: E402

# Outputs of the windows kept for the check, drawn from the seed.
SAMPLES = 2
# Host seconds of the warm-up calls (after IN_FLIGHT + SAMPLES + 2 held
# ones, so the allocator holds every output block the windows will need).
WARM_SECONDS = 0.3
# Host seconds of the traced window, and of the calls under the profiler
# before it.
TRACE_SECONDS = 2.0
PROFILER_WARM_SECONDS = 0.1


@dataclasses.dataclass
class Run:
    """What the metric readers (metrics/<name>.py) read of one run."""
    config: dict
    op: object
    calls: int
    window_s: float
    call_ms: list
    enqueue_ns: list
    setup_s: float
    library_s: float | None
    trace: trace.Trace | None = None
    traced_calls: int = 0


def _load_library(device):
    """(seconds to build or load the kernel library, its launch counter);
    (None, None) off the card."""
    if device.type != "cuda":
        return None, None
    from tpu_bench_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    return time.perf_counter() - t0, build.launches


def prepare(cell, seed: int, device) -> tuple:
    """(the column's callable, its operands) for `cell`: the seeded inputs
    on `device`, the program's operators, the coefficients laid out in the
    operands the column's spec names."""
    op, program, path = cell.op, cell.program, cell.path
    inputs = op.inputs(cell.config, seed, device)
    basis, ops = program.operators(cell.config, inputs)
    operands = path.layout(inputs.pop("coef"), basis, ops)
    fn, keys = program.column(path.LABEL, basis, op.dtype(cell.config),
                              device)
    return fn, tuple(operands[k] for k in keys)


def _traced(fn, args, device, keep):
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        # the profiler's own start (its first activity buffers) falls
        # before the annotated window, not in it
        window.drive(fn, args, PROFILER_WARM_SECONDS, device,
                     lambda out: None)
        with record_function(trace.WINDOW):
            traced = window.drive(fn, args, TRACE_SECONDS, device, keep)
    return trace.read(prof), traced.calls


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             started: float) -> dict:
    """One run of `cell` on `device`: the result line as a dict, its key
    `checks` last.  `started` is the host clock at the start of the run."""
    op, path, config = cell.op, cell.path, cell.config
    mark = time.perf_counter()
    # set-up's phases, printed on standard error
    phases = {"torch": _TORCH - started} if started < _TORCH else {}
    phases["imports"] = mark - max(started, _TORCH)

    def phase(name):
        nonlocal mark
        now = time.perf_counter()
        phases[name] = now - mark
        mark = now

    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    phase("cuda_init")
    library_s, launches = _load_library(device)
    phase("library")
    fn, args = prepare(cell, seed, device)
    window.synchronize(device)
    phase("inputs")
    held = [fn(*args) for _ in range(window.IN_FLIGHT + SAMPLES + 2)]
    window.synchronize(device)
    del held
    phase("output_blocks")
    window.drive(fn, args, WARM_SECONDS, device, lambda out: None)
    phase("warm")
    before = dict(launches or {})
    run = Run(config=config, op=op, calls=0, window_s=0.0, call_ms=[],
              enqueue_ns=[], setup_s=time.perf_counter() - started,
              library_s=library_s)
    print("setup " + " ".join(f"{k} {v:.4f}" for k, v in phases.items()),
          file=sys.stderr, flush=True)

    sample = window.Sample(SAMPLES, seed)
    measured = window.drive(fn, args, seconds, device, sample)
    run.calls, run.window_s = measured.calls, measured.seconds
    run.call_ms, run.enqueue_ns = measured.call_ms, measured.enqueue_ns
    if traced:
        run.trace, run.traced_calls = _traced(fn, args, device, sample)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if launches is not None:
        counted = {k: launches[k] - before.get(k, 0) for k in path.LAUNCHES}
        print(f"launches {counted} over {sample.seen} calls", flush=True)
    del fn, args
    if device.type == "cuda":
        torch.cuda.empty_cache()

    errs = check.output_errors(op, config, path, seed, device, sample.kept)
    limit = config["limits"]["max_err"]
    failed = sum(not e <= limit for e in errs)
    entries = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for entry in entries:
        value = spec.load("metrics", entry["name"]).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    result = {
        "correct": bool(errs) and failed == 0,
        "attempted": sample.seen,
        "failed": failed,
        "metrics": metrics,
        "device": _device(device, peak, run.trace),
    }
    if run.trace is not None:
        result["breakdown"] = {"device_ops": trace.device_ops(run.trace),
                               "idle_gaps": trace.idle_gaps(run.trace)}
    result["checks"] = {"max_err": {"value": max(errs, default=None),
                                    "limit": limit}}
    return result


def _device(device, peak: int, traced) -> dict:
    if device.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": 1, "memory_peak_bytes": peak}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": peak}
    if traced is not None:
        out["busy_s"] = trace.busy_s(traced)
        out["window_s"] = traced.window_s
    return out


def parse(argv=None):
    parser = argparse.ArgumentParser(prog="python3 -m port_bench.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if not torch.cuda.is_available():
        print("port_bench: no CUDA device; nothing is measured",
              file=sys.stderr)
        return 1
    cell = spec.cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {args.workload} needs {cell.chips} CUDA devices, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), _START)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
