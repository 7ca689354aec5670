"""Shared CLI of the benchmarks (port of tpu_bench/benchmarks/cli.py).

The reference takes positional argv only (b05: `nq0 nq1 nq2 threads
elblocks`) with hard-coded sweep bounds.  The positional contract stays,
with flags for dtype, repetitions, sweep bounds, the elements-per-block
knob and the device.  The JAX package's chained timing (`--timing`),
`--vmem-resident` and `--autotune` are TPU or relay workarounds and are not
ported; `--l2-resident` is the card's analog of `--vmem-resident`.
"""

from __future__ import annotations

import argparse
import contextlib
import os


def build_parser(name: str, positionals=(),
                 f64_coales: bool = False) -> argparse.ArgumentParser:
    """The shared flags; `f64_coales` adds --f64-coales (benchmarks 04
    and 05)."""
    p = argparse.ArgumentParser(prog=name)
    for pos, default in positionals:
        p.add_argument(pos, nargs="?", type=int, default=default)
    p.add_argument("--dtype", choices=["f32", "f64", "bf16"], default="f32",
                   help="element type (the reference uses f64; bf16 runs "
                        "benchmarks 04 and 05, and 01-03 refuse it)")
    p.add_argument("--ntests", type=int, default=40,
                   help="repetitions per variant; min is kept (reference: 40)")
    p.add_argument("--epb", type=int, default=None,
                   help="elements per block of the fused QP kernel "
                        "(threads*elblocks analog)")
    p.add_argument("--precision", choices=["default", "highest"],
                   default="highest",
                   help="library-tier float32 matmuls: highest = full FP32, "
                        "default = TF32 allowed")
    p.add_argument("--min-size", type=int, default=None,
                   help="override sweep lower bound")
    p.add_argument("--max-size", type=int, default=None,
                   help="override sweep upper bound (inclusive)")
    p.add_argument("--step", type=int, default=2,
                   help="geometric sweep factor (reference: x2)")
    p.add_argument("--no-validate", action="store_true",
                   help="skip cross-variant norm agreement checks")
    p.add_argument("--l2-resident", action="store_true",
                   help="do not flush the L2 cache between repetitions "
                        "(small sizes then report L2 bandwidth)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler Chrome trace of the sweep "
                        "to DIR/trace.json, with the launch path's tbt.* "
                        "spans (core/spans.py)")
    if f64_coales:
        p.add_argument("--f64-coales", choices=["native", "ozaki"],
                       default="native",
                       help="route of the f64 Pallas(Coales) column: native "
                            "= the kron GEMM built in double; ozaki = the "
                            "JAX package's exact bf16 slice GEMM (needs "
                            "--dtype f64)")
    return p


def stream_config(args, name: str):
    """Config.from_flags for benchmarks 01-03, which refuse bf16: their
    kernels (K6-K9) are built in f32 and f64 only."""
    from tpu_bench_torch.core.config import Config

    cfg = Config.from_flags(args)
    if cfg.dtype.itemsize == 2:
        raise NotImplementedError(f"{name}: bf16 is not ported yet for "
                                  "benchmarks 01-03 (ROADMAP Queue 1 item "
                                  "2c)")
    return cfg


@contextlib.contextmanager
def profiled(args):
    """Trace the sweep with torch.profiler when --profile DIR was given."""
    if not getattr(args, "profile", None):
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if str(args.device).startswith("cuda"):
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(args.profile, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))


def sweep(default_min: int, default_max: int, args):
    """Geometric sweep like the reference mains (benchmark01.cc:343)."""
    lo = args.min_size or default_min
    hi = args.max_size or default_max
    step = max(2, getattr(args, "step", 2))
    size = lo
    while size <= hi:
        yield size
        size *= step


def guarded(reporter, name, size, run, *args, **kwargs):
    """Run one sweep point; a failure skips the row with a stderr note and
    the sweep continues, so partial logs stay usable."""
    try:
        run(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 - deliberate per-row isolation
        reporter.note(f"{name}: size {size} failed: {type(e).__name__}: {e}")
