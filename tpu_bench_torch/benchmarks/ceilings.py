"""Bandwidth ceilings of the card: the measured denominators for every
"percent of roofline" claim (port of tpu_bench/benchmarks/ceilings.py).

The reference's implicit baseline is the STREAM number of its GPU (b02's
2R+1W metric, benchmark02/benchmark02.cc:255-259).  This benchmark
measures each direction of device memory and the canonical STREAM mixes
on the live card, at a working set ten times the H100's 50 MB L2:

    read    1R      read_manual (K10), sumsq_wide (K6 one-pass); max wins
    write   1W      fill_manual (K11 16-byte), fill (K11 scalar); max wins
    copy    1R+1W   out = x     (K12, into a second buffer)
    scale   1R+1W   x *= c      (K12, in place)
    add     2R+1W   x += y      (K7 16-byte form, b02's op)
    triad   2R+1W   x += c*y    (K12, in place)
    expandM 1R:MW   M interleaved copies of x (K13), M = 2, 4, 8

Each rate counts the bytes its probe must move over the time of one call
sustained in a run of n_tests back-to-back calls, timed by CUDA events
around the run (core/timing.run_ms, the least of n_tests runs): the host
enqueues each call while the card runs the ones before it, so neither
its launch cost nor the card's launch latency lowers a bound, as the JAX
package's chained timing removed its TPU link's.  A single call timed
alone carries a fixed start-up cost that a 512 MiB probe does not
amortize and the benchmarks' 2-4 GiB rows do.  On the CPU, where the plain
versions run and no rate means anything, the least of n_tests host-clocked
calls.  Output: the measured lines, the derived
per-benchmark ceiling table (core/roofline.py) and one JSON line, in the
JAX CLI's format.  The H100's: artifacts/h100/ceilings/ceilings.log.

    python -m tpu_bench_torch.benchmarks.ceilings [--size N] [--ntests N]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import torch

from tpu_bench_torch.core import roofline, timing
from tpu_bench_torch.core.config import resolve_device
from tpu_bench_torch.kernels import reduction as k6
from tpu_bench_torch.kernels import stream


def _seconds(fn, n_tests: int, device: torch.device) -> float:
    """Seconds of one fn(), after a warm-up: on the card sustained over a
    run of n_tests back-to-back calls, the least of n_tests runs; on the
    CPU the least of n_tests calls."""
    if device.type == "cuda":
        return timing.run_ms(fn, n_tests, runs=n_tests) * 1e-3
    return timing.time_variant(fn, n_tests, device)


def measure_directions(n: int, n_tests: int = 12, device="cuda") -> dict:
    """Measured GB/s of the bytes each probe moves, per direction and mix,
    at n f32 elements per buffer (n a multiple of 128)."""
    device = resolve_device(device)
    nbytes = 4 * n
    rows = n // stream.LANES
    x = torch.arange(n, dtype=torch.float32, device=device) % 7
    y = torch.ones(n, dtype=torch.float32, device=device)
    c = torch.full((1, 1), 1.0000001, dtype=torch.float32, device=device)
    zero = torch.zeros((1, 1), dtype=torch.float32, device=device)
    out = torch.empty_like(x)
    # (key, bytes moved per call in units of nbytes, the call); outputs
    # are allocated once here or reused by the caching allocator after the
    # warm-up call, so no timed call touches fresh memory; 512 MiB buffers
    # are ten times the L2, so back-to-back calls find their data cold
    probes = [
        ("read_dma", 1, lambda: stream.read_manual(x, zero)),
        ("read_auto", 1, lambda: k6.sumsq_wide(x, 0.0)),
        ("write_dma", 1, lambda: stream.fill_manual(rows, zero)),
        ("write_auto", 1, lambda: stream.fill(rows, zero)),
        ("copy_2x", 2, lambda: stream.copy_manual(x, out=out)),
        ("scale_2x", 2, lambda: stream.scale_manual(x, c)),
        ("add_3x", 3, lambda: stream.add_inplace_manual(x, y)),
        ("triad_3x", 3, lambda: stream.triad_manual(x, y, c)),
    ] + [(f"expand{m}", 1 + m,
          lambda m=m: stream.expand_manual(x, m, zero)) for m in (2, 4, 8)]
    bw = {}
    for key, copies, fn in probes:
        bw[key] = copies * nbytes * 1e-9 / _seconds(fn, n_tests, device)
        if key in ("read_auto", "write_auto"):
            direction = key.split("_")[0]
            bw[direction] = max(bw[f"{direction}_dma"],
                                bw[f"{direction}_auto"])
    return bw


def derived_table(bw: dict, itemsize: int = 4) -> list:
    """(name, shared_bus, empirical, unit) rows from the measured
    directions: shared-bus = no read/write overlap (the analytic target),
    empirical = the probe-ladder interpolation for that benchmark's exact
    mix (roofline.empirical_mix_bandwidth, the honesty bound; full-duplex
    when the expand probes are absent)."""
    r, w = bw["read"], bw["write"]

    def emp(rb, wb, duplex_fallback):
        v = roofline.empirical_mix_bandwidth(bw, rb, wb)
        return v if v is not None else duplex_fallback

    rows = [
        ("b01 L2-norm (1R)", r, r, "GB/s"),
        ("b02 add 2R+1W (3x)", roofline.stream_add_ceiling(r, w),
         emp(2, 1, roofline.stream_add_ceiling(r, w, duplex=True)), "GB/s"),
        ("b03 matvec (A-read)", roofline.matvec_ceiling_gbs(r),
         roofline.matvec_ceiling_gbs(r), "GB/s"),
    ]
    for dim, nqs in ((2, (2, 4, 6, 8, 10, 12, 14, 16, 32)),
                     (3, (2, 4, 6, 8, 10))):
        for nq in nqs:
            v = roofline.empirical_bwdtrans_gdofs(bw, nq, dim, itemsize)
            if v is None:
                v = roofline.bwdtrans_ceiling_gdofs(r, w, nq, dim, itemsize,
                                                    duplex=True)
            rows.append((
                f"b0{dim + 2} {dim}D nq={nq}",
                roofline.bwdtrans_ceiling_gdofs(r, w, nq, dim, itemsize),
                v, "GDOF/s"))
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="ceilings",
        description="measure device-memory directional/mix bandwidth "
                    "ceilings")
    parser.add_argument("--size", type=int, default=128 * 2**20,
                        help="elements per f32 buffer, a multiple of 128 "
                             "(default 128Mi: 512 MiB)")
    parser.add_argument("--ntests", type=int, default=12)
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the plain versions")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        clock = f"CUDA events around {args.ntests} back-to-back calls"
    else:
        kind, clock = "cpu", "host clock (plain versions)"
    print("-" * 32)
    print(f"{'Ceilings : HBM directions':<32}")
    print("-" * 32)
    print(f"device: {kind}; buffer {4 * args.size / 2**20:.0f} MiB f32; "
          f"{clock}", flush=True)
    bw = measure_directions(args.size, args.ntests, device)
    for k, v in bw.items():
        print(f"Measured {k} GB/s: {v:.10g}", flush=True)
    print("Derived physical ceilings (core/roofline.py): "
          "shared-bus | empirical")
    for name, v, vd, unit in derived_table(bw):
        print(f"Ceiling {name} ({unit}): {v:.10g} | {vd:.10g}")
    print(json.dumps({"device": kind, "f32_elems": args.size,
                      **{k: round(v, 1) for k, v in bw.items()}}))


if __name__ == "__main__":
    main()
