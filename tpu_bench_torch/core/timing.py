"""Timing harness (port of the dispatch mode of tpu_bench/core/timing.py).

Reference protocol (utils/timer.h:3-45 + benchmark01/benchmark01.cc:197-209):
wall clock around each call, device synchronized before the clock stops,
40 repetitions, the minimum kept.  Warm-up runs once outside the window.

One addition: before each repetition, outside the timed window, the L2
cache is overwritten (`L2Flush`), so a working set that fits in the
card's L2 does not report L2 bandwidth where the reference measured device
memory.  It is the analog of the JAX package's HBM-honest mode.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch


class Timer:
    """Stopwatch with the reference Timer's interface (utils/timer.h:3-45)."""

    def __init__(self):
        self._start = 0
        self._stop = 0

    def start(self) -> None:
        self._start = time.perf_counter_ns()

    def stop(self) -> None:
        self._stop = time.perf_counter_ns()

    def elapsed_seconds(self) -> float:
        return (self._stop - self._start) * 1e-9


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class L2Flush:
    """Overwrites a buffer of twice the card's L2 size; a no-op off CUDA."""

    def __init__(self, device: torch.device):
        self._buf = None
        if device.type == "cuda":
            l2 = torch.cuda.get_device_properties(device).L2_cache_size
            self._buf = torch.empty(2 * l2, dtype=torch.uint8, device=device)

    def __call__(self) -> None:
        if self._buf is not None:
            self._buf.zero_()


def time_variant(step: Callable[[], object], n_tests: int,
                 device: torch.device,
                 flush: Optional[Callable[[], None]] = None,
                 warmup: Optional[Callable[[], object]] = None) -> float:
    """Minimum wall-clock seconds of `step` over n_tests calls, each
    synchronized, after one untimed warm-up call (`warmup`, else `step`)."""
    (warmup or step)()
    synchronize(device)
    timer = Timer()
    best = float("inf")
    for _ in range(n_tests):
        if flush is not None:
            flush()
        synchronize(device)
        timer.start()
        step()
        synchronize(device)
        timer.stop()
        best = min(best, timer.elapsed_seconds())
    return best


# Clock cycles the card spins before each window of event_ms, about 0.5 ms
# at the H100's 1.98 GHz: many times what the host takes to enqueue one of
# the port's calls, so the card is still busy when the call arrives and
# the window holds no idle time.
ENQUEUE_CYCLES = 1_000_000


def event_ms(fn: Callable[[], object], reps: int = 20) -> float:
    """Least device time in ms of one fn() on the current CUDA device, by
    CUDA events around each call, the L2 flushed before each, after one
    untimed call.  The card spins (ENQUEUE_CYCLES) between the flush and
    the window while the host enqueues the window, else the window would
    also hold the host's time to enqueue fn."""
    flush = L2Flush(torch.device("cuda"))
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        flush()
        torch.cuda._sleep(ENQUEUE_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop))
    return best


def run_ms(fn: Callable[[], object], calls: int, runs: int = 5) -> float:
    """Device time in ms of one fn() sustained over a run of `calls`
    back-to-back calls on the current CUDA device: CUDA events around the
    run, the least of `runs` runs, after one untimed run (which brings the
    card's clocks up from idle).  The host enqueues each call while the
    card runs the ones before it, so its enqueue time and the card's
    launch latency do not stand in the per-call time (the analog of the
    JAX package's chained timing).  The L2 is not flushed: the working set
    must exceed it."""
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop) / calls)
    return best


def measure(fn: Callable, args, cfg) -> float:
    """Seconds of one application of fn(*args) under cfg's protocol."""
    flush = L2Flush(cfg.device) if cfg.flush_l2 else None
    return time_variant(lambda: fn(*args), cfg.n_tests, cfg.device, flush)


def timed_then_applied(fn: Callable, args, cfg) -> tuple:
    """(seconds of fn(*args) under cfg's protocol, one more call's
    output): the row protocol of every benchmark but b02."""
    return measure(fn, args, cfg), fn(*args)


def accumulating(fn: Callable, args, cfg) -> tuple:
    """b02's protocol (tpu_bench/benchmarks/benchmark02.py:148-163): one
    warm-up on a scratch copy of x, then exactly cfg.n_tests timed
    accumulating calls x = fn(x, y) on x itself, the L2 flushed before
    each.  Returns (least seconds, the final x), so the output is
    x0 + n_tests*y, whose norm the reference prints
    (benchmark02/benchmark02.cc:161-164)."""
    x, y = args
    flush = L2Flush(cfg.device) if cfg.flush_l2 else None

    def step():
        nonlocal x
        x = fn(x, y)

    t = time_variant(step, cfg.n_tests, cfg.device, flush,
                     warmup=lambda: fn(x.clone(), y))
    return t, x
