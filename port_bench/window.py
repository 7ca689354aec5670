"""The measured window: one column's calls enqueued back to back on one
stream, a closed loop with IN_FLIGHT calls in flight.

A CUDA event is recorded after every call (and one before the first), so
the time between two consecutive events is a call's device time plus any
gap the device waited before it.  The host waits for the event of the call
IN_FLIGHT back before it enqueues the next, so it runs at most that many
calls ahead of the device and the window overruns `seconds` by at most as
many calls.  Each call's output is held until the host has seen its call
finish, as a caller that reads it has to, so the calls in flight write
outputs of their own.  Nothing flushes the L2 inside the window, and it
ends with one synchronize.
"""

from __future__ import annotations

import collections
import dataclasses
import random
import time

import torch

# Calls the host keeps enqueued ahead of the device: enough that the host's
# few tens of µs a call never leave the card waiting, as a solver's step
# enqueues the transforms of its fields ahead of their use.
IN_FLIGHT = 8


@dataclasses.dataclass
class Window:
    calls: int
    seconds: float      # host clock, first enqueue to the final synchronize
    call_ms: list       # between consecutive events, one a call
    enqueue_ns: list    # host time from a call's start to its return


class _HostMark:
    """A host-clock stand-in for a CUDA event, for runs on the CPU."""

    def __init__(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, later) -> float:
        return (later.t - self.t) * 1e3


def _mark(device):
    if device.type != "cuda":
        return _HostMark()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Sample:
    """A sample of `size` outputs, drawn from `seed` over all the calls it
    sees (reservoir sampling): each call's output is kept with the same
    chance, however many calls the windows hold."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.kept = []
        self.seen = 0
        self._rng = random.Random(seed)

    def __call__(self, out) -> None:
        if len(self.kept) < self.size:
            self.kept.append(out)
        else:
            slot = self._rng.randrange(self.seen + 1)
            if slot < self.size:
                self.kept[slot] = out
        self.seen += 1


def drive(fn, args, seconds: float, device, keep) -> Window:
    """Call fn(*args) back to back for `seconds` of the host clock, each
    output handed to `keep`, and wait for the last call to finish."""
    pending = collections.deque()
    call_ms, enqueue_ns = [], []
    prev = _mark(device)
    calls = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        start = time.perf_counter_ns()
        out = fn(*args)
        enqueue_ns.append(time.perf_counter_ns() - start)
        keep(out)
        pending.append((_mark(device), out))
        del out
        calls += 1
        if len(pending) > IN_FLIGHT:
            done, _ = pending.popleft()
            done.synchronize()
            call_ms.append(prev.elapsed_time(done))
            prev = done
    synchronize(device)
    elapsed = time.perf_counter() - t0
    for done, _ in pending:
        call_ms.append(prev.elapsed_time(done))
        prev = done
    return Window(calls, elapsed, call_ms, enqueue_ns)
