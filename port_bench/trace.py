"""What the profiler saw of the traced window, reduced to the numbers the
per-layer readers and the breakdown take: the device's operations and
the host's, in one time base, clipped to the window.

The events are read from the profiler's raw results, which costs a small
part of building its per-op tables.
"""

from __future__ import annotations

import dataclasses

# The profiler's activity types of work on the device.  Its other device
# records (annotations mirrored onto the stream) are not work.
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
# The host annotation that spans the window.
WINDOW = "port_bench.window"


@dataclasses.dataclass
class Trace:
    """Device operations and host events as (name, start_ns, end_ns),
    clipped to the window (start_ns, end_ns)."""
    window: tuple
    device: list
    host: list

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9


def _device_work(event) -> bool:
    """Whether a record on the device is work: by its activity type where
    the profiler gives one, else anything but a mirrored annotation."""
    kind = getattr(event, "activity_type", None)
    if kind is not None:
        return str(kind()) in DEVICE_WORK
    return not event.is_user_annotation()


def read(prof) -> Trace | None:
    """The Trace of a finished torch.profiler.profile whose window is
    annotated WINDOW; None if the window is not in it."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    window = None
    device, host = [], []
    for ev in events:
        name = ev.name()
        span = (name, ev.start_ns(), ev.end_ns())
        if ev.device_type() == DeviceType.CPU:
            if name == WINDOW:
                window = span[1:]
            else:
                host.append(span)
        elif _device_work(ev):
            device.append(span)
    if window is None:
        return None
    lo, hi = window
    return Trace(window=window,
                 device=_clip(device, lo, hi), host=_clip(host, lo, hi))


def _clip(spans, lo, hi) -> list:
    return sorted(((n, max(s, lo), min(e, hi)) for n, s, e in spans
                   if e > lo and s < hi), key=lambda sp: sp[1])


def busy(trace: Trace) -> list:
    """The union of the device's operations, as sorted (start, end)."""
    merged = []
    for _, s, e in trace.device:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def busy_s(trace: Trace) -> float:
    return sum(e - s for s, e in busy(trace)) * 1e-9


def gaps(trace: Trace) -> list:
    """The window's idle intervals on the device, as (start, end)."""
    out, at = [], trace.window[0]
    for s, e in busy(trace):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if trace.window[1] > at:
        out.append((at, trace.window[1]))
    return out


def device_ops(trace: Trace, top: int = 10) -> list:
    """[name, seconds] of the device operations that took most time in the
    window, summed by name."""
    total = {}
    for name, s, e in trace.device:
        total[name] = total.get(name, 0) + (e - s)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns * 1e-9] for name, ns in ranked]


def idle_gaps(trace: Trace, top: int = 10) -> list:
    """[what the host was doing, seconds] of the longest idle gaps: the
    host event that overlaps most of the gap, the shortest (innermost) on
    a tie."""
    longest = sorted(gaps(trace), key=lambda g: g[0] - g[1])[:top]
    out = []
    for s, e in longest:
        label, best = "host: no traced event", (0, 0)
        for name, hs, he in trace.host:
            if hs >= e:
                break
            overlap = min(he, e) - max(hs, s)
            if overlap > 0 and (overlap, hs - he) > best:
                label, best = name, (overlap, hs - he)
        out.append([label, (e - s) * 1e-9])
    return out
