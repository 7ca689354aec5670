"""The yardstick of the roofline readers: published peaks of one NVIDIA
H100 SXM (NVIDIA's data sheet, dense rates, at its 700 W power limit) and
the least time of an operation's call on it.

The least time counts the operation's least bytes and least FLOP
(operations/<op>.py), not those of the algorithm a column runs, so every
path of a configuration is held to one bound and no path can read above
100% of it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
# The highest rate at which the card can do the operation's multiply-adds
# in each type: FP32 outside the tensor cores; FP64 on them (DMMA); bf16 on
# them.
FLOP_PER_S = {"float32": 67e12, "float64": 67e12, "bfloat16": 989e12}


def least_s(op, config) -> float:
    """Seconds of one call at the card's peaks: the larger of the least
    bytes at the HBM rate and the least FLOP at the type's peak."""
    return max(op.least_bytes(config) / HBM_BYTES_PER_S,
               op.least_flop(config) / FLOP_PER_S[config["dtype"]])


def share(run, match) -> float | None:
    """The least time of a call over the device time a call of the traced
    window spent in the kernels whose profiler name `match` accepts, in
    %; None where the trace holds none of them."""
    if run.trace is None or not run.traced_calls:
        return None
    spans = [e - s for name, s, e in run.trace.device if match(name)]
    if not spans:
        return None
    per_call = sum(spans) * 1e-9 / run.traced_calls
    return 100.0 * least_s(run.op, run.config) / per_call
