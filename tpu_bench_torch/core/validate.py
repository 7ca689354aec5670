"""Validation layer (port of tpu_bench/core/validate.py).

The reference's correctness oracle is the side-by-side L2 norm of every
variant's output: agreement across independent implementations of the same
math.  The `norm:` log lines keep it, and check_norm_agreement asserts it.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def l2norm(x: torch.Tensor) -> float:
    """L2 norm on x's device, accumulated in f64."""
    return float(torch.linalg.vector_norm(x.reshape(-1), dtype=torch.float64))


def check_norm_agreement(labels: Sequence[str], norms: Sequence[float],
                         rtol: float, context: str = "") -> list:
    """All variant norms against the first finite one, to rtol.

    Returns human-readable mismatch strings (empty = all agree).  NaN norms
    mark variants that did not run (already reported) and are skipped; the
    reference norm is the first non-NaN entry."""
    ref_idx = next((i for i, n in enumerate(norms) if n == n), None)
    if ref_idx is None:
        return [f"{context}: no variant produced a norm; nothing validated"]
    ref = norms[ref_idx]
    scale = max(abs(ref), 1e-300)
    mismatches = []
    for label, n in zip(labels[ref_idx + 1:], norms[ref_idx + 1:]):
        if n != n:
            continue
        if abs(n - ref) / scale > rtol:
            mismatches.append(
                f"{context} norm mismatch: {labels[ref_idx]}={ref!r} vs "
                f"{label}={n!r} (rtol {rtol})")
    return mismatches


def fail_soft(label, reporter, thunk):
    """Run thunk() -> (seconds, norm); a variant that raises reports
    (inf, nan), a 0 in the throughput column, with a note on stderr, and
    the rest of the row still runs.  Each distinct (variant, message) is
    reported twice, the second time with a suppression notice, then
    silenced."""
    try:
        return thunk()
    except Exception as ex:  # fail-soft per variant, reported on stderr
        first = str(ex).splitlines()[0][:300] if str(ex) else repr(ex)
        seen = reporter.count_warning((label, first))
        if seen == 1:
            reporter.note(f"WARNING: variant {label} failed: {first}")
        elif seen == 2:
            reporter.note(f"WARNING: variant {label} failed again with the "
                          "same error; suppressing identical repeats")
        return math.inf, math.nan


def measure_checked(label, fn, args, cfg, reporter, norm=l2norm, run=None):
    """(seconds, norm) of one variant via fail_soft.  `run(fn, args, cfg)`
    gives (seconds, output), by default the timed calls, then one more
    call (timing.timed_then_applied); `norm` maps the output to the
    printed norm."""
    from tpu_bench_torch.core import timing

    run = run or timing.timed_then_applied

    def thunk():
        t, out = run(fn, args, cfg)
        return t, norm(out)

    return fail_soft(label, reporter, thunk)


def measure_row(bench: str, labels, specs, data, cfg, reporter, *,
                key: str, size: int, work: float, unit: str,
                norm=l2norm, run=None) -> None:
    """One sweep point of a benchmark: every column of `specs` (label, fn,
    operand keys[, the column's own norm]; operands resolved one column at
    a time) timed and normed (measure_checked with the column's norm, else
    `norm`, and `run`), the norms checked against each other, and the
    `<key> <size>` Case/norm/<unit> line triple emitted with throughput
    1e-9*work/t: DOF for b04/b05, bytes for b01-b03."""
    times, norms = [], []
    with cfg.library_precision():
        for label, fn, keys, *own_norm in specs:
            args = tuple(data[k] for k in keys)  # lazy derived layouts
            col_norm = own_norm[0] if own_norm else norm
            t, n = measure_checked(label, fn, args, cfg, reporter, col_norm,
                                   run)
            del args
            times.append(t)
            norms.append(n)

    if cfg.validate:
        for msg in check_norm_agreement(labels, norms,
                                        default_rtol(cfg.dtype),
                                        context=f"{bench} {key}={size}"):
            reporter.note("WARNING: " + msg)

    reporter.emit(key, size, labels, norms, [1e-9 * work / t for t in times],
                  unit)


def default_rtol(dtype) -> float:
    """Cross-variant tolerance per dtype: f64 1e-10, f32 5e-4, bf16 5e-2
    (tpu_bench/core/validate.py's)."""
    if dtype == torch.bfloat16:
        return 5e-2
    return 1e-10 if dtype == torch.float64 else 5e-4
