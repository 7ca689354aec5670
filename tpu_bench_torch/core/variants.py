"""One variant convention for the benchmarks (port of
tpu_bench/core/variants.py).

Each benchmark module defines

    variant_specs(data, cfg) -> ordered list of (label, fn, operand_keys)

the analog of the reference's run_test<T> body timing several
implementations of the same math in sequence.  A spec whose output is not
the tensor the row norms, as the (hi, lo) pair of the f64 Ozaki
Pallas(Coales) column, carries its norm as a fourth entry
(label, fn, operand_keys, norm).  The ordered labels are the
Case-line columns the postprocess scripts read.  operand_keys resolve
through a Layouts, so each layout of the element stream is built fresh for
the one variant that uses it and dropped afterwards.
"""

from __future__ import annotations

# The eleven columns of benchmark04 and benchmark05, with the reference's
# names so postprocess/ reads the port's logs unchanged.
LABELS = [
    "XLA(Uncoales)", "XLA(Coales)", "XLA(QP)", "XLA(QP/DG)", "XLA(GEMM)",
    "Pallas(Uncoales)", "Pallas(Coales)", "Pallas(QP)", "Pallas(QP/Shared)",
    "Pallas(QP-1D)", "Pallas(QP-1D/Shared)",
]


class Layouts:
    """Operand mapping with lazy derived layouts.

    Canonical tensors (bases, operators, knobs) are stored; derived layouts
    of the element stream are materialized fresh on each [] access and owned
    by the caller, so at most one derived copy of the stream is resident
    beside the canonicals."""

    def __init__(self, base: dict, derived: dict):
        self._base = dict(base)
        self._derived = dict(derived)

    def __getitem__(self, key):
        if key in self._base:
            return self._base[key]
        return self._derived[key]()

    def __setitem__(self, key, value):
        self._base[key] = value

    def add_derived(self, key, build):
        self._derived[key] = build


def materialize(specs, data):
    """(label, fn, args[, norm]) with every operand resolved up front: a
    test-suite and small-size convenience.  Sweeps resolve keys per variant
    instead.  A spec that carries its own norm keeps it."""
    return [(label, fn, tuple(data[k] for k in keys), *norm)
            for label, fn, keys, *norm in specs]
