"""Log-line writer (port of tpu_bench/core/reporting.py).

The emitted format is a strict contract with the postprocessing pipeline:
b04/b05 throughput lines contain "nelmt" + "DOF/s", token [1] is the size
and tokens [3:] the per-variant values, after a title line containing
"NQ =".  Values carry 10 significant digits, like the reference's
std::setprecision(10) (benchmark01/benchmark01.cc:318).  The lines are
byte-identical to the JAX package's.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence, TextIO


def fmt10(v: float) -> str:
    """10-significant-digit formatting, like std::setprecision(10)."""
    return f"{v:.10g}"


class Reporter:
    def __init__(self, title: str, stream: Optional[TextIO] = None):
        self.stream = stream if stream is not None else sys.stdout
        self._warnings: dict = {}
        bar = "-" * 32
        self._write(bar)
        self._write(f"{title:<32}")
        self._write(bar)

    def _write(self, line: str) -> None:
        self.stream.write(line + "\n")
        self.stream.flush()  # append-to-log semantics: partial sweeps usable

    def sweep_title(self, line: str) -> None:
        """e.g. 'BwdTrans (NQ = 8, 8, 8)', parsed as the plot title."""
        self._write(line)

    def emit(self, prefix: str, size: int, labels: Sequence[str],
             norms: Sequence[float], values: Sequence[float],
             unit: str) -> None:
        """Write the Case/norm/throughput line triple for one sweep point."""
        self._write(f"{prefix} {size} Case: " + " ".join(labels))
        self._write(f"{prefix} {size} norm: " + " ".join(fmt10(n) for n in norms))
        self._write(f"{prefix} {size} {unit}: " + " ".join(fmt10(v) for v in values))

    def note(self, msg: str) -> None:
        """Out-of-band message; goes to stderr so logs stay parseable."""
        print(msg, file=sys.stderr, flush=True)

    def count_warning(self, key) -> int:
        """How many times this run has now seen warning `key`."""
        self._warnings[key] = self._warnings.get(key, 0) + 1
        return self._warnings[key]
