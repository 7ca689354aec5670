"""K1's probe as the readers qp_wait_pct, qp_stage1_pct, qp_stage2_pct and
qp_slot_idle_pct take it: tpu_bench_torch/kernels/bwdtrans3d.qp_phases,
the cycles and records that K1's probe form (csrc/qp_fused3d.cuh, P =
true) keeps on the card while a profiler records.  The traced window, and
the profiled calls before it, are the process's only probed launches, so
sums over the process are the traced run's."""

from __future__ import annotations


def readings():
    """The program's probe readings on the current device; None where the
    program has no probe or ran no probed launch."""
    try:
        from tpu_bench_torch.kernels.bwdtrans3d import qp_phases
    except ImportError:  # a program without the probe
        return None
    return qp_phases()


def share(phase: str) -> float | None:
    """100 x the SM cycles of `phase` over those of K1's blocks, summed
    over every probed launch; None without readings."""
    found = readings()
    if not found or not found["cycles"]["block"]:
        return None
    return 100.0 * found["cycles"][phase] / found["cycles"]["block"]


def slot_idle_pct(blocks, slots) -> float | None:
    """100 x (1 - the blocks' ns over slots x the launch's ns): the share
    of the launch's resident block slots that held no block.  `blocks`:
    (start ns, exit ns, SM, cycles) of each block of one launch on
    %globaltimer, 0 where the block read none (a block of the first or
    last wave of slots reads it at its start, one of the last wave at its
    exit too).  The launch runs from the first start to the last exit; a
    block with both stamps counts its own ns, any other its cycles at the
    SM clock's rate over those.  None without a block of both stamps or
    without a slot."""
    def both(b):
        return b[0] and b[1] > b[0]

    timed = [b for b in blocks if both(b)]
    cycles = sum(b[3] for b in timed)
    if not timed or not cycles or slots <= 0:
        return None
    start = min(b[0] for b in blocks if b[0])
    end = max(b[1] for b in blocks)
    ns_per_cycle = sum(b[1] - b[0] for b in timed) / cycles
    held = sum(b[1] - b[0] if both(b) else b[3] * ns_per_cycle
               for b in blocks)
    return 100.0 * (1.0 - held / (slots * (end - start)))
