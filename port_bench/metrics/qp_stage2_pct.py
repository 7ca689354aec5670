"""qp_stage2_pct: the share of K1's block time in stage 2 (C12T @ V and the
stores it issues), in %: 100 x the SM cycles of the phase `stage2`, from
the barrier after each plane group's stage 1 to the group's closing
barrier, over those of `block`, summed over every probed launch of the
process (qp_probe.py).  None where the program has no probe or ran no
probed launch."""

from port_bench import qp_probe


def read(run):
    return qp_probe.share("stage2")
