"""qp_stage1_pct: the share of K1's block time in stage 1 (V = B0-weighted
sums of the slab's planes), in %: 100 x the SM cycles of the phase
`stage1`, from the top of each plane group to the barrier after its stage
1, over those of `block`, summed over every probed launch of the process
(qp_probe.py).  None where the program has no probe or ran no probed
launch."""

from port_bench import qp_probe


def read(run):
    return qp_probe.share("stage1")
