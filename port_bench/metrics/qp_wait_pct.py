"""qp_wait_pct: the share of K1's block time that a tile's slab had not yet
arrived, in %: 100 x the SM cycles of the phase `wait` over those of
`block`, summed over every probed launch of the process (qp_probe.py).  At
depth 2 a tile's wait runs from the top of the block's loop to the barrier
after cp.async.wait_group 1; at depth 1 the block's whole load (copy,
operator staging and wait).  None where the program has no probe or ran no
probed launch."""

from port_bench import qp_probe


def read(run):
    return qp_probe.share("wait")
