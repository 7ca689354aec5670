"""qp_slot_idle_pct: the share of K1's resident block slots that held no
block during its newest probed launch, in %: 100 x (1 - the blocks' ns over
slots x the launch's ns), the launch's from its first block's start to its
last block's exit on %globaltimer, a block's from its own stamps where it
read both (the last wave of slots) and else from its SM cycles at the
clock's rate over those blocks, the slots the occupancy API's blocks an
SM times the SMs (qp_probe.py).  At depth 2 it counts the persistent grid's tail; at depth
1 also the turnover between blocks on an SM.  None where the program has
no probe or ran no probed launch, or holds fewer block records than the
launch had blocks."""

from port_bench import qp_probe


def read(run):
    found = qp_probe.readings()
    if not found or len(found["blocks"]) != found["grid"]:
        return None
    return qp_probe.slot_idle_pct(found["blocks"], found["slots"])
