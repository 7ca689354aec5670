"""What decides `correct`: the outputs the window produced, every element
of each, against the operation's plain float64 reference, computed from
the seed anew once the program's state is freed, a block of elements at a
time so that it fits beside them.

The number compared is `max_err`: the largest |output - reference| over
every element and point, over the largest |reference|.  A value that is
not finite reads as infinite.
"""

from __future__ import annotations

import math

import torch

# Elements of one block of the reference.
BLOCK = 65536


def errors(op, config, seed: int, device, candidates) -> list:
    """max_err of each candidate.  A candidate maps (coef block (e, nmTot),
    the other seeded inputs, e0, e1) to its (e, nqTot) output rows for
    elements e0..e1."""
    inputs = op.inputs(config, seed, device)
    coef = inputs.pop("coef")
    worst = [0.0] * len(candidates)
    scale = 0.0
    for e0 in range(0, coef.shape[0], BLOCK):
        e1 = min(coef.shape[0], e0 + BLOCK)
        ref = op.reference(config, coef[e0:e1], **inputs)
        scale = max(scale, ref.abs().max().item())
        for n, rows in enumerate(candidates):
            got = rows(coef[e0:e1], inputs, e0, e1).to(torch.float64)
            gap = (got - ref).abs().max().item()
            worst[n] = max(worst[n], gap if math.isfinite(gap) else math.inf)
    return [w / scale for w in worst]


def output_errors(op, config, path, seed: int, device, outputs) -> list:
    """max_err of each output of the column `path`."""
    nq = op.orders(config)

    def of(out):
        return lambda coef, inputs, e0, e1: path.rows(out, nq, e0, e1)

    return errors(op, config, seed, device, [of(out) for out in outputs])


def control_error(op, config, seed: int, device) -> float:
    """max_err of the operation's control: the reference computed in the
    precision below the configuration's, in the program's place."""
    def rows(coef, inputs, e0, e1):
        return op.control(config, coef, **inputs)

    return errors(op, config, seed, device, [rows])[0]
