"""benchmark04's operation: 2D BwdTrans of quadrilateral elements.

    out[e, j, i] = sum_{q, p} in[e, q, p] B0[p, i] B1[q, j]

with nm_d = nq_d - 1 modes and nq_d points in each direction (upstream
benchmark04/benchmark04.cc:437-438, 489-523).  Coefficients are (E, nmTot)
with p the fastest mode; the output is (E, nqTot) with i the fastest point.

This module is the benchmark's yardstick for the operation: the seeded
inputs, the plain float64 reference and its lower-precision control, the
DOF count of a call and the least bytes and FLOP any implementation must
move and do.  It imports nothing of the program; the precision helpers
are b05's, so both operations' controls round alike.
"""

from __future__ import annotations

import math

import torch

from port_bench import spec

_B05 = spec.load("operations", "b05")
dtype = _B05.dtype


def orders(config) -> tuple:
    """(nq0, nq1): points in each direction."""
    nq0, nq1 = (int(n) for n in config["nq"])
    return nq0, nq1


def inputs(config, seed: int, device) -> dict:
    """B0 (nm0, nq0), B1 and every element's own coefficients `coef`
    (E, nmTot), uniform in [-1, 1), drawn in that order by one generator
    on `device` seeded with `seed`: the same seed gives the same inputs."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    kind = dtype(config)

    def uniform(*shape):
        x = torch.rand(shape, generator=gen, dtype=kind, device=device)
        return x.mul_(2).sub_(1)

    nq = orders(config)
    b0, b1 = (uniform(n - 1, n) for n in nq)
    coef = uniform(int(config["nelmt"]), math.prod(n - 1 for n in nq))
    return dict(b0=b0, b1=b1, coef=coef)


def dof(config) -> int:
    """Input DOFs of one call, the upstream suite's count
    (benchmark04.cc:1043-1054): nelmt * nm0 * nm1."""
    return int(config["nelmt"]) * math.prod(n - 1 for n in orders(config))


def least_bytes(config) -> int:
    """Each input read once and the output written once: every element's
    nmTot coefficients and nqTot points, and the two bases."""
    nq = orders(config)
    per_elem = math.prod(n - 1 for n in nq) + math.prod(nq)
    bases = sum((n - 1) * n for n in nq)
    itemsize = torch.empty((), dtype=dtype(config)).element_size()
    return itemsize * (int(config["nelmt"]) * per_elem + bases)


def least_flop(config) -> int:
    """The least FLOP (2 a multiply-add) of one call over the contraction
    orders: one direction at a time, p first or q first (the two-stage sum
    factorization), or both at once through the Kronecker product of the
    bases (formed once, one multiply an entry: the dense kron GEMM)."""
    nq0, nq1 = orders(config)
    nm0, nm1 = nq0 - 1, nq1 - 1
    e = int(config["nelmt"])
    p_first = 2 * (nm1 * nm0 * nq0 + nq0 * nm1 * nq1)
    q_first = 2 * (nm0 * nm1 * nq1 + nq1 * nm0 * nq0)
    kron = nm0 * nm1 * nq0 * nq1
    return min(e * p_first, e * q_first, e * 2 * kron + kron)


def _stages(coef, b0, b1, nq, cast):
    """The two one-direction stages on coef (e, nmTot), each operand passed
    through `cast` first; out (e, nqTot), i fastest."""
    nq0, nq1 = nq
    e = coef.shape[0]
    x = cast(coef).reshape(e, nq1 - 1, nq0 - 1)
    x = torch.einsum("eqp,pi->eqi", x, cast(b0))
    x = torch.einsum("eqi,qj->eji", cast(x), cast(b1))
    return x.reshape(e, nq0 * nq1)


def reference(config, coef, b0, b1):
    """The plain reference: out (e, nqTot) in float64 for the elements of
    `coef` (e, nmTot), whatever their dtype."""
    return _stages(coef, b0, b1, orders(config),
                   lambda t: t.to(torch.float64))


def control(config, coef, b0, b1):
    """The reference in the precision below the configuration's (b05's
    CONTROL: TF32 operands with float32 sums for float32, float32 for
    float64): out (e, nqTot) in float32."""
    with _B05._full_fp32():
        return _stages(coef, b0, b1, orders(config),
                       _B05.CONTROL[config["dtype"]])
