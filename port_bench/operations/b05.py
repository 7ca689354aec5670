"""benchmark05's operation: 3D BwdTrans of hexahedral elements.

    out[e, k, j, i] = sum_{r, q, p} in[e, r, q, p] B0[p, i] B1[q, j] B2[r, k]

with nm_d = nq_d - 1 modes and nq_d points in each direction (upstream
benchmark05/benchmark05.cc:695-740).  Coefficients are (E, nmTot) with p
the fastest mode; the output is (E, nqTot) with i the fastest point.

This module is the benchmark's yardstick for the operation: the seeded
inputs, the plain float64 reference and its lower-precision control, the
DOF count of a call and the least bytes and FLOP any implementation must
move and do.  It imports nothing of the program.
"""

from __future__ import annotations

import itertools
import math

import torch


def orders(config) -> tuple:
    """(nq0, nq1, nq2): points in each direction."""
    nq0, nq1, nq2 = (int(n) for n in config["nq"])
    return nq0, nq1, nq2


def dtype(config) -> torch.dtype:
    return getattr(torch, config["dtype"])


def inputs(config, seed: int, device) -> dict:
    """B0 (nm0, nq0), B1, B2 and every element's own coefficients
    `coef` (E, nmTot), uniform in [-1, 1), drawn in that order by one
    generator on `device` seeded with `seed`: the same seed gives the same
    inputs."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    kind = dtype(config)

    def uniform(*shape):
        x = torch.rand(shape, generator=gen, dtype=kind, device=device)
        return x.mul_(2).sub_(1)

    nq = orders(config)
    basis = [uniform(n - 1, n) for n in nq]
    nm_tot = math.prod(n - 1 for n in nq)
    coef = uniform(int(config["nelmt"]), nm_tot)
    return dict(b0=basis[0], b1=basis[1], b2=basis[2], coef=coef)


def dof(config) -> int:
    """Input DOFs of one call, the upstream suite's count
    (benchmark05.cc:1407-1419): nelmt * nm0 * nm1 * nm2."""
    return int(config["nelmt"]) * math.prod(n - 1 for n in orders(config))


def least_bytes(config) -> int:
    """Each input read once and the output written once: every element's
    nmTot coefficients and nqTot points, and the three bases."""
    nq = orders(config)
    per_elem = math.prod(n - 1 for n in nq) + math.prod(nq)
    bases = sum((n - 1) * n for n in nq)
    itemsize = torch.empty((), dtype=dtype(config)).element_size()
    return itemsize * (int(config["nelmt"]) * per_elem + bases)


def least_flop(config) -> int:
    """The least FLOP (2 a multiply-add) of one call over the contraction
    orders: the directions contracted one group at a time, in every order
    and grouping, a group of two or three through the Kronecker product of
    its bases (formed once, one multiply an entry).  One direction at a
    time is the three-stage sum factorization; all three at once is the
    dense kron GEMM."""
    nq = orders(config)
    nm = [n - 1 for n in nq]
    e = int(config["nelmt"])
    best = None
    for perm in itertools.permutations(range(3)):
        for cuts in ((1, 1, 1), (1, 2), (2, 1), (3,)):
            extent = list(nm)  # the current extent of each direction
            per_elem, formed, at = 0, 0, 0
            for size in cuts:
                group = perm[at:at + size]
                at += size
                rest = math.prod(extent[d] for d in range(3)
                                 if d not in group)
                k = math.prod(nm[d] for d in group)
                n = math.prod(nq[d] for d in group)
                per_elem += 2 * rest * k * n
                if size > 1:
                    formed += k * n
                for d in group:
                    extent[d] = nq[d]
            total = e * per_elem + formed
            best = total if best is None else min(best, total)
    return best


def _stages(coef, b0, b1, b2, nq, cast):
    """The three one-direction stages on coef (e, nmTot), each operand
    passed through `cast` first; out (e, nqTot), i fastest."""
    nq0, nq1, nq2 = nq
    e = coef.shape[0]
    x = cast(coef).reshape(e, nq2 - 1, nq1 - 1, nq0 - 1)
    x = torch.einsum("erqp,pi->erqi", x, cast(b0))
    x = torch.einsum("erqi,qj->erji", cast(x), cast(b1))
    x = torch.einsum("erji,rk->ekji", cast(x), cast(b2))
    return x.reshape(e, nq0 * nq1 * nq2)


def reference(config, coef, b0, b1, b2):
    """The plain reference: out (e, nqTot) in float64 for the elements of
    `coef` (e, nmTot), whatever their dtype."""
    return _stages(coef, b0, b1, b2, orders(config),
                   lambda t: t.to(torch.float64))


def _tf32(t):
    """t rounded to TF32 (10 explicit mantissa bits, to nearest even), as
    a TF32 tensor-core GEMM rounds its float32 operands."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


# The control: the reference computed in the nearest precision below the
# configuration's, each stage's operands rounded to it.  float32 for
# float64; TF32 operands with float32 sums for float32.
CONTROL = {
    "float64": lambda t: t.to(torch.float32),
    "float32": _tf32,
}


def control(config, coef, b0, b1, b2):
    """The reference in the precision below the configuration's: out
    (e, nqTot) in float32."""
    with _full_fp32():
        return _stages(coef, b0, b1, b2, orders(config),
                       CONTROL[config["dtype"]])


class _full_fp32:
    """float32 matmuls in full FP32 inside the block (TF32 off), so the
    control's precision is the one it states."""

    def __enter__(self):
        self._was = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")

    def __exit__(self, *exc):
        torch.set_float32_matmul_precision(self._was)
        return False
