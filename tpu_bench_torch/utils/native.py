"""f64 host initializers and oracle of the benchmark inputs, in NumPy.

The port's own copy of what it uses from the JAX package's
tpu_bench/utils/native.py, without that module's native library: the
formulas are the reference's, evaluated in f64 so every run starts from the
same bytes.  np.sin / np.cos of the integer ramps give the native library's
values bit for bit, so the two packages build identical BwdTrans and b03
operands.  The modular ramps of b01/b02 are the formula op by op; that
library, built with -march=native, fuses them into FMAs and differs by one
ulp on a few percent of the elements (ops/initdata.py).
"""

from __future__ import annotations

import numpy as np


def init_mod13(n: int) -> np.ndarray:
    """x[i] = i%13 + (0.2 + 1e-5*(i%100191)): b01/b02 x
    (benchmark01/benchmark01.cc:178)."""
    i = np.arange(n, dtype=np.int64)
    return (i % 13).astype(np.float64) + (0.2 + 0.00001 * (i % 100191))


def init_mod8(n: int) -> np.ndarray:
    """y[i] = i%8 + (0.4 + 3e-5*(i%100721)): b02 y
    (benchmark02/benchmark02.cc:143)."""
    i = np.arange(n, dtype=np.int64)
    return (i % 8).astype(np.float64) + (0.4 + 0.00003 * (i % 100721))


def init_sin1(n: int) -> np.ndarray:
    """a[l] = sin(l+1): b04/b05 element data (benchmark03/benchmark03.cc:161)."""
    return np.sin(np.arange(1, n + 1, dtype=np.float64))


def init_cos(n: int) -> np.ndarray:
    """B[l] = cos(l): basis init (benchmark04/benchmark04.cc:478-486)."""
    return np.cos(np.arange(n, dtype=np.float64))


def matvec_ref(a: np.ndarray, x: np.ndarray) -> np.ndarray:
    """y = A @ x in f64: the b03 oracle."""
    return np.asarray(a, dtype=np.float64) @ np.asarray(x, dtype=np.float64)


def bwdtrans2d_ref(inp: np.ndarray, b0: np.ndarray,
                   b1: np.ndarray) -> np.ndarray:
    """out[e,j,i] = sum_{q,p} in[e,q,p] b0[p,i] b1[q,j] (f64)."""
    f64 = [np.asarray(a, dtype=np.float64) for a in (inp, b0, b1)]
    return np.einsum("eqp,pi,qj->eji", *f64, optimize=True)


def bwdtrans3d_ref(inp: np.ndarray, b0: np.ndarray, b1: np.ndarray,
                   b2: np.ndarray) -> np.ndarray:
    """out[e,k,j,i] = sum_{r,q,p} in[e,r,q,p] b0[p,i] b1[q,j] b2[r,k] (f64)."""
    f64 = [np.asarray(a, dtype=np.float64) for a in (inp, b0, b1, b2)]
    return np.einsum("erqp,pi,qj,rk->ekji", *f64, optimize=True)
