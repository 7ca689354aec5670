"""Carry operands across from the JAX package.

The port keeps the JAX package's array layouts at every public function, so
an operand built by `tpu_bench.benchmarks.benchmark05.prepare` or
`benchmark04.prepare`, or by the initializers of benchmarks 01-03, converts
by a plain copy: `np.asarray` on the JAX side, then `data_from_numpy` here
(bf16 arrays by their bits).
Tests use it to run both packages on the same bytes.  Benchmarks 01-03
have no weights: their operands are their state.
"""

from __future__ import annotations

import numpy as np
import torch

# The operands of each benchmark whose name and layout the two packages
# share (b04's in_blk_w4 is the 4D chunk layout of its Coales column).
B05_KEYS = ("b0", "b1", "b2", "c12t", "c_em3", "c_coa3", "s1_em", "s2_em",
            "s3_em", "in_em2", "in_pcoa3", "in_pflat", "in_blk", "in_coa",
            "in_em4", "in_coa4")
B04_KEYS = ("b0", "b1", "b1t", "c_em", "c_coa", "s1_em", "s2_em", "in_em2",
            "in_coa", "in_em3", "in_coa3", "in_pcoa3", "in_blk_w4")
B01_KEYS = ("x",)
B02_KEYS = ("x", "y")
B03_KEYS = ("a_rm", "a_cm", "x")
KEYS = frozenset(B05_KEYS + B04_KEYS + B01_KEYS + B02_KEYS + B03_KEYS)


def _tensor(a) -> torch.Tensor:
    """A CPU tensor holding a copy of `a`'s values (np.array copies: JAX
    hands out read-only buffers).  A bf16 array (ml_dtypes' bfloat16,
    which torch.from_numpy refuses) moves as its bits."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def data_from_numpy(arrays: dict, *, device, dtype) -> dict:
    """{key: tensor} on `device` in `dtype` from {key: np.ndarray} keyed by
    the JAX package's operand names (see B05_KEYS .. B03_KEYS)."""
    unknown = sorted(set(arrays) - KEYS)
    if unknown:
        raise KeyError(f"no port layout for JAX operands {unknown}")
    return {k: _tensor(a).to(device=device, dtype=dtype)
            for k, a in arrays.items()}
