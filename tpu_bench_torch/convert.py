"""Carry operands across from the JAX package.

The port keeps the JAX package's array layouts at every public function, so
an operand built by `tpu_bench.benchmarks.benchmark05.prepare` converts by
a plain copy: `np.asarray` on the JAX side, then `data_from_numpy` here.
Tests use it to run both packages on the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch

# The b05 operands whose layout the two packages share.
KEYS = ("b0", "b1", "b2", "c12t", "c_em3", "c_coa3", "s1_em", "s2_em",
        "s3_em", "in_em2", "in_pcoa3", "in_pflat", "in_blk", "in_coa", "in_em4",
        "in_coa4")


def data_from_numpy(arrays: dict, *, device, dtype) -> dict:
    """{key: tensor} on `device` in `dtype` from {key: np.ndarray} keyed by
    the JAX prepare dict's names (see KEYS)."""
    unknown = sorted(set(arrays) - set(KEYS))
    if unknown:
        raise KeyError(f"no port layout for JAX operands {unknown}")
    # np.array copies: JAX hands out read-only buffers
    return {k: torch.from_numpy(np.array(a, order="C")).to(device=device,
                                                            dtype=dtype)
            for k, a in arrays.items()}
