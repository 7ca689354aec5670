"""Run configuration shared by the benchmarks (port of
tpu_bench/core/config.py).

The reference suite configures runs through positional argv plus hard-coded
sweep bounds; the benchmark CLIs keep that contract and gather everything
else (dtype, repetition count, device, memory cap, block size) here.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Union

import torch

DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}
PRECISIONS = ("default", "highest")
# Routes of benchmarks 04/05's f64 Pallas(Coales) column: K2 built in
# double, or the JAX package's split-mantissa slices through K14
# (kernels/ozaki.py).
F64_COALES = ("native", "ozaki")
# Fraction of device memory a sweep size may use.
MEM_FRACTION = 0.80


def resolve_device(device) -> torch.device:
    """The run's device.  A CUDA request without a CUDA device raises: a
    run never moves to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


@dataclasses.dataclass
class Config:
    """Knobs shared across benchmarks.

    n_tests=40 and the min-of-N protocol mirror the reference harness
    (benchmark01/benchmark01.cc:186, :208).  `epb` (elements per block, the
    reference's threads*elblocks) is the block size of the fused QP kernel;
    None takes the kernel's default.  `precision` governs the library tier
    only: "highest" keeps float32 matmuls in full FP32 (TF32 off) and
    bf16 matmuls summing in FP32, "default" lets cuBLAS/cuDNN use TF32 and
    reduce bf16 products in bf16.  The hand kernels ignore it: they use
    FP32/FP64 FMA, except K5 (QP-1D/Shared), whose f32 chain runs as
    3xTF32 on the tensor cores (FP32-level accuracy) and its f64 chain on
    DMMA, and K14, whose bf16 slice products sum exactly on the tensor
    cores.  bf16 runs benchmarks 04 and 05 only: their hand kernels (K1-K5)
    store bf16 and sum in f32, rounding where the JAX kernels round.
    `flush_l2` overwrites the L2 cache between timed repetitions so working
    sets that fit in L2 still report device-memory bandwidth.
    `f64_coales` is the route of benchmarks 04/05's f64 Pallas(Coales)
    column (F64_COALES); "ozaki" needs f64.
    """

    dtype: torch.dtype = torch.float32
    n_tests: int = 40
    epb: Optional[int] = None
    device: Union[str, torch.device] = "cuda"
    precision: str = "highest"
    validate: bool = True
    flush_l2: bool = True
    f64_coales: str = "native"

    def __post_init__(self):
        if self.dtype not in DTYPES.values():
            raise ValueError(f"unsupported dtype {self.dtype}")
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        if self.f64_coales not in F64_COALES:
            raise ValueError(f"f64_coales must be one of {F64_COALES}")
        if self.f64_coales == "ozaki" and self.dtype != torch.float64:
            raise ValueError("f64_coales='ozaki' routes the f64 "
                             "Pallas(Coales) column; it needs dtype f64, "
                             f"not {self.dtype}")
        self.device = resolve_device(self.device)

    @property
    def itemsize(self) -> int:
        return self.dtype.itemsize

    @property
    def mem_cap_bytes(self) -> int:
        if self.device.type == "cuda":
            total = torch.cuda.mem_get_info(self.device)[1]
        else:
            total = 8 * 1024**3  # CPU runs: keep sweeps modest
        return int(total * MEM_FRACTION)

    @contextlib.contextmanager
    def library_precision(self):
        """Set the TF32 switches of cuBLAS and cuDNN and cuBLAS's bf16
        reduced-precision reduction for this run's precision, and restore
        them on exit.  Under "highest" a bf16 product sums in f32, as the
        JAX library tier asks (preferred_element_type)."""
        fast = self.precision == "default"
        matmul = torch.backends.cuda.matmul
        saved = (matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                 matmul.allow_bf16_reduced_precision_reduction)
        matmul.allow_tf32 = fast
        torch.backends.cudnn.allow_tf32 = fast
        matmul.allow_bf16_reduced_precision_reduction = fast
        try:
            yield
        finally:
            (matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             matmul.allow_bf16_reduced_precision_reduction) = saved

    @classmethod
    def from_flags(cls, args) -> "Config":
        """Build from an argparse namespace produced by benchmarks.cli."""
        return cls(
            dtype=DTYPES[args.dtype],
            n_tests=args.ntests,
            epb=args.epb,
            device=args.device,
            precision=args.precision,
            validate=not args.no_validate,
            flush_l2=not args.l2_resident,
            f64_coales=getattr(args, "f64_coales", "native"),
        )
