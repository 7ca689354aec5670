"""Build the port's CUDA kernels and bind them with ctypes.

Every `*.cu` under `tpu_bench_torch/csrc/` is compiled for Hopper
(`sm_90a`) by its own nvcc process, all started together, and the objects
are linked into one shared library with a plain C interface, kept in
`tpu_bench_torch/_build/` under a name that carries a hash of the sources
and flags, so an edited source rebuilds on next use.  Nothing is built or
loaded at import: `library()` does both on the first kernel launch.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `launched` turns a non-zero code into an exception
and otherwise counts the launch in `launches`, keyed by kernel name.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
COMPILE_FLAGS = (*ARCH_FLAGS, "-Xcompiler", "-fPIC", "-Xptxas=-v", "-c")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

# Launches of each kernel on a CUDA device since the count was last reset:
# qp_fused3d (K1), kron_blocked (K2), em_gemm (K3), qp_stage2_3d (K4),
# qp1d_fused3d (K5, three stages), qp1d_fused2d (K5, two stages), sumsq
# (K6, either form counts once per call), map2_inplace (K7), matvec_rm (K8),
# matvec_cm (K9), the ceiling probes stream_read (K10), stream_fill (K11),
# stream_map (K12) and stream_expand (K13), and ozaki_slices (K14, either
# form counts once per launch: the band form launches once per band).
launches: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
# Every scalar of the kernels' arithmetic (eps) goes as a C double, so one
# signature serves the _f32 and _f64 entries.
_SIGNATURES = {
    # in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem, et, g, stream
    "tbt_qp_fused3d": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _P],
    # c, in, out, m_rows, k_depth, n_cols, n_chunks, strip, stream
    "tbt_kron_blocked": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, s, out, e_rows, k_depth, n_cols, tile, stream
    "tbt_em_gemm": [_P, _P, _P, _I, _I, _I, _I, _P],
    # w, b0, out, nm0, nq0, f, unroll, vector, blocks, stream
    "tbt_qp_stage2_3d": [_P, _P, _P, _I, _I, _L, _I, _I, _I, _P],
    # x, s1, s2, s3, out, n_elem, k0, n1, n2, n3, et, stream
    "tbt_qp1d_fused3d": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P],
    # x, s1, s2, out, n_elem, k0, n1, n2, et, stream
    "tbt_qp1d_fused2d": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
    # x, n, eps, out, partials, max_blocks, one_pass, stream
    "tbt_sumsq": [_P, _L, _D, _P, _P, _I, _I, _P],
    # x, y, n, vector, stream
    "tbt_map2_inplace": [_P, _P, _L, _I, _P],
    # a, x, y, m, n, rows, unroll, lanes, vector, blocks, stream
    "tbt_matvec_rm": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # a_cm, x, y, ws, n_rows, m_cols, splits, unroll, stream
    "tbt_matvec_cm": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, n, bias, tok, tok0, sink, stream
    "tbt_stream_read": [_P, _L, _P, _P, _L, _P, _P],
    # out, n, seed, vector, stream
    "tbt_stream_fill": [_P, _L, _P, _I, _P],
    # out, x, y, c, n, op, stream
    "tbt_stream_map": [_P, _P, _P, _P, _L, _I, _P],
    # x, n, bias, out, m, shift, stream
    "tbt_stream_expand": [_P, _L, _P, _P, _I, _I, _P],
}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "nvcc")


def _objects(output: Path) -> list[Path]:
    return [output.with_name(f"{output.name}.{src.stem}.o")
            for src in sources()]


def nvcc_commands(output: Path) -> tuple[list[list[str]], list[str]]:
    """(one compile command per source, the link command) that build every
    kernel into `output`; objects go beside it."""
    compiles = [[nvcc(), *COMPILE_FLAGS, "-o", str(obj), str(src)]
                for src, obj in zip(sources(), _objects(output))]
    return compiles, [nvcc(), *LINK_FLAGS, "-o", str(output),
                      *map(str, _objects(output))]


def library_path() -> Path:
    digest = hashlib.sha256()
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libtpubench_torch_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.

    The compilers' output (with ptxas's register and spill counts) is kept
    in `_build/build.log`."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    compiles, link = nvcc_commands(tmp)
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    outputs = [p.communicate()[0] for p in procs]
    failed = [(p.returncode, out) for p, out in zip(procs, outputs)
              if p.returncode != 0]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        outputs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append((proc.returncode, proc.stdout + proc.stderr))
    (BUILD_DIR / "build.log").write_text("".join(outputs))
    for obj in _objects(tmp):
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        code, out = failed[0]
        raise RuntimeError(f"nvcc failed with exit code {code}:\n"
                           f"{out[-4000:]}")
    os.replace(tmp, so)
    return so


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        for dtype in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{dtype}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.tbt_qp1d_smem.argtypes = [_I, _I, _I, _I, _I]
    lib.tbt_qp1d_smem.restype = _L
    # K1's and K2's shared memory and K2's configuration rule
    lib.tbt_qp_fused3d_smem.argtypes = [_I, _I, _I, _I, _I, _I, _I]
    lib.tbt_qp_fused3d_smem.restype = _L
    lib.tbt_kron_resident_smem.argtypes = [_I, _I, _I, _I]
    lib.tbt_kron_resident_smem.restype = _L
    lib.tbt_kron_strip.argtypes = [_I, _I, _I, _L]
    lib.tbt_kron_strip.restype = ctypes.c_int
    # K3's shared memory and configuration rule; K9's blocks in one wave
    lib.tbt_em_resident_smem.argtypes = [_I, _I, _I, _I]
    lib.tbt_em_resident_smem.restype = _L
    lib.tbt_em_tile.argtypes = [_I, _I, _I, _L]
    lib.tbt_em_tile.restype = ctypes.c_int
    lib.tbt_matvec_cm_blocks.argtypes = [_I, _I]
    lib.tbt_matvec_cm_blocks.restype = ctypes.c_int
    # K4's and K8's blocks in one wave
    lib.tbt_qp_stage2_wave.argtypes = [_I, _I, _I, _I, _I]
    lib.tbt_qp_stage2_wave.restype = ctypes.c_int
    lib.tbt_matvec_rm_wave.argtypes = [_I, _I, _I, _I]
    lib.tbt_matvec_rm_wave.restype = ctypes.c_int
    # K14 takes bf16 slices and writes an f32 pair, so it has no _f32/_f64
    # pair: c, x, hi, lo, t_c, t_x, m_rows, k_depth, n_cols, w[, u], stream
    ozaki = [_P, _P, _P, _P, _I, _I, _I, _I, _L, _I]
    lib.tbt_ozaki_pair.argtypes = [*ozaki, _P]
    lib.tbt_ozaki_band.argtypes = [*ozaki, _I, _P]
    lib.tbt_ozaki_pair.restype = lib.tbt_ozaki_band.restype = ctypes.c_int
    lib.tbt_ozaki_k_pad.argtypes = []
    lib.tbt_ozaki_k_pad.restype = ctypes.c_int
    lib.tbt_error_string.argtypes = [ctypes.c_int]
    lib.tbt_error_string.restype = ctypes.c_char_p
    return lib


def launched(err: int, name: str) -> None:
    """Raise if a kernel's launch returned a CUDA error code, else count
    one launch of kernel `name`."""
    if err != 0:
        msg = library().tbt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
    launches[name] += 1


def check_operands(name: str, tensors) -> None:
    """Raise unless the tensors share one float32 or float64 dtype and one
    CPU or CUDA device and are contiguous, as every kernel entry needs."""
    x = tensors[0]
    if x.dtype == torch.bfloat16:
        raise NotImplementedError(f"{name}: bf16 is not ported yet "
                                  "(ROADMAP Queue 1 item 2)")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {x.dtype} is not supported")
    if any(t.dtype != x.dtype for t in tensors):
        raise TypeError(f"{name}: operands must share one dtype")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: operands must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")


def vector16(n: int, itemsize: int, *ptrs: int) -> bool:
    """Whether rows of n values of `itemsize` bytes are whole 16-byte
    vectors and every pointer lies on a 16-byte boundary: the condition
    for a kernel's 16-byte vector form (K4, K8)."""
    return n * itemsize % 16 == 0 and all(p % 16 == 0 for p in ptrs)


def run(name: str, x: torch.Tensor, *args) -> None:
    """Launch kernel `name` for x's dtype on x's device and stream:
    tbt_<name>_f32/_f64(*args, stream); raise on a CUDA error, else count
    the launch."""
    suffix = "f32" if x.dtype == torch.float32 else "f64"
    fn = getattr(library(), f"tbt_{name}_{suffix}")
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    launched(err, name)
