"""Build the port's CUDA kernels and bind them with ctypes.

Every `*.cu` under `tpu_bench_torch/csrc/` is compiled for Hopper
(`sm_90a`) by its own nvcc process, all started together, and the objects
are linked into one shared library with a plain C interface, kept in
`tpu_bench_torch/_build/` under a name that carries a hash of the sources
and flags, so an edited source rebuilds on next use.  Nothing is built or
loaded at import: `library()` does both on the first kernel launch.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `launched` turns a non-zero code into an exception
and otherwise counts the launch in `launches`, keyed by kernel name (with
`_bf16` appended for a bf16 instance).  While a torch profiler records,
`run` also puts each launch under the span `tbt.launch.<that key>`
(core/spans.py).

A launch costs the host as little as the library calls it is timed
beside: `entry` looks each C entry up once per (name, dtype), `run` takes
the current stream of x's device as a raw handle and enters that device's
context only when it is not the current one, and the C launchers ask the
CUDA runtime for occupancy and shared-memory opt-ins once per device
(csrc/common.cuh DeviceCache).
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from tpu_bench_torch.core import spans

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
# form counts once per launch: the band form launches once per band).  A
# bf16 instance of K1-K5 counts under its name with "_bf16" appended
# (qp_fused3d_bf16, ...), so a run shows which instance it went through.
launches: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
# Every scalar of the kernels' arithmetic (eps) goes as a C double, so one
# signature serves the _f32 and _f64 entries (and _bf16, BF16_KERNELS).
_SIGNATURES = {
    # in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem, et, g, depth,
    # threads, body, stream
    "tbt_qp_fused3d": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _I, _I,
                       _I, _P],
    # c, in, out, m_rows, k_depth, n_cols, n_chunks, strip, wgmma, stream
    "tbt_kron_blocked": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
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
    # x, y, n, vector, chunk, depth, stream
    "tbt_map2_inplace": [_P, _P, _L, _I, _I, _I, _P],
    # a, x, y, m, n, rows, unroll, lanes, vector, blocks, stream
    "tbt_matvec_rm": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # a_cm, x, y, ws, n_rows, m_cols, splits, unroll, stream
    "tbt_matvec_cm": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, n, bias, tok, tok0, sink, stream
    "tbt_stream_read": [_P, _L, _P, _P, _L, _P, _P],
    # out, n, seed, vector, stream
    "tbt_stream_fill": [_P, _L, _P, _I, _P],
    # out, x, y, c, n, op, chunk, depth, stream
    "tbt_stream_map": [_P, _P, _P, _P, _L, _I, _I, _I, _P],
    # x, n, bias, out, m, shift, stream
    "tbt_stream_expand": [_P, _L, _P, _P, _I, _I, _P],
}


# The kernels built for bf16 as well (entries tbt_<name>_bf16): K1-K5,
# bf16 storage with f32 sums.  The others refuse bf16 (check_operands).
BF16_KERNELS = ("qp_fused3d", "kron_blocked", "em_gemm", "qp_stage2_3d",
                "qp1d_fused3d", "qp1d_fused2d")
SUFFIXES = {torch.float32: "f32", torch.float64: "f64",
            torch.bfloat16: "bf16"}


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


def _timed(cmd: list[str]) -> tuple[subprocess.CompletedProcess, float]:
    """(cmd run to its end, its output and errors in one text, its
    seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    return proc, time.perf_counter() - t0


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.

    The compilers' output (with ptxas's register and spill counts) is kept
    in `_build/build.log`, and after it a line of each source's nvcc
    seconds (`time: <source> nvcc <s> s`) and the link's (`time: link <s>
    s`)."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    compiles, link = nvcc_commands(tmp)
    # one thread a compile, each waiting on its own nvcc process
    with concurrent.futures.ThreadPoolExecutor(len(compiles)) as pool:
        done = list(pool.map(_timed, compiles))
    outputs = [proc.stdout for proc, _ in done]
    times = [f"time: {src.name} nvcc {seconds:.3f} s\n"
             for src, (_, seconds) in zip(sources(), done)]
    failed = [(proc.returncode, proc.stdout) for proc, _ in done
              if proc.returncode != 0]
    if not failed:
        proc, seconds = _timed(link)
        outputs.append(proc.stdout)
        times.append(f"time: link {seconds:.3f} s\n")
        if proc.returncode != 0:
            failed.append((proc.returncode, proc.stdout))
    (BUILD_DIR / "build.log").write_text("".join(outputs + times))
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
        dtypes = ("f32", "f64", "bf16") if name[4:] in BF16_KERNELS else (
            "f32", "f64")
        for dtype in dtypes:
            fn = getattr(lib, f"{name}_{dtype}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    # K1's probe form: K1's arguments, then the probe's buffer, the
    # launch's number and the block records the buffer holds; the stream
    for dtype in ("f32", "f64", "bf16"):
        fn = getattr(lib, f"tbt_qp_fused3d_probe_{dtype}")
        fn.argtypes = [*_SIGNATURES["tbt_qp_fused3d"][:-1], _P, _L, _L, _P]
        fn.restype = ctypes.c_int
    lib.tbt_qp1d_smem.argtypes = [_I, _I, _I, _I, _I]
    lib.tbt_qp1d_smem.restype = _L
    # K1's and K2's shared memory
    lib.tbt_qp_fused3d_smem.argtypes = [_I, _I, _I, _I, _I, _I, _I, _I, _I]
    lib.tbt_qp_fused3d_smem.restype = _L
    lib.tbt_kron_resident_smem.argtypes = [_I, _I, _I, _I]
    lib.tbt_kron_resident_smem.restype = _L
    # K2's and K3's dense configuration in f64: a block's shared memory
    lib.tbt_dense_f64_smem.argtypes = []
    lib.tbt_dense_f64_smem.restype = _L
    # K2's f32 dense body on wgmma: a block's shared memory
    lib.tbt_dense_wgmma_smem.argtypes = []
    lib.tbt_dense_wgmma_smem.restype = _L
    # K3's shared memory; K9's blocks in one wave
    lib.tbt_em_resident_smem.argtypes = [_I, _I, _I, _I]
    lib.tbt_em_resident_smem.restype = _L
    lib.tbt_matvec_cm_blocks.argtypes = [_I, _I]
    lib.tbt_matvec_cm_blocks.restype = ctypes.c_int
    # K4's and K8's blocks in one wave
    lib.tbt_qp_stage2_wave.argtypes = [_I, _I, _I, _I, _I]
    lib.tbt_qp_stage2_wave.restype = ctypes.c_int
    lib.tbt_matvec_rm_wave.argtypes = [_I, _I, _I, _I]
    lib.tbt_matvec_rm_wave.restype = ctypes.c_int
    # K12's and K7's rings: blocks in one wave (or minus a CUDA error)
    lib.tbt_stream_map_wave.argtypes = [_I, _I, _I, _I]
    lib.tbt_stream_map_wave.restype = _L
    lib.tbt_map2_inplace_wave.argtypes = [_I, _I, _I]
    lib.tbt_map2_inplace_wave.restype = _L
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


_FLOATS = (torch.float32, torch.float64)


def check_operands(name: str, tensors, bf16: bool = False) -> None:
    """Raise unless the tensors share one float32 or float64 dtype (or
    bfloat16, where `bf16`: the entries of BF16_KERNELS) and one CPU or
    CUDA device and are contiguous, as every kernel entry needs."""
    x = tensors[0]
    dtype = x.dtype
    if dtype not in _FLOATS and not (bf16 and dtype == torch.bfloat16):
        if dtype == torch.bfloat16:
            raise NotImplementedError(f"{name}: bf16 is not ported yet for "
                                      "benchmarks 01-03 and the ceiling "
                                      "probes (ROADMAP Queue 1 item 2c)")
        raise TypeError(f"{name}: dtype {dtype} is not supported")
    if x.is_cuda:  # the launch path: device indices, not device objects
        index = x.get_device()
        for t in tensors:
            if t.dtype is not dtype:
                raise TypeError(f"{name}: operands must share one dtype")
            if not t.is_cuda or t.get_device() != index:
                raise ValueError(f"{name}: operands must share one device")
            if not t.is_contiguous():
                raise ValueError(f"{name}: operands must be contiguous")
        return
    device = x.device
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: operands must share one dtype")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: operands must share one device")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if device.type != "cpu" and device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")


@functools.cache
def smem_limits(index: int) -> tuple:
    """(shared memory one block may opt in to, an SM's shared memory) of
    CUDA device `index`, read once per device; the H100's where torch does
    not report them."""
    props = torch.cuda.get_device_properties(index)
    return (getattr(props, "shared_memory_per_block_optin", 232448),
            getattr(props, "shared_memory_per_multiprocessor", 233472))


def vector16(n: int, itemsize: int, *ptrs: int) -> bool:
    """Whether rows of n values of `itemsize` bytes are whole 16-byte
    vectors and every pointer lies on a 16-byte boundary: the condition
    for a kernel's 16-byte vector form (K4, K8)."""
    aligned = n * itemsize % 16 == 0
    for p in ptrs:
        aligned = aligned and p % 16 == 0
    return aligned


@functools.cache
def entry(name: str, dtype: torch.dtype):
    """The C entry tbt_<name>_f32, _f64 or _bf16 for dtype, looked up in
    the library once per (name, dtype)."""
    return getattr(library(), f"tbt_{name}_{SUFFIXES[dtype]}")


def _current_raw_stream(index: int) -> int:
    return torch.cuda.current_stream(index).cuda_stream


# The current stream of a device as a raw cudaStream_t, without building a
# torch.cuda.Stream object where torch offers that.
raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream",
                     _current_raw_stream)


def _current_device() -> int:
    return torch.cuda.current_device()


# The current CUDA device's index, without torch.cuda.current_device()'s
# lazy-init check where torch offers that (a tensor on the card exists,
# so CUDA is initialized).
current_device = getattr(torch._C, "_cuda_getDevice", _current_device)


def call(fn, x: torch.Tensor, *args) -> int:
    """fn(*args, stream) on the current stream of x's CUDA device, inside
    that device's context only when it is not the current device; returns
    fn's CUDA error code."""
    index = x.get_device()
    if index == current_device():
        return fn(*args, raw_stream(index))
    with torch.cuda.device(index):
        return fn(*args, raw_stream(index))


def key(name: str, dtype: torch.dtype) -> str:
    """The key `launches` counts a launch of kernel `name` in `dtype`
    under: <name>, or <name>_bf16 for a bf16 one."""
    return f"{name}_bf16" if dtype is torch.bfloat16 else name


def run(name: str, x: torch.Tensor, *args) -> None:
    """Launch kernel `name` for x's dtype on x's device and stream:
    tbt_<name>_f32/_f64/_bf16(*args, stream); raise on a CUDA error, else
    count the launch under key(name, x.dtype).  Under the span
    tbt.launch.<that key> while a profiler records (core/spans.py)."""
    dtype = x.dtype
    counted = key(name, dtype)
    if spans.profiler._is_profiler_enabled:
        with spans.span(f"tbt.launch.{counted}"):
            launched(call(entry(name, dtype), x, *args), counted)
        return
    launched(call(entry(name, dtype), x, *args), counted)
