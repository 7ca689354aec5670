"""Build the port's CUDA kernels and bind them with ctypes.

Every `*.cu` under `tpu_bench_torch/csrc/` is compiled by one nvcc call for
Hopper (`sm_90a`) into a shared library with a plain C interface, kept in
`tpu_bench_torch/_build/` under a name that carries a hash of the sources
and flags, so an edited source rebuilds on next use.  Nothing is built or
loaded at import: `library()` does both on the first kernel launch.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem, epb, stream
    "tbt_qp_fused3d_f32": [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_longlong,
                           _I, _P],
    "tbt_qp_fused3d_f64": [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_longlong,
                           _I, _P],
    # c, in, out, m_rows, k_depth, n_cols, n_chunks, stream
    "tbt_kron_blocked_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "tbt_kron_blocked_f64": [_P, _P, _P, _I, _I, _I, _I, _P],
}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "nvcc")


def nvcc_command(output: Path) -> list[str]:
    """The one nvcc invocation that builds every kernel into `output`."""
    return [nvcc(), *NVCC_FLAGS, "-o", str(output), *map(str, sources())]


def library_path() -> Path:
    digest = hashlib.sha256()
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtpubench_torch_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.

    The compiler's output (with ptxas's register and spill counts) is kept
    in `_build/build.log`."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(nvcc_command(tmp), capture_output=True, text=True)
    (BUILD_DIR / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tbt_error_string.argtypes = [ctypes.c_int]
    lib.tbt_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a kernel's launch returned a CUDA error code."""
    if err != 0:
        msg = library().tbt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
