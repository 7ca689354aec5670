"""Package rules of the PyTorch/CUDA port: no JAX import, no silent move to
the CPU, the nvcc build names only the package's own sources for sm_90a,
and (on a CUDA card only) each kernel against its plain version."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_bench_torch.core.config import Config
from tpu_bench_torch.kernels import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import tpu_bench_torch
names = [m.name for m in pkgutil.walk_packages(tpu_bench_torch.__path__,
                                               "tpu_bench_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert len(names) >= 16, names
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print(len(names))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr


def test_cuda_config_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        Config(device="cuda")
    assert Config(device="cpu").device == torch.device("cpu")


def test_bf16_config_names_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 5"):
        Config(dtype=torch.bfloat16, device="cpu")


def test_nvcc_command_builds_package_sources_for_sm90a():
    cmd = build.nvcc_command(Path("/nonexistent/lib.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    sources = [Path(a) for a in cmd if a.endswith((".cu", ".cuh"))]
    assert {p.name for p in sources} == {"bwdtrans2d.cu", "bwdtrans3d.cu"}
    assert all(p.parent == build.CSRC_DIR for p in sources)
    assert build.library_path().parent == build.BUILD_DIR


def test_chip_smoke_alone_fails(tmp_path):
    """Outside a checkout (or without a card) the smoke test exits non-zero
    and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_bench_torch.kernels import bwdtrans2d as k2
    from tpu_bench_torch.kernels import bwdtrans3d as k1

    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device="cuda",
                               dtype=dtype)

        x, b0, c12t, c = rnd(7, 49, 1000), rnd(7, 8), rnd(64, 49), rnd(512, 343)
        before = (k1.launches, k2.launches)
        out = k1.qp_shared3d(x, b0, c12t)
        ref = k1.qp_shared3d_plain(x, b0, c12t)
        assert float((out - ref).abs().max() / ref.abs().max()) <= tol
        xb = rnd(2, 343, 1000)
        out = k2.kron_blocked(xb, c)
        ref = k2.kron_blocked_plain(xb, c)
        assert float((out - ref).abs().max() / ref.abs().max()) <= tol
        assert (k1.launches, k2.launches) == (before[0] + 1, before[1] + 1)
