"""PyTorch port: package boundary and the no-fallback contract.

The port imports no JAX; its CUDA module imports on a host without nvcc or
a card (the kernels build at their first launch); ``chip_smoke.py`` refuses
to run without a card.
"""
import importlib
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import carla_social_force_model_tpu_torch as port

ROOT = Path(__file__).resolve().parent.parent


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, prefix=port.__name__ + "."))


def run_python(code, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_without_jax():
    """Every module of the port imports with ``jax`` made unimportable."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        f"for name in {port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'carla_social_force_model_tpu' or "
        "m.startswith('carla_social_force_model_tpu.') for m in sys.modules)\n"
        "print('ok')\n")
    proc = run_python(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_sources_never_import_jax():
    for path in (ROOT / "carla_social_force_model_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words and words[0] in ("import", "from") and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "jaxlib",
                                   "carla_social_force_model_tpu"), path


def test_cuda_module_imports_without_nvcc():
    """ops/cuda_forces.py and utils/cuda_build.py import with no nvcc on
    PATH and no CUDA_HOME; the CPU path then runs without building."""
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME="/nonexistent")
    code = (
        "import torch\n"
        "from carla_social_force_model_tpu_torch.ops import cuda_forces\n"
        "from carla_social_force_model_tpu_torch.utils import cuda_build\n"
        "from carla_social_force_model_tpu_torch.models.params import "
        "MoussaidParams\n"
        "z = torch.zeros(3)\n"
        "fx, fy = cuda_forces.pedestrian_force_kernel(\n"
        "    z, z + torch.arange(3.0), z, z, z, torch.ones(3, dtype=bool),\n"
        "    MoussaidParams())\n"
        "assert fx.shape == (3,) and torch.isfinite(fy).all()\n"
        "print('ok')\n")
    proc = run_python(code, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    from carla_social_force_model_tpu_torch.utils import cuda_build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this host has nvcc under /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()


def test_kernel_sources_are_packaged():
    srcs = [p.name for p in
            importlib.import_module(
                "carla_social_force_model_tpu_torch.utils.cuda_build").sources()]
    assert srcs == ["pair_forces.cu", "pair_forces.cuh"]
    pyproject = (ROOT / "pyproject.toml").read_text()
    assert "csrc/*.cu" in pyproject and "csrc/*.cuh" in pyproject


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No card (or no repository beside it): non-zero exit, no result."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    if alone:
        (tmp_path / "chip_smoke.py").write_text(
            (ROOT / "chip_smoke.py").read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        script, cwd = ROOT / "chip_smoke.py", ROOT
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_public_names():
    assert port.SfmParams is importlib.import_module(
        "carla_social_force_model_tpu_torch.models.params").SfmParams
    assert port.modes.CROSSING_ROAD == 2
    state = port.PedState.empty(4)
    assert state.capacity == 4 and state.pos.shape == (4, 2)
    assert state.mode.dtype == torch.int32 and not state.alive.any()
