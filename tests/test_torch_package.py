"""PyTorch port: package boundary and the no-fallback contract.

The port imports no JAX; its CUDA module imports on a host without nvcc or
a card (the kernels build at their first launch); ``chip_smoke.py`` refuses
to run without a card.
"""
import ctypes
import importlib
import inspect
import os
import pkgutil
import re
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
    """No module of the port, and not chip_smoke.py, imports JAX or the
    JAX package (at any indentation)."""
    paths = [*(ROOT / "carla_social_force_model_tpu_torch").rglob("*.py"),
             ROOT / "chip_smoke.py"]
    for path in paths:
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
    assert srcs == ["env_forces.cu", "pair_forces.cu", "statics.cu",
                    "block_box.cuh", "env_forces.cuh", "pair_forces.cuh",
                    "statics.cuh"]
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
    state = port.PedState.empty(4, device="cpu")
    assert state.capacity == 4 and state.pos.shape == (4, 2)
    assert state.mode.dtype == torch.int32 and not state.alive.any()


def _c_entries():
    """Each ``sfm_*`` entry of the extern "C" blocks in csrc/*.cu, with the
    ctypes type of each parameter as its C declaration gives it."""
    entries = {}
    for path in sorted((ROOT / "carla_social_force_model_tpu_torch"
                        / "csrc").glob("*.cu")):
        text = path.read_text()
        for name, params in re.findall(r"\bint (sfm_\w+)\(([^)]*)\)\s*\{",
                                       text):
            types = []
            for decl in params.split(","):
                decl = " ".join(decl.split())
                types.append(ctypes.c_void_p if "*" in decl
                             else ctypes.c_float if decl.startswith("float")
                             else ctypes.c_int)
            entries[name] = types
    return entries


def test_declared_argtypes_match_the_c_entries():
    """utils/cuda_build.ARGTYPES declares every C entry with the types of
    its C signature (ctypes would cut a pointer declared as an int)."""
    from carla_social_force_model_tpu_torch.utils import cuda_build
    entries = _c_entries()
    assert sorted(entries) == sorted(cuda_build.ARGTYPES)
    for name, types in entries.items():
        assert cuda_build.ARGTYPES[name] == types, name


def _entry_points():
    from carla_social_force_model_tpu_torch.api import scenario, synthetic
    from carla_social_force_model_tpu_torch.api.simulation import Simulation
    from carla_social_force_model_tpu_torch.env.borders import (
        build_border_set)
    from carla_social_force_model_tpu_torch.env.pointsets import (
        analytic_split, build_static_features, chunked_on, segment_major)
    from carla_social_force_model_tpu_torch.models import (autopilot, groups,
                                                           routes, spawn,
                                                           vehicles)
    import numpy as np
    spec = vehicles.VehicleSpec(trajectory=np.zeros((3, 2)),
                                headings=np.zeros(3), speeds=np.ones(3))
    ap_spec = autopilot.AutopilotSpec(waypoints=np.array([[0.0, 0.0],
                                                          [10.0, 0.0]]))
    borders = build_border_set([np.zeros((3, 2))], [np.zeros(2)], [1.0])
    walker = spawn.SpawnerSpec(spawn_location=np.zeros(2),
                               waypoints=np.ones((1, 2)),
                               crossing_road=[False])
    toml = str(ROOT / "configs" / "scenarios" / "road_crossing.toml")
    return {
        "synthetic_crowd": (synthetic.synthetic_crowd, (4,)),
        "benchmark_bundle": (synthetic.benchmark_bundle, (4,)),
        "synthetic_vehicles": (synthetic.synthetic_vehicles,
                               (10.0, 2, 0.05, 5)),
        "PedState.empty": (port.PedState.empty, (4,)),
        "build_route_buffer": (routes.build_route_buffer,
                               ([np.zeros((2, 2))], [[False, True]])),
        "build_vehicle_states": (vehicles.build_vehicle_states,
                                 ([spec], 0.05, 5)),
        "segment_major": (segment_major, (borders,)),
        "analytic_split": (analytic_split, (borders,)),
        "build_static_features": (build_static_features, (borders,)),
        "urban_bundle": (synthetic.urban_bundle,
                         (8,), dict(num_steps_hint=4, n_routes=2, n_roads=2,
                                    width=100.0, cross_spacing=40.0)),
        "build_autopilot_fleet": (autopilot.build_autopilot_fleet,
                                  ([ap_spec], 0.05, 5)),
        "build_groups": (groups.build_groups, ([0, 0, -1, 1, 1],)),
        "chunked_on": (chunked_on, (borders,)),
        "build_spawn_schedule": (spawn.build_spawn_schedule,
                                 ([walker], 0.05, 5)),
        "build_scenario": (scenario.build_scenario, (toml, {}, 5)),
        "Simulation.from_config": (Simulation.from_config, (toml, {}),
                                   dict(num_steps=5)),
    }


@pytest.mark.parametrize("name", ["synthetic_crowd", "benchmark_bundle",
                                  "synthetic_vehicles", "PedState.empty",
                                  "build_route_buffer", "build_vehicle_states",
                                  "segment_major", "analytic_split",
                                  "build_static_features", "urban_bundle",
                                  "build_autopilot_fleet", "build_groups",
                                  "chunked_on", "build_spawn_schedule",
                                  "build_scenario", "Simulation.from_config"])
def test_entry_points_default_to_the_card(name, monkeypatch):
    """Every entry point that takes a device defaults to CUDA: without a
    card it raises (no fallback to the CPU), and ``device="cpu"`` runs."""
    fn, args, *kw = _entry_points()[name]
    kw = kw[0] if kw else {}
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert fn(*args, device="cpu", **kw) is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        fn(*args, **kw)
