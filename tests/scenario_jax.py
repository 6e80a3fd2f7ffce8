"""Stepping a shipped scenario in both packages from the JAX package's own
state (the step tests of ``tests/test_torch_scenario_step*.py``), and the
one-thread fixture of the scenario tests (which import JAX; this module
is not for the card's machine).

Both packages build the scenario from the same TOML (their bundles are equal
array for array, ``tests/test_torch_scenario_build.py``).  At every step the
port steps once from the JAX package's state (and fleet state), and its
result is held against the JAX package's step: the one-step error, which
no earlier difference can amplify.
"""
import dataclasses
import os

import numpy as np
import jax
import pytest
import torch

from carla_social_force_model_tpu.api import scenario as jscenario
from carla_social_force_model_tpu.models import stepper as jstepper
from carla_social_force_model_tpu_torch.api import scenario as pscenario
from carla_social_force_model_tpu_torch.models import stepper
from carla_social_force_model_tpu_torch.utils import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
#: one step from the same state: positions (m) and fleet floats
STEP_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op PyTorch thread for the module's tests: their tensors
    are tiny, and the test workers run side by side, so more threads only
    oversubscribe the cores (a golden replay then takes ten times as
    long)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fields_of(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: fields_of(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return np.asarray(obj)


def scenario_paths(scen, sfm=None):
    return (os.path.join(REPO, "configs", "scenarios", f"{scen}.toml"),
            os.path.join(REPO, "configs", sfm or "sfm.toml"))


def step_both(scen, sfm, steps, check):
    """Step ``scen`` ``max(steps)+1`` ticks in the JAX package; at each
    tick in ``steps`` also step the port once from the JAX state and call
    ``check(t, port_state, jax_state, port_fleet, jax_fleet)``.  Returns
    the number of ticks checked."""
    path, sfm_path = scenario_paths(scen, sfm)
    horizon = max(steps) + 1
    jb = jscenario.build_scenario(path, sfm_path, horizon)
    pb = pscenario.build_scenario(path, sfm_path, horizon, device=CPU)
    js = jstepper.prepare_scene(jb.scene, analytic=jb.cfg.env_analytic,
                                orca=jb.params.enable_orca)
    ps = stepper.prepare_scene(pb.scene, analytic=pb.cfg.env_analytic,
                               orca=pb.params.enable_orca,
                               chunked=pb.cfg.env_chunked)
    fleet = js.autopilot is not None

    @jax.jit
    def jstep(st, ap, t):
        out, _ = jstepper.rollout(st, js, jb.params, jb.cfg, 1, record=False,
                                  start_step=t, autopilot_state=ap,
                                  return_autopilot_state=fleet)
        return out if fleet else (out, None)

    jst = jb.initial_state
    jap = js.autopilot.initial_state() if fleet else None
    checked = 0
    for t in range(horizon):
        nxt, nap = jstep(jst, jap, t)
        if t in steps:
            pst = convert.ped_state_from_fields(fields_of(jst), CPU)
            if fleet:
                pap = convert.autopilot_state_from_fields(fields_of(jap),
                                                          CPU)
                got, gap, _ = stepper.fleet_tick(pst, pap, ps, pb.params,
                                                 pb.cfg, t)
            else:
                got, _ = stepper.simulation_step(pst, ps, pb.params, pb.cfg,
                                                 t)
                gap = None
            check(t, got, nxt, gap, nap)
            checked += 1
        jst, jap = nxt, nap
    return checked


def assert_step_close(t, got, want, gap, wap):
    """Positions within STEP_TOL, modes and alive equal; the fleet's flags
    and waypoint indices equal and its floats within STEP_TOL."""
    w = fields_of(want)
    np.testing.assert_array_equal(got.alive.numpy(), w["alive"],
                                  err_msg=f"alive, step {t}")
    np.testing.assert_array_equal(got.mode.numpy(), w["mode"],
                                  err_msg=f"mode, step {t}")
    for name in ("pos_x", "pos_y"):
        err = np.abs(getattr(got, name).numpy() - w[name])
        assert err.max(initial=0.0) <= STEP_TOL, (t, name, err.max())
    if gap is None:
        return
    wf = fields_of(wap)
    for f in dataclasses.fields(gap):
        g = getattr(gap, f.name).numpy()
        if g.dtype.kind == "f":
            err = np.abs(g - wf[f.name])
            assert err.max(initial=0.0) <= STEP_TOL, (t, f.name, err.max())
        else:
            np.testing.assert_array_equal(g, wf[f.name],
                                          err_msg=f"fleet {f.name}, step {t}")


__all__ = ["STEP_TOL", "assert_step_close", "one_torch_thread", "step_both"]
