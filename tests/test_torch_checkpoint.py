"""PyTorch port: checkpoints and segmented rollouts (utils/checkpoint.py),
on the CPU.

A segmented rollout equals one rollout and resumes from any of its
checkpoints (with a reactive fleet too); the npz files carry the JAX
package's keys, so a checkpoint written by either package resumes in the
other (within 1e-4 m, modes and alive masks equal), and the JAX package's
two older layouts load.  The orbax backend is refused.
"""
import glob
import os

import numpy as np
import pytest
import torch

from scenario_jax import one_torch_thread  # noqa: F401
from carla_social_force_model_tpu.api.simulation import Simulation as JSim
from carla_social_force_model_tpu.utils import checkpoint as jckpt
from carla_social_force_model_tpu_torch.api import cli
from carla_social_force_model_tpu_torch.api.simulation import Simulation
from carla_social_force_model_tpu_torch.api.synthetic import benchmark_bundle
from carla_social_force_model_tpu_torch.models.autopilot import AutopilotState
from carla_social_force_model_tpu_torch.models.state import PedState
from carla_social_force_model_tpu_torch.models.stepper import make_rollout_fn
from carla_social_force_model_tpu_torch.utils import csvout
from carla_social_force_model_tpu_torch.utils.checkpoint import (
    latest_checkpoint, load_state, run_segmented, save_state)

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCEN = os.path.join(REPO, "configs", "scenarios")
SFM = os.path.join(REPO, "configs", "sfm.toml")
TOL_M = 1e-4


def equal_states(a, b):
    for f in a.__dataclass_fields__:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_segmented_rollout_bit_equal_and_resumable(tmp_path):
    scene, params, cfg, state = benchmark_bundle(24, extent=12.0, device=CPU)
    final, recs = make_rollout_fn(scene, params, cfg, 60)(state)
    ckpt_dir = str(tmp_path / "ckpts")
    final_seg, recs_seg = run_segmented(state, scene, params, cfg, 60,
                                        segment_steps=17,
                                        checkpoint_dir=ckpt_dir)
    equal_states(final, final_seg)
    for a, b in zip(recs, recs_seg):
        assert torch.equal(a, b)
    assert sorted(os.listdir(ckpt_dir)) == [
        f"ckpt_{s:08d}.npz" for s in (17, 34, 51, 60)]
    mid, step = load_state(os.path.join(ckpt_dir, "ckpt_00000034.npz"),
                           device=CPU)
    assert step == 34
    resumed, none = run_segmented(mid, scene, params, cfg, 60 - step,
                                  segment_steps=100, start_step=step,
                                  record=False)
    assert none is None
    equal_states(final, resumed)
    assert latest_checkpoint(ckpt_dir).endswith("ckpt_00000060.npz")


def fleet_bundle(steps, jax=False):
    toml = os.path.join(SCEN, "destination_vehicle.toml")
    if jax:
        return JSim.from_config(toml, SFM, num_steps=steps).bundle
    return Simulation.from_config(toml, SFM, num_steps=steps,
                                  device=CPU).bundle


def test_segmented_autopilot_fleet_resume(tmp_path):
    """The AutopilotState rides in the snapshot: a resumed fleet continues
    mid-route, bitwise; resuming without it is refused."""
    b = fleet_bundle(80)
    assert b.scene.autopilot is not None
    full, (recs, veh) = run_segmented(b.initial_state, b.scene, b.params,
                                      b.cfg, 80, segment_steps=80)
    ckpt_dir = str(tmp_path / "ckpts")
    seg, (recs_s, veh_s) = run_segmented(b.initial_state, b.scene, b.params,
                                         b.cfg, 80, segment_steps=30,
                                         checkpoint_dir=ckpt_dir)
    equal_states(full, seg)
    for a, c in zip(recs + veh, recs_s + veh_s):
        assert torch.equal(a, c)
    mid, step, ap = load_state(os.path.join(ckpt_dir, "ckpt_00000060.npz"),
                               with_autopilot=True, device=CPU)
    assert step == 60 and isinstance(ap, AutopilotState)
    resumed, (rest, rest_veh) = run_segmented(
        mid, b.scene, b.params, b.cfg, 20, segment_steps=1000,
        start_step=step, autopilot_state=ap)
    equal_states(full, resumed)
    assert torch.equal(rest.pos, recs.pos[60:])
    assert torch.equal(rest_veh.pos, veh.pos[60:])
    with pytest.raises(ValueError, match="autopilot_state"):
        run_segmented(mid, b.scene, b.params, b.cfg, 10, segment_steps=10,
                      start_step=step, record=False)


def test_save_load_roundtrip(tmp_path):
    rng = np.random.default_rng(5)
    state = PedState.empty(7, device=CPU)
    state = type(state)(**{
        f: (torch.from_numpy(rng.uniform(-5, 5, 7).astype(np.float32))
            if getattr(state, f).dtype == torch.float32 else getattr(state, f))
        for f in state.__dataclass_fields__})
    p = save_state(str(tmp_path / "sub" / "s.npz"), state, 123)
    loaded, step = load_state(p, device=CPU)
    assert step == 123
    equal_states(state, loaded)
    with np.load(p) as data:
        assert sorted(data.files) == sorted(
            ["step"] + [f"state__{f}" for f in state.__dataclass_fields__])


def cross_states(got, want):
    """A port PedState against a JAX one: alive masks and modes equal,
    alive positions within TOL_M."""
    alive = got.alive.numpy()
    np.testing.assert_array_equal(alive, np.asarray(want.alive))
    np.testing.assert_array_equal(got.mode.numpy(), np.asarray(want.mode))
    for a, b in ((got.pos_x, want.pos_x), (got.pos_y, want.pos_y)):
        err = np.abs(a.numpy() - np.asarray(b))[alive]
        assert err.max(initial=0.0) < TOL_M


def test_checkpoints_resume_across_packages(tmp_path):
    """A JAX-written checkpoint (with its fleet) resumes in the port, and a
    port-written one in the JAX package: each resumed run lands within
    1e-4 m of the other package's straight run, modes and alive equal."""
    steps, mid = 80, 40
    jb, pb = fleet_bundle(steps, jax=True), fleet_bundle(steps)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jfinal, _ = jckpt.run_segmented(jb.initial_state, jb.scene, jb.params,
                                    jb.cfg, steps, segment_steps=mid,
                                    checkpoint_dir=jdir, record=False)
    pfinal, _ = run_segmented(pb.initial_state, pb.scene, pb.params, pb.cfg,
                              steps, segment_steps=mid, checkpoint_dir=pdir,
                              record=False)
    name = f"ckpt_{mid:08d}.npz"

    state, step, ap = load_state(os.path.join(jdir, name),
                                 with_autopilot=True, device=CPU)
    assert step == mid and ap is not None
    got, _ = run_segmented(state, pb.scene, pb.params, pb.cfg, steps - mid,
                           segment_steps=steps, start_step=mid,
                           autopilot_state=ap, record=False)
    cross_states(got, jfinal)

    jstate, jstep, jap = jckpt.load_state(os.path.join(pdir, name),
                                          with_autopilot=True)
    assert jstep == mid and jap is not None
    want, _ = jckpt.run_segmented(jstate, jb.scene, jb.params, jb.cfg,
                                  steps - mid, segment_steps=steps,
                                  start_step=mid, autopilot_state=jap,
                                  record=False)
    cross_states(pfinal, want)
    # the two packages' files hold the same keys
    with np.load(os.path.join(jdir, name)) as a, \
            np.load(os.path.join(pdir, name)) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k


def test_load_pre_planar_checkpoint(tmp_path):
    """A snapshot from before the planar state (state__pos (N, 2) etc.)
    migrates into the x/y planes, as in the JAX package."""
    rng = np.random.default_rng(3)
    n = 9
    payload = {
        "state__pos": rng.uniform(-5, 5, (n, 2)).astype(np.float32),
        "state__vel": rng.uniform(-1, 1, (n, 2)).astype(np.float32),
        "state__waypoint": rng.uniform(-5, 5, (n, 2)).astype(np.float32),
        "state__radius": np.full((n,), 0.3, np.float32),
        "state__base_speed": np.full((n,), 1.2, np.float32),
        "state__crossing_speed": np.full((n,), 1.8, np.float32),
        "state__safety_margin": np.full((n,), 1.5, np.float32),
        "state__fsm_target": np.full((n,), 1.2, np.float32),
        "state__applied_target": np.full((n,), 1.2, np.float32),
        "state__mode": np.ones((n,), np.int32),
        "state__next_mode_time": np.full((n,), -1.0, np.float32),
        "state__waypoint_idx": np.zeros((n,), np.int32),
        "state__alive": np.ones((n,), bool),
        "state__spawned": np.ones((n,), bool),
        "step": np.asarray(77, np.int64),
    }
    p = str(tmp_path / "old.npz")
    np.savez_compressed(p, **payload)
    state, step = load_state(p, device=CPU)
    jstate, _ = jckpt.load_state(p)
    assert step == 77
    np.testing.assert_array_equal(state.pos.numpy(), payload["state__pos"])
    np.testing.assert_array_equal(state.waypoint.numpy(),
                                  payload["state__waypoint"])
    for f in state.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(state, f).numpy(),
                                      np.asarray(getattr(jstate, f)), f)


def test_load_pre_overtaking_fleet_checkpoint(tmp_path):
    """A fleet snapshot from before the overtaking fields restores
    lane_off and overtaking at rest."""
    state = PedState.empty(6, device=CPU)
    ap = AutopilotState(
        pos=torch.zeros((2, 2)), heading=torch.zeros(2),
        speed=torch.tensor([3.0, 0.0]),
        wp_idx=torch.ones(2, dtype=torch.int32),
        active=torch.tensor([True, False]), lane_off=torch.ones(2),
        overtaking=torch.ones(2, dtype=torch.bool))
    p = save_state(str(tmp_path / "ck.npz"), state, 12, autopilot=ap)
    data = dict(np.load(p))
    del data["ap__lane_off"], data["ap__overtaking"]
    np.savez_compressed(p, **data)
    _, step, ap2 = load_state(p, with_autopilot=True, device=CPU)
    assert step == 12
    assert torch.equal(ap2.speed, ap.speed)
    assert ap2.lane_off.dtype == torch.float32 and not ap2.lane_off.any()
    assert ap2.overtaking.dtype == torch.bool and not ap2.overtaking.any()
    _, _, none = load_state(save_state(str(tmp_path / "p.npz"), state, 1),
                            with_autopilot=True, device=CPU)
    assert none is None


def test_orbax_backend_refused(tmp_path):
    """The JAX package's orbax backend is refused by name wherever it
    could enter: a path, the backend argument, the newest snapshot."""
    state = PedState.empty(3, device=CPU)
    scene, params, cfg, s0 = benchmark_bundle(4, device=CPU)
    with pytest.raises(ValueError, match="orbax"):
        save_state(str(tmp_path / "ckpt_00000001.orbax"), state, 1)
    with pytest.raises(ValueError, match="orbax"):
        load_state(str(tmp_path / "ckpt_00000001.orbax"), device=CPU)
    with pytest.raises(ValueError, match="orbax"):
        run_segmented(s0, scene, params, cfg, 2, 1, backend="orbax")
    save_state(str(tmp_path / "ckpt_00000001.npz"), state, 1)
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt_00000001.npz")
    os.makedirs(tmp_path / "ckpt_00000002.orbax")
    with pytest.raises(ValueError, match="orbax"):
        latest_checkpoint(str(tmp_path))
    assert latest_checkpoint(str(tmp_path / "none")) is None


def test_load_state_defaults_to_the_card(tmp_path, monkeypatch):
    import inspect
    assert inspect.signature(load_state).parameters["device"].default \
        == "cuda"
    p = save_state(str(tmp_path / "s.npz"), PedState.empty(2, device=CPU), 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        load_state(p)


def test_cli_checkpoints_with_a_fleet(tmp_path, monkeypatch):
    """The CLI on a reactive-fleet scenario: 60 steps straight, and the
    same horizon stopped after its step-30 snapshot and resumed with
    --resume: the resumed steps equal the straight run's, walkers and
    vehicles."""
    monkeypatch.chdir(tmp_path)
    base = ["--scenario-config",
            os.path.join(SCEN, "destination_vehicle.toml"), "--sfm-config",
            SFM, "--steps", "60", "--platform", "cpu", "--csv"]
    assert cli.main(base + ["--output", "straight"]) == 0
    assert cli.main(base + ["--output", "first", "--checkpoint-dir", "ck",
                            "--checkpoint-every", "30"]) == 0
    os.remove(os.path.join("ck", "ckpt_00000060.npz"))
    assert cli.main(base + ["--output", "resumed", "--checkpoint-dir", "ck",
                            "--checkpoint-every", "30", "--resume"]) == 0

    def run(out):
        (d,) = glob.glob(os.path.join(out, "*"))
        rec, _ = csvout.read_pedestrian_csv(os.path.join(d, "pedestrian.csv"),
                                            capacity=2)
        with open(os.path.join(d, "vehicle.csv")) as f:
            veh = f.read().splitlines()
        return rec, veh
    straight, sveh = run("straight")
    resumed, rveh = run("resumed")
    n = resumed.pos.shape[0]
    assert n == 30
    for a, b in zip(resumed, straight):
        assert torch.equal(a, b[30:])
    # the resumed run's vehicle rows are the straight run's from step 30
    # (its frames and times count from 0)
    later = [r.split(",") for r in sveh[1:] if int(r.split(",")[1]) >= 30]
    assert [r.split(",")[3:] for r in rveh[1:]] == \
        [r[3:] for r in later][:len(rveh) - 1]
    assert len(rveh) > 1
