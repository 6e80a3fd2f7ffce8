"""PyTorch port: sharded rollouts against the JAX package's.

The JAX package's sharded tick (``simulation_step`` under ``jax.shard_map``
on its 8-device virtual CPU mesh, with the reactive fleet's gathered hazard
check as its ``rollout`` runs it) and the port's (``simulation_step`` /
``fleet_tick`` with ``axis`` on a ``LocalMesh`` of 8) are stepped from the
JAX package's own state at every step: positions within 1e-4 m, modes and
alive equal.  Cases: BASELINE config #1 (N not a multiple of 8, padded by
``prepare_sharded_scene``) with ``gather`` and ``ring`` (and the port's
``ring_kernel``, which runs the plain ring on the CPU), config #1 with a
cutoff (the JAX package's sorted Pallas kernels in interpret mode, its own
sharded schedule), the urban bundle with its fleet, social groups and ORCA.
The port's ``make_sharded_rollout`` is also held to the port's own
one-device rollout.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from carla_social_force_model_tpu.api import synthetic as jsyn
from carla_social_force_model_tpu.models import groups as jgroups
from carla_social_force_model_tpu.models import stepper as jstepper
from carla_social_force_model_tpu.models.autopilot import (
    autopilot_snapshot as j_snapshot, autopilot_step as j_autopilot_step)
from carla_social_force_model_tpu.models.spawn import (
    apply_spawn as j_apply_spawn)
from carla_social_force_model_tpu.models.state import PedState as JPedState
from carla_social_force_model_tpu.parallel import sharding as jsharding
from carla_social_force_model_tpu.parallel.mesh import make_mesh as jmesh
from carla_social_force_model_tpu_torch.api import synthetic as psyn
from carla_social_force_model_tpu_torch.models import groups, stepper
from carla_social_force_model_tpu_torch.models.state import PedState
from carla_social_force_model_tpu_torch.parallel import make_mesh
from carla_social_force_model_tpu_torch.parallel.sharding import (
    make_sharded_rollout, prepare_sharded_scene, shard_of)
from carla_social_force_model_tpu_torch.utils import convert

CPU = torch.device("cpu")
D = 8
POS_TOL_M = 1e-4
URBAN_KW = dict(n_routes=8, n_roads=3, width=200.0, cross_spacing=80.0,
                vehicles_per_road=1)


def fields_of(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: fields_of(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return np.asarray(obj)


def switch_scene(scene, params, switch, jax_side):
    """``groups`` (half the slots in groups of 4) or ``orca`` on a bundle
    of either package (bench.py's switches)."""
    if switch == "orca":
        return scene, dataclasses.replace(params, enable_pedestrian=False,
                                          enable_orca=True)
    cap = scene.spawn.capacity
    gid = np.full(cap, -1, np.int32)
    gid[:cap // 2] = np.arange(cap // 2) // 4
    g = (jgroups.build_groups(gid, max_members=4) if jax_side
         else groups.build_groups(gid, max_members=4, device=CPU))
    return (dataclasses.replace(scene, groups=g),
            dataclasses.replace(params, enable_group=True))


def jax_sharded_step(scene, params, cfg):
    """The JAX package's sharded tick, jitted once: ``step(state, ap, t)``
    -> ``(state, ap)`` (``ap`` None without a fleet)."""
    mesh = jmesh(n_agent_shards=D)
    st_spec = jax.tree_util.tree_map(lambda _: P("agents"), JPedState.empty(1))
    sc_spec = dataclasses.replace(
        jax.tree_util.tree_map(lambda _: P(), scene),
        spawn=jax.tree_util.tree_map(lambda _: P("agents"), scene.spawn))
    fleet = scene.autopilot
    if fleet is None:
        def body(st, sc, t):
            return jstepper.simulation_step(st, sc, params, cfg, t,
                                            axis_name="agents")[0]
        fn = jax.jit(jax.shard_map(body, mesh=mesh,
                                   in_specs=(st_spec, sc_spec, P()),
                                   out_specs=st_spec, check_vma=False))
        return lambda st, ap, t: (fn(st, scene, jnp.int32(t)), None)
    ap_spec = jax.tree_util.tree_map(lambda _: P(), fleet.initial_state())

    def body(st, ap, sc, t):
        # the JAX package's rollout body with a fleet (stepper.py:711-745)
        st = j_apply_spawn(st, sc.spawn, t)
        g = lambda a: jax.lax.all_gather(a, "agents", tiled=True)  # noqa
        ap = j_autopilot_step(sc.autopilot, ap, (g(st.pos_x), g(st.pos_y)),
                              (g(st.vel_x), g(st.vel_y)), g(st.alive), t,
                              cfg.dt)
        snap = j_snapshot(sc.autopilot, ap)
        st, _ = jstepper.simulation_step(st, sc, params, cfg, t,
                                         axis_name="agents", veh_snap=snap)
        return st, ap

    fn = jax.jit(jax.shard_map(body, mesh=mesh,
                               in_specs=(st_spec, ap_spec, sc_spec, P()),
                               out_specs=(st_spec, ap_spec),
                               check_vma=False))
    return lambda st, ap, t: fn(st, ap, scene, jnp.int32(t))


def port_sharded_step(mesh, scene, params, cfg, state, ap, t):
    """The port's sharded tick on ``mesh`` from the global ``state``."""
    scenes = [dataclasses.replace(scene, spawn=shard_of(scene.spawn, d, D))
              for d in range(D)]
    states = [shard_of(state, d, D) for d in range(D)]

    def body(ax, st, sc):
        if scene.autopilot is None:
            return stepper.simulation_step(st, sc, params, cfg, t,
                                           axis=ax)[0], None
        st, new_ap, _ = stepper.fleet_tick(st, ap, sc, params, cfg, t, ax)
        return st, new_ap

    outs = mesh.run(body, states, scenes)
    new = PedState(**{f.name: torch.cat([getattr(o[0], f.name)
                                         for o in outs])
                      for f in dataclasses.fields(PedState)})
    return new, outs[0][1]


def step_by_step(jax_side, port_side, steps, port_comms):
    """Both sharded ticks from the JAX package's own state at every step,
    for each of the port's ``port_comms``; returns the worst position
    error."""
    js, jp, jc, _ = jax_side
    ps, pp, pc = port_side
    n = js.spawn.capacity
    js, cap = jsharding.prepare_sharded_scene(js, D)
    ps, pcap = prepare_sharded_scene(ps, D)
    assert pcap == cap
    js = jstepper.prepare_scene(js, analytic=jc.env_analytic,
                                orca=jp.enable_orca)
    ps = stepper.prepare_scene(ps, orca=pp.enable_orca)
    jstep = jax_sharded_step(js, jp, jc)
    mesh = make_mesh(D, device="cpu")
    jst = JPedState.empty(cap)
    jap = None if js.autopilot is None else js.autopilot.initial_state()
    worst = 0.0
    for k in range(steps):
        pst = convert.ped_state_from_fields(fields_of(jst), CPU)
        pap = (None if jap is None
               else convert.autopilot_state_from_fields(fields_of(jap), CPU))
        results = [port_sharded_step(
            mesh, ps, pp, dataclasses.replace(pc, axis_comm=comm), pst, pap,
            k) for comm in port_comms]
        jst, jap = jstep(jst, jap, k)
        want = fields_of(jst)
        for got, got_ap in results:
            np.testing.assert_array_equal(got.alive.numpy(), want["alive"])
            np.testing.assert_array_equal(got.mode.numpy(), want["mode"])
            for name in ("pos_x", "pos_y"):
                worst = max(worst, float(np.abs(
                    getattr(got, name).numpy() - want[name]).max()))
            if jap is not None:
                np.testing.assert_allclose(got_ap.pos.numpy(),
                                           np.asarray(jap.pos), atol=1e-4)
                np.testing.assert_array_equal(got_ap.active.numpy(),
                                              np.asarray(jap.active))
        assert not want["alive"][n:].any()  # padding slots never spawn
    assert worst <= POS_TOL_M, worst
    return worst


@pytest.mark.parametrize("comm,port_comms", [
    ("gather", ("gather",)), ("ring", ("ring", "ring_kernel"))])
def test_config1_sharded_matches_jax_step_by_step(comm, port_comms):
    """Config #1 at N = 100 (padded to 104), 15 steps, against the JAX
    package's ``gather`` and ``ring``."""
    js, jp, jc, jst = jsyn.benchmark_bundle(100, extent=9.0,
                                            use_pallas=False)
    ps, pp, pc, _ = psyn.benchmark_bundle(100, extent=9.0, device=CPU)
    jc = dataclasses.replace(jc, axis_comm=comm)
    step_by_step((js, jp, jc, jst), (ps, pp, pc), 15, port_comms)


@pytest.mark.parametrize("comm", ["gather", "ring"])
def test_config1_cutoff_sharded_matches_jax_kernels(comm):
    """Config #1 with a 4 m cutoff, 10 steps: each shard sorts its own
    slots; the JAX side runs its sorted Pallas kernels (interpret mode)
    under its own sharded schedule."""
    js, jp, jc, jst = jsyn.benchmark_bundle(64, extent=8.0,
                                            use_pallas=False)
    ps, pp, pc, _ = psyn.benchmark_bundle(64, extent=8.0, device=CPU)
    jc = dataclasses.replace(jc, axis_comm=comm, use_pallas=True,
                             pallas_interpret=True, interaction_cutoff=4.0,
                             pallas_row_tile=8, pallas_col_tile=128,
                             pallas_symmetric=False)
    pc = dataclasses.replace(pc, interaction_cutoff=4.0)
    step_by_step((js, jp, jc, jst), (ps, pp, pc), 10, (comm,))


def test_urban_with_fleet_sharded_matches_jax_step_by_step():
    """The urban bundle (48 walkers, a reactive fleet whose hazard check
    reads the all-gathered walkers on every shard), 20 steps."""
    js, jp, jc, jst = jsyn.urban_bundle(48, num_steps_hint=20,
                                        use_pallas=False, **URBAN_KW)
    ps, pp, pc, _ = psyn.urban_bundle(48, num_steps_hint=20, device=CPU,
                                      **URBAN_KW)
    assert js.autopilot is not None
    step_by_step((js, jp, jc, jst), (ps, pp, pc), 20, ("gather", "ring"))


@pytest.mark.parametrize("switch", ["groups", "orca"])
def test_groups_and_orca_sharded_match_jax_step_by_step(switch):
    """Social groups (the member table's global slots against each shard's
    rows) and ORCA (the all-gathered crowd, its neighbour band across the
    shards: window 64 < N), 12 steps."""
    n = 128 if switch == "orca" else 64
    js, jp, jc, jst = jsyn.benchmark_bundle(n, extent=9.0,
                                            use_pallas=False)
    ps, pp, pc, _ = psyn.benchmark_bundle(n, extent=9.0, device=CPU)
    js, jp = switch_scene(js, jp, switch, True)
    ps, pp = switch_scene(ps, pp, switch, False)
    step_by_step((js, jp, jc, jst), (ps, pp, pc), 12, ("ring",))


@pytest.mark.parametrize("comm", ["gather", "ring", "ring_kernel"])
def test_make_sharded_rollout_matches_one_device(comm):
    """The port's ``make_sharded_rollout`` (global state and record in and
    out) against its own one-device rollout, 20 steps; padding slots stay
    dead."""
    scene, params, cfg, state = psyn.benchmark_bundle(60, extent=8.0,
                                                      device=CPU)
    cfg = dataclasses.replace(cfg, axis_comm=comm)
    final_s, rec_s = stepper.make_rollout_fn(scene, params, cfg, 20)(state)
    sscene, cap = prepare_sharded_scene(scene, D)
    run = make_sharded_rollout(make_mesh(D, device="cpu"), sscene, params,
                               cfg, 20, record=True)
    final_p, rec_p = run(PedState.empty(cap, device=CPU))
    assert torch.equal(rec_p.alive[:, :60], rec_s.alive)
    assert torch.equal(rec_p.mode[:, :60], rec_s.mode)
    assert not final_p.alive[60:].any()
    assert float((rec_p.pos[:, :60] - rec_s.pos).abs().max()) <= POS_TOL_M
    assert float((final_p.pos[:60] - final_s.pos).abs().max()) <= POS_TOL_M
