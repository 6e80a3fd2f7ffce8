"""PyTorch port: social groups under a batch of crowds (ROADMAP item 19b.3a)
against the JAX package.

Under the JAX package's vmap the member table ``scene.groups`` is shared
by every row (an ensemble's schedules and a sweep's params are what is
batched), so every crowd's group force gathers its own members' planes
through the one ``(G, M)`` table.  The port gathers ``(B, G, M)`` planes
and scatters each crowd's forces into its own row (``models/groups.py``).

Tolerances.  ``group_force`` on ``(B, N)`` planes against ``jax.vmap`` of
the JAX function: 1e-5 (a product of a few roots and an atan2), and each
row against the port's function on that row alone bitwise.  Step by step
from the JAX package's own vmapped state (the helper of
``tests/test_torch_ensemble_fleet.py``): positions within 1e-4 m, modes
and alive equal.  Every row of a batched rollout equals the unbatched
rollout bitwise.  Groups on the 2-D mesh are in
``tests/test_torch_ensemble_sharded.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ensemble import fields_of, port_of
from test_torch_ensemble_fleet import (fleet_step_by_step, scenario_bundles)
from test_torch_ensemble_orca import params_row, row_spawn
from carla_social_force_model_tpu.api import synthetic as jsyn
from carla_social_force_model_tpu.models import groups as jgroups
from carla_social_force_model_tpu.models.params import (
    GroupParams as JaxGroupParams)
from carla_social_force_model_tpu.parallel import sweeps as jsweeps
from carla_social_force_model_tpu_torch.models import groups, stepper
from carla_social_force_model_tpu_torch.models.params import (
    GroupParams, param_batch, section_rows)
from carla_social_force_model_tpu_torch.models.state import PedState
from carla_social_force_model_tpu_torch.parallel import sweeps
from carla_social_force_model_tpu_torch.utils import convert

CPU = "cpu"
B, N = 3, 32
#: a sweep of the group force over three rows (float32 values)
GROUP_SWEEP = dict(group_beta_vis=[1.0, 4.0, 0.5],
                   group_beta_att=[0.5, 1.0, 3.0],
                   group_rep_distance=[0.4, 0.8, 1.2])


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Tiny tensors, and the test workers run side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def group_ids(n):
    """Groups of four over the first half of the slots, the rest alone."""
    return np.where(np.arange(n) < n // 2, np.arange(n) // 4, -1)


def jax_grouped(b=B, n=N):
    """A JAX ensemble of ``b`` synthetic crowds of ``n`` (config #1 on a
    10 m square) with groups of four over half of every crowd, one member
    table: ``(scene, params, cfg)`` on the jnp path."""
    scene, params, cfg, _ = jsyn.benchmark_bundle(n, extent=10.0,
                                                  use_pallas=False)
    scene = dataclasses.replace(
        scene, spawn=jsyn.batched_crowds(b, n, extent=10.0),
        groups=jgroups.build_groups(group_ids(n), max_members=4))
    return scene, dataclasses.replace(params, enable_group=True), cfg


def group_planes(b, n, seed):
    """Seeded ``(B, n)`` planes of tight crowds (members a few metres
    apart, some dead), unit desired directions."""
    rng = np.random.default_rng(seed)
    px, py = (rng.uniform(-3.0, 3.0, (b, n)).astype(np.float32)
              for _ in range(2))
    vx, vy = (rng.uniform(-1.5, 1.5, (b, n)).astype(np.float32)
              for _ in range(2))
    ang = rng.uniform(-np.pi, np.pi, (b, n))
    ex, ey = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    ex[:, 3] = ey[:, 3] = 0.0                   # a zero gaze
    alive = rng.uniform(size=(b, n)) < 0.85
    return px, py, vx, vy, ex, ey, alive


@pytest.mark.parametrize("params", ["shared", "swept"])
def test_batched_group_force_equals_jax_vmap_and_each_row(params):
    """``group_force`` on ``(B, N)`` planes with one member table, shared
    ``GroupParams`` or a sweep's ``(B,)`` leaves, against ``jax.vmap`` of
    the JAX package's function (1e-5), and each row bitwise against the
    port's function on that row alone with its float32 parameters."""
    b, n = 3, 40
    cols = group_planes(b, n, 7)
    ids = group_ids(n)
    ptable = groups.build_groups(ids, max_members=4, device=CPU)
    jtable = jgroups.build_groups(ids, max_members=4)
    if params == "shared":
        pp, jp, jaxes = GroupParams(), JaxGroupParams(), None
        rows = [pp] * b
    else:
        vals = {k.split("_", 1)[1]: np.float32(v)
                for k, v in GROUP_SWEEP.items()}
        pp = dataclasses.replace(GroupParams(), **{
            k: torch.from_numpy(v) for k, v in vals.items()})
        jp = dataclasses.replace(JaxGroupParams(), **{
            k: jnp.asarray(v) for k, v in vals.items()})
        jaxes = dataclasses.replace(JaxGroupParams(), **{
            f.name: (0 if f.name in vals else None)
            for f in dataclasses.fields(JaxGroupParams)})
        rows = section_rows(pp, b)
    got = groups.group_force(*(torch.from_numpy(c) for c in cols), ptable,
                             pp)
    want = jax.vmap(lambda x, y, u, v, e, f, a, p: jgroups.group_force(
        x, y, u, v, e, f, a, jtable, p),
        in_axes=(0,) * 7 + (jaxes,))(*(jnp.asarray(c) for c in cols), jp)
    for g, w in zip(got, want):
        assert g.shape == (b, n)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    assert (got[0] != 0).any(dim=1).all()
    for r in range(b):
        one = groups.group_force(*(torch.from_numpy(c[r]) for c in cols),
                                 ptable, rows[r])
        for g, w in zip(got, one):
            assert torch.equal(g[r], w), r


def test_groups_ensemble_matches_jax_step_by_step(monkeypatch):
    """Three crowds of 32 with groups of four over half of each, stepped
    from the JAX package's vmapped state for 10 steps."""
    js, jp, jc = jax_grouped()
    ps, pp, pc = port_of(js, jp, jc)
    assert ps.groups is not None and pp.enable_group
    _, alive, _ = fleet_step_by_step((js, jp, jc), (ps, pp, pc), "ensemble",
                                     10, monkeypatch)
    assert alive > 0


def test_groups_sweep_matches_jax_step_by_step(monkeypatch):
    """One grouped crowd under a sweep of the group force's gaze,
    attraction and repulsion range over three rows."""
    js, jp, jc = jax_grouped(b=1)
    js = dataclasses.replace(js, spawn=jax.tree_util.tree_map(
        lambda a: a[0], js.spawn))
    swept = jsweeps.batch_params(jp, **GROUP_SWEEP)
    ps, _, pc = port_of(js, jp, jc)
    pswept = convert.params_from_fields(fields_of(swept))
    assert param_batch(pswept) == 3
    _, alive, _ = fleet_step_by_step((js, swept, jc), (ps, pswept, pc),
                                     "sweep", 10, monkeypatch)
    assert alive > 0


def test_grouped_crossing_sweep_matches_jax_step_by_step(monkeypatch):
    """The shipped ``grouped_crossing`` scenario with ``sfm_groups.toml``
    (refused under a batch for its groups), swept over two rows of the
    pedestrian force and the group attraction on the scenarios' engine,
    stepped from the JAX package's vmapped state for 40 steps."""
    steps = 40
    jb, pb = scenario_bundles("grouped_crossing", "sfm_groups.toml", steps)
    assert pb.scene.groups is not None and pb.params.enable_group
    swept = jsweeps.batch_params(jb.params, pedestrian_A=[2.0, 4.5],
                                 group_beta_att=[0.5, 2.0])
    pswept = convert.params_from_fields(fields_of(swept))
    _, alive, _ = fleet_step_by_step((jb.scene, swept, jb.cfg),
                                     (pb.scene, pswept, pb.cfg), "sweep",
                                     steps, monkeypatch)
    assert alive > 0


@pytest.mark.parametrize("kind", ["ensemble", "sweep"])
def test_groups_rows_equal_unbatched_rollouts(kind):
    """Row b of a grouped ensemble (or sweep) equals the port's unbatched
    rollout of crowd b (or with row b's parameters) bitwise."""
    steps = 10
    scene, params, cfg = port_of(*jax_grouped())
    if kind == "ensemble":
        final, rec = sweeps.make_ensemble_rollout(scene, params, cfg, steps,
                                                  record=True)(scene)
        b = scene.spawn.step.shape[0]
    else:
        scene = dataclasses.replace(scene, spawn=row_spawn(scene.spawn, 0))
        swept = sweeps.batch_params(params, **GROUP_SWEEP)
        final, rec = sweeps.make_sweep_rollout(scene, cfg, steps,
                                               record=True)(swept)
        b = param_batch(swept)
    n = scene.spawn.capacity
    for row in range(b):
        if kind == "ensemble":
            one, p1 = dataclasses.replace(
                scene, spawn=row_spawn(scene.spawn, row)), params
        else:
            one = scene
            p1 = dataclasses.replace(params_row(params, swept, row),
                                     group=section_rows(swept.group, b)[row])
        f1, r1 = stepper.make_rollout_fn(one, p1, cfg, steps)(
            PedState.empty(n, device=CPU))
        assert torch.equal(rec.pos[row], r1.pos), (kind, row)
        assert torch.equal(rec.mode[row], r1.mode)
        assert torch.equal(final.alive[row], f1.alive)
    assert not torch.equal(rec.pos[0], rec.pos[1])
