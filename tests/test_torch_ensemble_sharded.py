"""PyTorch port: ensembles over a 2-D ``(batch, agents)`` mesh (ROADMAP item
19b.4) against the JAX package: the ``gather`` schedule, the mesh argument
of both rollouts, the refusals, and the plain versions of the batched
sharded kernels.

The JAX package runs ``make_sharded_ensemble_rollout`` on
``make_mesh(n_agent_shards=4, n_batch_shards=2)`` over the 8 virtual CPU
devices of ``tests/conftest.py`` (its jnp path, and once its Pallas path in
interpret mode); the port runs it on a ``LocalMesh`` of 2 x 4 virtual
shards on the CPU, where every sharded pair force is its plain version row
by row.  Every recorded position within ``POS_TOL_M`` (the JAX package's
own bound for its 2-D mesh against one device, tests/test_parallel.py:
307-311), alive masks and modes equal.  The ``ring`` schedule (and every
row against the unbatched sharded rollout) is in
``tests/test_torch_ensemble_sharded_ring.py``, ``ring_kernel`` (and the
isolation of the batch rows) in
``tests/test_torch_ensemble_sharded_ring_kernel.py``; the batched sharded
kernels themselves are held on the card (``tests/test_torch_cuda.py``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_social_force_model_tpu.api import synthetic as jsyn
from carla_social_force_model_tpu.parallel import sweeps as jsweeps
from carla_social_force_model_tpu.parallel.mesh import make_mesh as jmesh
from carla_social_force_model_tpu_torch.api import synthetic
from carla_social_force_model_tpu_torch.models import stepper
from carla_social_force_model_tpu_torch.models.groups import build_groups
from carla_social_force_model_tpu_torch.models.state import PedState
from carla_social_force_model_tpu_torch.ops import (cuda_forces, cuda_ring,
                                                    pair_grid)
from carla_social_force_model_tpu_torch.parallel import (LocalMesh,
                                                         make_mesh, sweeps)
from carla_social_force_model_tpu_torch.utils import convert
import shard_cases as sc
from test_torch_ensemble import PALLAS, fields_of, port_of

#: positions, port vs JAX package, at every recorded step [m]
POS_TOL_M = 5e-5
B, N, STEPS = 4, 24, 10
#: a cutoff above every distance in the 12 m crowds (and above the
#: Moussaid law's f32-exact 300 m): the port sorts each shard's slots and
#: runs the cutoff path, the JAX package's jnp path (which ignores the
#: cutoff) sums every pair
WIDE_CUTOFF_M = 400.0
LAW_SWITCHES = {
    "moussaid": {},
    "powerlaw": dict(enable_pedestrian=False, enable_powerlaw=True),
    "helbing": dict(enable_pedestrian=False, enable_ped_repulsive=True),
}


def jax_ensemble(b, n, law="moussaid", geometry=None, extent=12.0):
    """A JAX ensemble of ``b`` synthetic crowds of ``n`` on
    ``benchmark_bundle``'s scene (config #3's borders, parked cars and
    vehicles with ``geometry``), the law switched as bench.py does:
    ``(scene, params, cfg)``."""
    kw = ({} if geometry is None else
          dict(with_borders=True, with_obstacles=True, num_steps_hint=16))
    scene1, params, cfg, _ = jsyn.benchmark_bundle(n, extent=extent, **kw)
    if geometry is not None:
        extent = 25.0  # benchmark_bundle's floor for small n
    scene = dataclasses.replace(scene1, spawn=jsyn.batched_crowds(
        b, n, extent=extent))
    return scene, dataclasses.replace(params, **LAW_SWITCHES[law]), cfg


def jax_sharded(scene, params, cfg, steps=STEPS, n_agents=4, n_batch=2):
    """The JAX package's 2-D mesh rollout: ``(final, record)``."""
    mesh = jmesh(n_agent_shards=n_agents, n_batch_shards=n_batch)
    return jsweeps.make_sharded_ensemble_rollout(mesh, scene, params, cfg,
                                                 steps, record=True)()


def port_sharded(scene, params, cfg, steps=STEPS, n_agents=4, n_batch=2):
    """The port's 2-D mesh rollout of the same inputs on the CPU."""
    mesh = make_mesh(n_agents, n_batch_shards=n_batch, device="cpu")
    return sweeps.make_sharded_ensemble_rollout(mesh, scene, params, cfg,
                                                steps, record=True)()


def assert_close(want, got, label=""):
    """The JAX package's ``(final, record)`` against the port's: shapes
    ``(B, N_padded)``, every recorded position within POS_TOL_M, alive and
    modes equal."""
    (jf, jrec), (pf, prec) = want, got
    assert tuple(pf.pos_x.shape) == np.asarray(jf.pos_x).shape, label
    assert tuple(prec.pos.shape) == np.asarray(jrec.pos).shape, label
    np.testing.assert_array_equal(prec.alive.numpy(), np.asarray(jrec.alive),
                                  err_msg=label)
    np.testing.assert_array_equal(prec.mode.numpy(), np.asarray(jrec.mode),
                                  err_msg=label)
    np.testing.assert_allclose(prec.pos.numpy(), np.asarray(jrec.pos),
                               rtol=0, atol=POS_TOL_M, err_msg=label)
    np.testing.assert_allclose(pf.pos.numpy(), np.asarray(jf.pos), rtol=0,
                               atol=POS_TOL_M, err_msg=label)
    np.testing.assert_array_equal(pf.alive.numpy(), np.asarray(jf.alive),
                                  err_msg=label)


def case_against_jax(comm, law, cutoff, n=N, geometry=None, **cfg_kw):
    """One 2 x 4 mesh rollout, port vs JAX package; returns the port's."""
    scene, params, cfg = jax_ensemble(B, n, law, geometry)
    cfg = dataclasses.replace(cfg, axis_comm=comm, **cfg_kw)
    want = jax_sharded(scene, params, cfg)
    pscene, pparams, pcfg = port_of(scene, params, cfg)
    pcfg = dataclasses.replace(pcfg, interaction_cutoff=cutoff)
    got = port_sharded(pscene, pparams, pcfg)
    assert_close(want, got, f"{comm} {law} cutoff={cutoff} n={n}")
    return got


# -- the gather schedule against the JAX package -----------------------------

@pytest.mark.parametrize("law", sorted(LAW_SWITCHES))
@pytest.mark.parametrize("cutoff,n", [(None, 24), (WIDE_CUTOFF_M, 22)])
def test_gather_matches_the_jax_package(law, cutoff, n):
    """``gather`` on the 2 x 4 mesh, every law, without and with a cutoff
    (22 slots padded to 24: the padding never spawns)."""
    final, _ = case_against_jax("gather", law, cutoff, n)
    assert final.pos_x.shape == (B, 24)
    assert not bool(final.alive[:, n:].any())


def test_config3_geometry_under_gather_matches_the_jax_package():
    """Config #3's borders, parked cars and vehicles under ``gather``: the
    environment terms run on each shard's ``(B, n)`` planes."""
    case_against_jax("gather", "moussaid", None, n=10, geometry="config3")


def test_pallas_cutoff_ring_matches_the_jax_package():
    """The JAX package's Pallas path in interpret mode with its cutoff and
    ``ring`` column communication on the 2-D mesh (tests/test_parallel.py:
    275-311), against the port's sorted sharded cutoff path."""
    scene, params, cfg = jax_ensemble(2, 48, extent=15.0)
    cfg = dataclasses.replace(cfg, interaction_cutoff=500.0,
                              axis_comm="ring", **PALLAS)
    want = jax_sharded(scene, params, cfg)
    pscene, pparams, pcfg = port_of(scene, params, cfg)
    assert pcfg.interaction_cutoff == 500.0 and pcfg.axis_comm == "ring"
    assert_close(want, port_sharded(pscene, pparams, pcfg), "pallas ring")


# -- the mesh argument of both rollouts ---------------------------------------

def test_sweep_mesh_argument_matches_the_jax_package():
    """``make_sweep_rollout(mesh=...)`` on the JAX package's
    ``test_sweep_sharded_over_batch_axis`` configuration (8 rows of a
    ``pedestrian_gamma`` sweep over a 1 x 8 mesh): the JAX package's
    result, and the port's unsharded sweep row for row bitwise."""
    n, steps, b = 12, 10, 8
    scene, params, cfg, _ = jsyn.benchmark_bundle(n, extent=10.0)
    swept = jsweeps.batch_params(params,
                                 pedestrian_gamma=jnp.linspace(0.2, 0.6, b))
    want = jsweeps.make_sweep_rollout(
        scene, cfg, steps, record=True,
        mesh=jmesh(n_agent_shards=1, n_batch_shards=8))(swept)
    pscene, _, pcfg = port_of(scene, params, cfg)
    pswept = convert.params_from_fields(fields_of(swept))
    mesh = make_mesh(1, n_batch_shards=8, device="cpu")
    got = sweeps.make_sweep_rollout(pscene, pcfg, steps, record=True,
                                    mesh=mesh)(pswept)
    assert_close(want, got, "sweep mesh")
    one = sweeps.make_sweep_rollout(pscene, pcfg, steps, record=True)(pswept)
    assert torch.equal(got[1].pos, one[1].pos)
    assert torch.equal(got[0].alive, one[0].alive)


def test_ensemble_mesh_argument_matches_the_jax_package():
    """``make_ensemble_rollout(mesh=...)``: the rows split over the batch
    axis of a 2 x 2 mesh (the agent axis holds the same rows), against the
    JAX package's and bitwise against the port's unsharded ensemble."""
    scene, params, cfg = jax_ensemble(B, N)
    want = jsweeps.make_ensemble_rollout(
        scene, params, cfg, STEPS, record=True,
        mesh=jmesh(n_agent_shards=2, n_batch_shards=2))(scene)
    pscene, pparams, pcfg = port_of(scene, params, cfg)
    mesh = make_mesh(2, n_batch_shards=2, device="cpu")
    got = sweeps.make_ensemble_rollout(pscene, pparams, pcfg, STEPS,
                                       record=True, mesh=mesh)(pscene)
    assert_close(want, got, "ensemble mesh")
    one = sweeps.make_ensemble_rollout(pscene, pparams, pcfg, STEPS,
                                       record=True)(pscene)
    assert torch.equal(got[1].pos, one[1].pos)
    assert torch.equal(got[0].pos, one[0].pos)


@pytest.mark.parametrize("call", ["sharded ensemble", "ensemble mesh",
                                  "sweep mesh"])
def test_a_batch_that_does_not_divide_raises(call):
    """B must divide over the mesh's batch axis (the JAX package's
    sweeps.py:144-146)."""
    scene, params, cfg, _ = synthetic.benchmark_bundle(8, extent=10.0,
                                                       device="cpu")
    batched = dataclasses.replace(scene, spawn=synthetic.batched_crowds(
        3, 8, extent=10.0, device="cpu"))
    mesh = make_mesh(2, n_batch_shards=2, device="cpu")
    swept = sweeps.batch_params(params, pedestrian_A=[1.0, 2.0, 3.0])
    calls = {
        "sharded ensemble": lambda: sweeps.make_sharded_ensemble_rollout(
            mesh, batched, params, cfg, 2),
        "ensemble mesh": lambda: sweeps.make_ensemble_rollout(
            batched, params, cfg, 2, mesh=mesh),
        "sweep mesh": lambda: sweeps.make_sweep_rollout(
            scene, cfg, 2, mesh=mesh)(swept),
    }
    with pytest.raises(ValueError, match="must divide over the mesh"):
        calls[call]()


# -- groups, the fleet and ORCA on the mesh, where the batch refused them -----

def jax_mesh_case(case):
    """The JAX scene, params and config of a refused case of the 2-D mesh:
    groups of four over half of every crowd (one table), the small street
    grid with its fleet (tests/test_torch_ensemble_fleet.py's), or config
    #1 under ORCA with the windowed band."""
    from carla_social_force_model_tpu.models.groups import (
        build_groups as jbuild_groups)
    if case == "autopilot fleet":
        from test_torch_ensemble_fleet import jax_urban
        return jax_urban(b=B, n=N)
    scene, params, cfg = jax_ensemble(B, N)
    if case == "groups":
        gid = np.where(np.arange(N) < N // 2, np.arange(N) // 4, -1)
        return (dataclasses.replace(scene, groups=jbuild_groups(
            gid, max_members=4)), dataclasses.replace(
                params, enable_group=True), cfg)
    return scene, dataclasses.replace(
        params, enable_pedestrian=False, enable_orca=True, orca=dataclasses.
        replace(params.orca, window=16)), cfg


@pytest.mark.parametrize("case,item", [("groups", "19b.3a"),
                                       ("autopilot fleet", "19b.3a"),
                                       ("ORCA over an agent axis", "19b.5")])
def test_sharded_ensemble_refuses_what_is_not_ported(case, item):
    """What items 19b.3a and 19b.5 held back runs on the 2 x 4 mesh where
    the batch refused it (the test keeps the refusal's name): groups (the
    member table's global slots, each crowd gathered over its row), the
    fleet (every shard of a row steps the row's fleets from the gathered
    walkers) and ORCA over the agent axis, against the JAX package's
    ``make_sharded_ensemble_rollout`` on its jnp path: positions within
    POS_TOL_M, modes and alive equal, the fleets' ``(B, T, V)`` record
    within POS_TOL_M and its flags equal."""
    scene, params, cfg = jax_mesh_case(case)
    want = jax_sharded(scene, params, cfg, steps=6)
    pscene, pparams, pcfg = port_of(scene, params, cfg)
    got = port_sharded(pscene, pparams, pcfg, steps=6)
    if case == "autopilot fleet":
        (jf, (jrec, jveh)), (pf, (prec, pveh)) = want, got
        want, got = (jf, jrec), (pf, prec)
        assert tuple(pveh.pos.shape) == np.asarray(jveh.pos).shape
        np.testing.assert_array_equal(pveh.active.numpy(),
                                      np.asarray(jveh.active))
        np.testing.assert_allclose(pveh.pos.numpy(), np.asarray(jveh.pos),
                                   rtol=0, atol=POS_TOL_M)
        assert not torch.equal(pveh.pos[0], pveh.pos[1])
    assert_close(want, got, f"{case} ({item})")
    assert bool(got[0].alive.any())


# -- the batched launch plans and the plain versions of the kernels -----------

@pytest.mark.parametrize("max_surv", [0, 2])
def test_batched_rect_and_block_grids_equal_each_row(max_surv):
    """``pair_grid.rect_grid`` and ``block_grid`` of ``(B, n)`` rows
    against ``(B, 4, n_tiles)`` column boxes: row b of every tensor equals
    the grid of row b alone exactly (the box test, and with a table its
    survivors and counts)."""
    planes = sc.batch_shard_planes(3, 1200, seed=14, device="cpu",
                                   extent=60.0, n_shards=4, sort=True)
    rows = [a[:, 300:600].contiguous() for a in planes]
    col_bb = pair_grid.box_planes(planes[0], planes[1], planes[5],
                                  pair_grid.COL_TILE)
    grid = pair_grid.rect_grid(rows[0], rows[1], rows[5], col_bb, 1200, 8.0,
                               max_surv=max_surv)
    assert grid.form == ("compact" if max_surv else "dense_cutoff")
    row_bb = pair_grid.box_planes(rows[0], rows[1], rows[5],
                                  pair_grid.SYM_TILE)
    blk_bb = pair_grid.box_planes(planes[0][:, :300], planes[1][:, :300],
                                  planes[5][:, :300], pair_grid.SYM_TILE)
    block = pair_grid.block_grid(row_bb, blk_bb, 8.0)
    for b in range(3):
        one = pair_grid.rect_grid(
            rows[0][b], rows[1][b], rows[5][b],
            pair_grid.box_planes(planes[0][b], planes[1][b], planes[5][b],
                                 pair_grid.COL_TILE), 1200, 8.0,
            max_surv=max_surv)
        assert one.form == grid.form and one.c2 == grid.c2
        assert torch.equal(grid.boxes[b], one.boxes)
        if max_surv:
            assert torch.equal(grid.surv[b], one.surv)
            assert torch.equal(grid.counts[b], one.counts)
        one_block = pair_grid.block_grid(row_bb[b], blk_bb[b], 8.0)
        assert torch.equal(block.row_boxes[b], one_block.row_boxes)
        assert torch.equal(block.boxes[b], one_block.boxes)



@pytest.mark.parametrize("law", sc.LAWS)
@pytest.mark.parametrize("gathered", [True, False])
@pytest.mark.parametrize("cutoff", [None, 4.0])
def test_plain_rect_batched_is_the_unbatched_plain_row_by_row(law, gathered,
                                                              cutoff):
    """``plain_batched_force`` with ``cols`` (the plain version of the
    batched rectangular kernels, shard_cases.rect_batch_case): each row
    equals the unbatched plain rectangular force of that crowd bitwise, and
    lies within the kernels' limit of the independent plain pair sum."""
    planes = sc.batch_shard_planes(3, 64, seed=11, device="cpu", n_shards=4,
                                   sort=cutoff is not None)
    for shard in (0, 3):
        _, want, lim, _ = sc.rect_batch_case(law, planes, 4, shard, cutoff,
                                             gathered, kernel=False)
        k = 16
        src = shard if gathered else (shard + 1) % 4
        c0, c1 = (0, 64) if gathered else (src * k, (src + 1) * k)
        for b in range(3):
            rows = [a[b, shard * k:(shard + 1) * k] for a in planes]
            cols = [a[b, c0:c1] for a in planes]
            hel = law == "helbing"
            one = torch.stack(cuda_forces.plain_law_force(
                law, *rows[:4], None if hel else rows[4], rows[5],
                sc.law_params(law), False, 1024, cutoff,
                (rows[6], rows[7]) if hel else None,
                (*cols[:4], None if hel else cols[4], cols[5]), shard * k,
                c0))
            assert torch.equal(want[:, b], one), (law, shard, b)
            ref = sc.plain_pairs(law, rows, cols, shard * k, c0, cutoff)
            assert bool(((want[:, b] - ref).abs() <= lim[:, b]).all())


@pytest.mark.parametrize("law", ["moussaid", "powerlaw"])
@pytest.mark.parametrize("cutoff", [None, 4.0])
def test_plain_sym_dense_batched_is_the_unbatched_plain_row_by_row(law,
                                                                   cutoff):
    """The plain version of the batched full-block kernel
    (``plain_batched_force`` with ``mirror``): each crowd's rows and
    columns equal the unbatched plain full-block force bitwise, within the
    limit of the independent plain pair sums."""
    planes = sc.batch_shard_planes(3, 40, seed=12, device="cpu",
                                   n_shards=2, sort=cutoff is not None)
    rows = [a[:, :17].contiguous() for a in planes]
    cols = [a[:, 17:].contiguous() for a in planes]
    _, _, want_r, want_c, lim_r, lim_c, _, _ = sc.sym_dense_batch_case(
        law, rows, cols, cutoff, kernel=False)
    for b in range(3):
        r, c = [a[b] for a in rows], [a[b] for a in cols]
        one = cuda_forces.plain_law_force(
            law, *r[:6], sc.law_params(law), False, 1024, cutoff, None,
            tuple(c[:6]), 0, 17, mirror=True)
        assert torch.equal(want_r[:, b], torch.stack(one[:2]))
        assert torch.equal(want_c[:, b], torch.stack(one[2:]))
        ref_r, ref_c = sc.plain_pairs(law, r, c, 0, 17, cutoff, mirror=True)
        assert bool(((want_r[:, b] - ref_r).abs() <= lim_r[:, b]).all())
        assert bool(((want_c[:, b] - ref_c).abs() <= lim_c[:, b]).all())


@pytest.mark.parametrize("law", sc.LAWS)
@pytest.mark.parametrize("cutoff", [None, 4.0])
def test_plain_ring_batched_is_the_unbatched_plain_ring_row_by_row(law,
                                                                   cutoff):
    """``ring_force_batched_plain`` (the plain version of the batched ring
    kernel): each crowd equals ``ring_force_plain`` of that crowd bitwise,
    within the limit of the gathered plain pair sum."""
    planes = sc.batch_shard_planes(3, 48, seed=13, device="cpu", n_shards=4,
                                   sort=cutoff is not None)
    _, want, lim, _ = sc.ring_batch_case(law, planes, 4, cutoff,
                                         kernel=False)
    hel = law == "helbing"
    for b in range(3):
        x, y, vx, vy, rad, alive, ex, ey = [a[b] for a in planes]
        one = torch.stack(cuda_ring.ring_force_plain(
            x, y, vx, vy, None if hel else rad, alive, sc.law_params(law), 4,
            law=law, desired=(ex, ey) if hel else None, cutoff=cutoff))
        assert torch.equal(want[:, b], one)
        ref = sc.plain_pairs(law, [a[b] for a in planes],
                             [a[b] for a in planes], 0, 0, cutoff)
        assert bool(((want[:, b] - ref).abs() <= lim[:, b]).all())
