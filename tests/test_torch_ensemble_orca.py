"""PyTorch port: ORCA and the per-agent law columns under a batch of crowds
(ROADMAP item 19b.3b) against the JAX package.

The JAX package vmaps its rollout over ensembles and sweeps with ORCA on
(its wall feed on the jnp path, the CPU default, whose ties the port
follows; the analytic border tier in interpret mode); the port steps ``(B,
N)`` planes, on the CPU through the plain versions of the batched wall-feed
kernels (``statics.seg_topk_batched``, ``chunk_topk_batched``,
``chunk_closest_batched``).

Tolerances.  The feeds on coordinates of a 1/8 m grid, where every
operation is exact: bitwise against ``jax.vmap`` of the JAX functions.
``orca_velocities`` on seeded crowds: 1e-5 (``test_torch_orca.VEL_TOL``).
Step by step from the JAX package's own vmapped state:
``test_torch_orca.POS_TOL_M`` (3e-5 m), power-law rows
``POWERLAW_POS_TOL_M`` (1e-4 m), alive masks and modes equal, a row whose
program is infeasible held to the same minimax value
(:class:`BatchFallbackRows`, ``test_torch_orca.FallbackRows``'s rule).
Every row of a batched rollout equals the port's unbatched rollout of that
crowd or parameter point bitwise.  The card-only cases (the batched kernels
themselves) are in ``tests/test_torch_cuda.py``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orca_cases import tie_chunk_set, tie_crowd, tie_segment_planes
from test_torch_ensemble import fields_of, port_of
from test_torch_orca import (DT, POS_TOL_M, POWERLAW_POS_TOL_M, VEL_TOL,
                             assert_close, bench_scene, crowd, j, t,
                             vehicle_snaps, walls)
from carla_social_force_model_tpu.api import scenario as jax_scenario
from carla_social_force_model_tpu.api import synthetic as jax_synthetic
from carla_social_force_model_tpu.env import pointsets as jps
from carla_social_force_model_tpu.models import stepper as jax_stepper
from carla_social_force_model_tpu.models.params import (
    OrcaParams as JaxOrcaParams)
from carla_social_force_model_tpu.models.state import PedState as JaxState
from carla_social_force_model_tpu.ops import geometry as jgeo
from carla_social_force_model_tpu.ops import orca as jorca
from carla_social_force_model_tpu.ops import pallas_statics as jstatics
from carla_social_force_model_tpu.parallel import sweeps as jax_sweeps
from carla_social_force_model_tpu_torch.api import scenario
from carla_social_force_model_tpu_torch.api import synthetic
from carla_social_force_model_tpu_torch.env import pointsets as pps
from carla_social_force_model_tpu_torch.models import stepper
from carla_social_force_model_tpu_torch.models.params import (
    OrcaParams, param_batch, section_rows)
from carla_social_force_model_tpu_torch.models.spawn import LAW_IDS
from carla_social_force_model_tpu_torch.models.state import PedState
from carla_social_force_model_tpu_torch.ops import geometry, orca, statics
from carla_social_force_model_tpu_torch.ops.spatial import morton_order
from carla_social_force_model_tpu_torch.parallel import sweeps
from carla_social_force_model_tpu_torch.utils import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
#: a sweep's neighbour distances: 7.3 is not a float32 square's root, so
#: each row's nd^2 must be the float32 square of its float32 nd
SWEPT_ND = (2.0, 7.3, 15.0)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Tiny tensors, and the test workers run side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the feeds ----------------------------------------------------------------

def tie_rows(b, n, seed):
    """``b`` tie crowds (``orca_cases.tie_crowd``, one seed a row) as
    ``(B, n)`` numpy planes x, y, alive."""
    rows = [tie_crowd(n, seed=seed + r) for r in range(b)]
    return tuple(np.stack(c) for c in zip(*rows))


def feed_sources(kind):
    """``(port source, JAX source)`` of the tie cases: segment features at
    feature indices 1, L and L + 1 apart, or ragged chunks of 64 slots."""
    if kind == "segments":
        planes = tie_segment_planes(301)
        return (pps.SegmentFeatures(**{a: t(v) for a, v in planes.items()}),
                jps.SegmentFeatures(**{a: jnp.asarray(v)
                                       for a, v in planes.items()},
                                    num_features=301))
    pset = tie_chunk_set(23, 64, seed=3)
    return (pps.chunk_features(pset, CPU), jps.ChunkedPointSet(
        **{a: jnp.asarray(getattr(pset, a)) for a in (
            "points", "valid", "chunk_segment", "centers",
            "filter_radius")}, num_segments=pset.num_segments))


def nd_args(nd, b):
    """The port's and the JAX vmap's neighbour distance: a number shared by
    every row, or a sweep's float32 ``(B,)`` values."""
    if nd == "shared":
        return 15.0, 15.0, None, [15.0] * b
    vals = np.float32(SWEPT_ND[:b])
    return torch.from_numpy(vals), jnp.asarray(vals), 0, vals.tolist()


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("nd", ["shared", "swept"])
@pytest.mark.parametrize("kind", ["segments", "chunks"])
def test_batched_topk_equals_jax_vmap_and_each_row(kind, nd, k):
    """``nearest_features_topk`` on ``(B, N)`` planes (the batched plain
    version on the CPU) against ``jax.vmap`` of the JAX package's on its
    jnp path, bitwise: ties at feature indices a lane stride apart and
    more equal candidates than k, a shared or swept neighbour distance;
    and each row against the port's unbatched call on that row."""
    psrc, jsrc = feed_sources(kind)
    x, y, alive = tie_rows(3, 200, seed=10 * k)
    p_nd, j_nd, axis, rows_nd = nd_args(nd, 3)
    got = statics.nearest_features_topk(t(x), t(y), psrc, k, p_nd,
                                        alive=t(alive))
    assert got[0].shape == (3, k, 200)
    want = jax.vmap(
        lambda xx, yy, dd: jstatics.nearest_features_topk(
            xx, yy, jsrc, k, dd, use_pallas=False),
        in_axes=(0, 0, axis))(j(x), j(y), j_nd)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.isfinite(got[0].numpy()).any()
    for r in range(3):
        one = statics.nearest_features_topk(t(x[r]), t(y[r]), psrc, k,
                                            rows_nd[r])
        for g, w in zip(got, one):
            assert torch.equal(g[r], w), r
    if nd == "swept":
        # the rows' gates differ: the nearest row keeps fewer candidates
        fin = np.isfinite(got[0].numpy()).sum(axis=(1, 2))
        assert fin[0] < fin[2]


@pytest.mark.parametrize("nd", ["shared", "swept"])
def test_batched_closest_point_per_chunk_equals_jax_vmap(nd):
    """The entry ``geometry.closest_point_per_chunk`` on ``(B, N)`` planes:
    ``(C, B, N)`` planes (the JAX entry under vmap with the chunks first),
    bitwise equal to the JAX jnp path on ragged chunks with ties and empty
    chunks, each row to the port's unbatched call."""
    psrc, jsrc = feed_sources("chunks")
    x, y, alive = tie_rows(3, 150, seed=4)
    p_nd, j_nd, axis, rows_nd = nd_args(nd, 3)
    got = geometry.closest_point_per_chunk(t(x), t(y), psrc, p_nd,
                                           alive=t(alive))
    assert got[0].shape == (psrc.num_chunks, 3, 150)
    want = jax.vmap(
        lambda xx, yy, dd: jgeo.closest_point_per_chunk(
            xx, yy, jsrc, dd, use_pallas=False),
        in_axes=(0, 0, axis), out_axes=1)(j(x), j(y), j_nd)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for r in range(3):
        one = geometry.closest_point_per_chunk(t(x[r]), t(y[r]), psrc,
                                               rows_nd[r])
        for g, w in zip(got, one):
            assert torch.equal(g[:, r], w), r


def test_batched_feeds_keep_the_reach_of_each_row():
    """A sweep's squared reach is each row's float32 square: a pedestrian
    exactly at the float32 distance of its row is kept; the batched
    wrappers refuse a neighbour distance of another batch, planes of one
    crowd and CPU tensors."""
    nd = torch.tensor([7.3, 2.0])
    sq = geometry.reach_rows(nd)
    assert sq.shape == (2, 1) and sq.dtype == torch.float32
    assert sq[0, 0].item() == geometry.squared_reach(float(nd[0]))
    with pytest.raises(ValueError, match=r"\(3,\) tensor"):
        statics._nd_rows(nd, 3, nd.device)
    psrc, _ = feed_sources("segments")
    z = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        statics.seg_topk_batched(z, z, psrc, 3, nd)
    with pytest.raises(ValueError, match=r"\(B, n\) planes"):
        statics.chunk_closest_batched(z[0], z[0], feed_sources("chunks")[0],
                                      nd)


def test_static_topk_merges_both_parts_of_each_row():
    """The (2k, N) merge of a split with an analytic part and a sampled
    remainder, on ``(B, N)`` planes with a swept neighbour distance,
    against ``jax.vmap`` of the JAX package's ``_static_topk``."""
    from test_torch_analytic import assert_topk_equal, both_sets
    jset, pset = both_sets("unsafe")
    jf = jps.build_static_features(jset)
    pf = pps.build_static_features(pset, CPU)
    assert pf.seg is not None and pf.rest is not None
    rng = np.random.default_rng(5)
    pos = rng.uniform(-13.0, 13.0, (3, 200, 2)).astype(np.float32)
    nd = np.float32([4.0, 9.0, 12.0])
    got = orca._static_topk(t(pos[..., 0]), t(pos[..., 1]), pf, 3, t(nd),
                            None)
    want = jax.vmap(lambda xx, yy, dd: jorca._static_topk(
        xx, yy, jf, 3, dd, None))(j(pos[..., 0]), j(pos[..., 1]), j(nd))
    assert got[0].shape == (3, 3, 200)
    for r in range(3):
        assert_topk_equal(tuple(g[r] for g in got),
                          tuple(np.asarray(w)[r] for w in want))


# -- the minimax fallback's rows ----------------------------------------------

class BatchFallbackRows:
    """``test_torch_orca.FallbackRows`` under a batch: records, for each
    ORCA solve of the port, the (row, slot) cells whose program is
    infeasible with their constraint planes (the programs run over the
    flattened ``B * N`` rows of each crowd's sorted order), so that such a
    cell is held to the same minimax value as the JAX package's velocity
    instead of the same point (the fallback's optimum can be a segment)."""

    def __init__(self, monkeypatch):
        self.cells = []
        self.shape = self.perm = None
        real_solve, real_orca = orca.solve_orca_lp, stepper.orca_velocities

        def solve(pref_x, pref_y, ptx, pty, nx, ny, valid, vmax):
            bad = ~orca.solve_lp2(pref_x, pref_y, ptx, pty, nx, ny, valid,
                                  vmax)[2]
            flat = torch.nonzero(bad).squeeze(1)
            b, i = flat // self.shape[-1], flat % self.shape[-1]
            slot = self.perm[b, i] if self.perm is not None else i
            self.cells.append((b, slot, ptx[bad], pty[bad], nx[bad],
                               ny[bad], valid[bad]))
            return real_solve(pref_x, pref_y, ptx, pty, nx, ny, valid, vmax)

        def velocities(pos, *args, **kwargs):
            self.track(pos, args[1], args[5], kwargs.get("order"),
                       kwargs.get("spatial_order", "hilbert"))
            return real_orca(pos, *args, **kwargs)

        monkeypatch.setattr(orca, "solve_orca_lp", solve)
        monkeypatch.setattr(stepper, "orca_velocities", velocities)

    def track(self, pos, alive, params, order, spatial_order="hilbert"):
        """The sorted order of the next solve (``orca_velocities``'s)."""
        n = pos[0].shape[-1]
        self.shape = pos[0].shape
        self.perm = (None if (params.window or n) >= n
                     else order[0] if order is not None
                     else morton_order(pos[0], pos[1], alive,
                                       spatial_order)[0])

    def check(self, got, want):
        """``got``/``want``: ``(vx, vy)`` (B, N) arrays of the port and the
        JAX package.  Every recorded cell's two velocities reach the same
        minimax value on the port's planes (1e-5); returns the (B, N) mask
        of those cells and forgets them."""
        fallback = np.zeros(self.shape, bool)
        for b, slot, ptx, pty, nx, ny, valid in self.cells:
            for c, (row, i) in enumerate(zip(b.tolist(), slot.tolist())):
                fallback[row, i] = True
                vals = []
                for vx, vy in ((got[0][row, i], got[1][row, i]),
                               (want[0][row, i], want[1][row, i])):
                    clear = ((float(vx) - ptx[c]) * nx[c]
                             + (float(vy) - pty[c]) * ny[c])
                    vals.append(clear[valid[c]].min().item())
                assert abs(vals[0] - vals[1]) <= 1e-5, (row, i, vals)
        self.cells.clear()
        return fallback


# -- orca_velocities ----------------------------------------------------------

def velocity_rows(b, n):
    """``b`` seeded crowds (``test_torch_orca.crowd``, one seed a row) with
    preferred velocities, speed caps and wall-exempt rows, as ``(B, n)``
    numpy planes."""
    rows = []
    for r in range(b):
        pos, vel, radius, alive = crowd(n, 3 + r, 11.0)
        pos[1] = pos[0]
        rng = np.random.default_rng(4 + r)
        pref = rng.uniform(-1.8, 1.8, (n, 2)).astype(np.float32)
        vmax = rng.uniform(1.5, 2.0, n).astype(np.float32)
        exempt = rng.uniform(size=n) < 0.15
        rows.append((pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1], radius,
                     alive, pref[:, 0], pref[:, 1], vmax, exempt))
    return [np.stack(c) for c in zip(*rows)]


#: a sweep of the ORCA leaves over three rows (float32 values)
ORCA_SWEEP = dict(tau=(1.0, 2.0, 3.5), neighbor_dist=(4.0, 6.0, 7.3),
                  tau_static=(0.5, 2.0, 1.25))


@pytest.mark.parametrize("params", ["shared", "swept"])
@pytest.mark.parametrize("window", [32, 0])
def test_batched_orca_velocities_equal_jax_vmap_and_each_row(window, params,
                                                             monkeypatch):
    """``orca_velocities`` on ``(B, N)`` planes (the windowed band and the
    full pass) among walls as the analytic feature split, parked cars as
    chunks and two vehicles, with shared ``OrcaParams`` or a sweep of
    ``tau``, ``neighbor_dist`` and ``tau_static``, against ``jax.vmap`` of
    the JAX package's (VEL_TOL; an infeasible program's row by its minimax
    value), and each row bitwise against the port's unbatched solve of
    that row with its float32 parameters."""
    b, n = 3, 120
    cols = velocity_rows(b, n)
    px, py, vx, vy, rad, alive, prx, pry, vmax, exm = cols
    (jb, jo), (pb, po) = walls()
    jb, jo = jps.build_static_features(jb), jps.build_static_features(jo)
    pb, po = (pps.build_static_features(pb, CPU),
              pps.build_static_features(po, CPU))
    jsnap, psnap = vehicle_snaps()
    kw = dict(max_neighbors=6, window=window)
    if params == "shared":
        pp, jp = OrcaParams(neighbor_dist=6.0, **kw), JaxOrcaParams(
            neighbor_dist=6.0, **kw)
        p_rows = [pp] * b
        jaxes = None
    else:
        pp = OrcaParams(**{f: torch.tensor(v) for f, v in ORCA_SWEEP.items()},
                        **kw)
        jp = JaxOrcaParams(**{f: jnp.asarray(np.float32(v))
                              for f, v in ORCA_SWEEP.items()}, **kw)
        p_rows = section_rows(pp, b)
        jaxes = JaxOrcaParams(tau=0, neighbor_dist=0, tau_static=0, **kw)
    fallback = BatchFallbackRows(monkeypatch)
    order = morton_order(t(px), t(py), t(alive), "hilbert")
    fallback.track((t(px), t(py)), t(alive), pp, order)
    got = orca.orca_velocities(
        (t(px), t(py)), (t(vx), t(vy)), t(rad), t(alive), (t(prx), t(pry)),
        t(vmax), pp, DT, veh_snap=psnap, borders=pb, obstacles=po,
        static_exempt=t(exm), order=order)
    assert got[0].shape == (b, n)

    def one(x, y, u, v, r, a, qx, qy, m, e, p):
        return jorca.orca_velocities(
            (x, y), (u, v), r, a, (qx, qy), m, p, DT, veh_snap=jsnap,
            borders=jb, obstacles=jo, static_exempt=e)

    want = jax.jit(jax.vmap(one, in_axes=(0,) * 10 + (jaxes,)))(
        *(j(c) for c in cols), jp)
    infeasible = fallback.check([g.numpy() for g in got],
                                [np.asarray(w) for w in want])
    monkeypatch.undo()
    assert_close(got, want, tol=VEL_TOL, mask=alive & ~infeasible)
    moved = np.abs(got[0].numpy() - prx) > 1e-3
    assert (moved & alive).sum(axis=1).min() > 20
    for r in range(b):
        row = orca.orca_velocities(
            (t(px[r]), t(py[r])), (t(vx[r]), t(vy[r])), t(rad[r]),
            t(alive[r]), (t(prx[r]), t(pry[r])), t(vmax[r]), p_rows[r], DT,
            veh_snap=psnap, borders=pb, obstacles=po,
            static_exempt=t(exm[r]))
        for g, w in zip(got, row):
            assert torch.equal(g[r], w), r
    if params == "swept":
        assert not torch.equal(got[0][0], orca.orca_velocities(
            (t(px[0]), t(py[0])), (t(vx[0]), t(vy[0])), t(rad[0]),
            t(alive[0]), (t(prx[0]), t(pry[0])), t(vmax[0]), p_rows[2], DT,
            veh_snap=psnap, borders=pb, obstacles=po,
            static_exempt=t(exm[0]))[0])


def test_batched_orca_refuses_an_agent_axis():
    """Item 19b.5, where the refusal was (the test keeps its name):
    ``orca_velocities`` on each shard's ``(B, n)`` slots of a 4-shard
    LocalMesh (every crowd gathered along the last axis and solved whole,
    each shard keeping its own columns), joined along the slots, equals
    the call on the whole ``(B, N)`` planes bitwise: the windowed band,
    the walls' analytic feed, parked cars as chunks, two vehicles."""
    from carla_social_force_model_tpu_torch.parallel import make_mesh
    b, n, d = 3, 120, 4
    cols = [t(c) for c in velocity_rows(b, n)]
    _, (pb, po) = walls()
    pb, po = (pps.build_static_features(pb, CPU),
              pps.build_static_features(po, CPU))
    _, psnap = vehicle_snaps()
    pp = OrcaParams(neighbor_dist=6.0, max_neighbors=6, window=32)

    def call(c, axis=None):
        px, py, vx, vy, rad, alive, prx, pry, vmax, exm = c
        return orca.orca_velocities(
            (px, py), (vx, vy), rad, alive, (prx, pry), vmax, pp, DT,
            veh_snap=psnap, borders=pb, obstacles=po, static_exempt=exm,
            axis=axis)

    want = call(cols)
    m = n // d
    outs = make_mesh(d, device=CPU).run(
        lambda ax, part: call(part, ax),
        [[c[:, k * m:(k + 1) * m].contiguous() for c in cols]
         for k in range(d)])
    for got, w in zip(zip(*outs), want):
        assert got[0].shape == (b, m)
        assert torch.equal(torch.cat(got, dim=-1), w)
    assert (want[0] != cols[6]).any()


# -- the step, step by step against the JAX package's vmapped step ------------

def jax_batch_state(capacity, b):
    empty = JaxState.empty(capacity)
    return jax.tree_util.tree_map(
        lambda leaf: jnp.broadcast_to(leaf[None], (b,) + leaf.shape), empty)


def jax_vmapped_step(js, jp, jc, kind):
    """The JAX package's step vmapped as its rollouts vmap it: over the
    spawn schedules of an ensemble (shared params) or over the params of a
    sweep (one scene).  ``step(state, k)``."""
    if kind == "ensemble":
        def one(s, spawn, k):
            return jax_stepper.simulation_step(
                s, dataclasses.replace(js, spawn=spawn), jp, jc, k)[0]
        step = jax.jit(jax.vmap(one, in_axes=(0, 0, None)))
        return lambda s, k: step(s, js.spawn, k)
    step = jax.jit(jax.vmap(
        lambda s, p, k: jax_stepper.simulation_step(s, js, p, jc, k)[0],
        in_axes=(0, 0, None)))
    return lambda s, k: step(s, jp, k)


def batched_step_by_step(jax_side, port_side, kind, steps, monkeypatch,
                         tol=POS_TOL_M):
    """The port's batched step from the JAX package's own vmapped state at
    every step: alive and modes equal, positions within ``tol`` (a cell
    whose program is infeasible: :class:`BatchFallbackRows`).  ``kind``
    ``ensemble`` (batched schedules) or ``sweep`` (batched params).
    Returns the worst position error and the number of alive cells seen."""
    js, jp, jc = jax_side
    ps, pp, pc = port_side
    js = jax_stepper.prepare_scene(js, analytic=jc.env_analytic, orca=True)
    ps = stepper.prepare_scene(ps, analytic=pc.env_analytic, orca=True,
                               chunked=pc.env_chunked)
    b = (ps.spawn.step.shape[0] if kind == "ensemble"
         else param_batch(pp))
    step = jax_vmapped_step(js, jp, jc, kind)
    jst = jax_batch_state(ps.spawn.capacity, b)
    fallback = BatchFallbackRows(monkeypatch)
    worst, seen = 0.0, 0
    for k in range(steps):
        pst = convert.ped_state_from_fields(fields_of(jst), CPU)
        got, _ = stepper.simulation_step(pst, ps, pp, pc, k)
        jst = step(jst, k)
        want = fields_of(jst)
        np.testing.assert_array_equal(got.alive.numpy(), want["alive"])
        np.testing.assert_array_equal(got.mode.numpy(), want["mode"])
        skip = fallback.check((got.vel_x.numpy(), got.vel_y.numpy()),
                              (want["vel_x"], want["vel_y"]))
        err = np.maximum(np.abs(got.pos_x.numpy() - want["pos_x"]),
                         np.abs(got.pos_y.numpy() - want["pos_y"]))
        worst = max(worst, float(np.where(skip, 0.0, err).max()))
        seen += int(want["alive"].sum())
    assert worst <= tol, worst
    return worst, seen


def jax_orca_ensemble(b, n, geometry):
    """(scene, params, cfg) of a JAX ensemble of ``b`` synthetic crowds of
    ``n`` under bench.py's BENCH_LAW=orca: config #1 (no geometry, the
    windowed band) or config #3 with the analytic border tier
    (BENCH_ENV_ANALYTIC=1; the JAX package's interpret-mode kernels)."""
    if geometry is None:
        scene, params, cfg, _ = jax_synthetic.benchmark_bundle(
            n, extent=9.0, use_pallas=False)
        extent = 9.0
    else:
        scene, params, cfg, _ = jax_synthetic.benchmark_bundle(
            n, extent=12.0, with_borders=True, with_obstacles=True,
            num_steps_hint=12, use_pallas=True)
        cfg = dataclasses.replace(cfg, pallas_interpret=True,
                                  env_analytic=True, env_ped_tile=128)
        extent = 12.0
    scene, params = bench_scene(scene, params, "orca", True)
    params = dataclasses.replace(params, orca=dataclasses.replace(
        params.orca, window=32))
    return (dataclasses.replace(scene, spawn=jax_synthetic.batched_crowds(
        b, n, extent=extent)), params, cfg)


def mixed_columns(b, n, seed):
    """``(law_id, pair_scale)`` numpy columns ``(b, n)`` of mixed crowds
    (BENCH_MIX=moussaid,powerlaw,orca in contiguous chunks, each row in
    another order, and -1 rows that feel every family) with seeded
    scales."""
    rng = np.random.default_rng(seed)
    fams = np.array([LAW_IDS[f] for f in ("moussaid", "powerlaw", "orca")])
    law = np.empty((b, n), np.int32)
    for r in range(b):
        chunks = np.array_split(np.arange(n), 3)
        for fam, chunk in zip(np.roll(fams, r), chunks):
            law[r, chunk] = fam
        law[r, rng.choice(n, n // 10, replace=False)] = -1
    scale = rng.uniform(0.5, 1.5, (b, n)).astype(np.float32)
    return law, scale


def jax_mixed_ensemble(b, n):
    """A config #1 ensemble of mixed crowds with ``(B, N)`` law_id and
    pair_scale columns: the Moussaid, power-law and ORCA rows of each
    crowd where its columns put them."""
    scene, params, cfg = jax_orca_ensemble(b, n, None)
    law, scale = mixed_columns(b, n, 2)
    spawn = dataclasses.replace(scene.spawn, law_id=jnp.asarray(law),
                                pair_scale=jnp.asarray(scale))
    params = dataclasses.replace(params, enable_pedestrian=True,
                                 enable_powerlaw=True)
    return dataclasses.replace(scene, spawn=spawn), params, cfg


def jax_orca_sweep():
    """(scene, params, cfg, sweep) of config #2 (sidewalk borders as the
    analytic wall feed) with ORCA on the JAX package's jnp path and a
    sweep of its three leaves."""
    scene, params, cfg, _ = jax_synthetic.benchmark_bundle(
        80, extent=9.0, with_borders=True, num_steps_hint=12,
        use_pallas=False)
    scene, params = bench_scene(scene, params, "orca", True)
    params = dataclasses.replace(params, orca=dataclasses.replace(
        params.orca, window=32))
    return scene, params, cfg, {f"orca_{f}": list(v)
                                for f, v in ORCA_SWEEP.items()}


#: the shipped scenarios with their own parameter files, and the leaves
#: each sweeps
SCENARIOS = {
    "corridor_counterflow/sfm_orca": (
        "corridor_counterflow", "sfm_orca.toml",
        dict(orca_tau=[1.5, 2.0, 3.0], orca_neighbor_dist=[4.0, 7.3, 15.0])),
    "obstacle_evasion/sfm_orca": (
        "obstacle_evasion", "sfm_orca.toml",
        dict(orca_neighbor_dist=[3.0, 15.0], orca_tau_static=[0.5, 2.0])),
    "mixed_crossing/sfm_mixed orca": (
        "mixed_crossing", "sfm_mixed.toml",
        dict(orca_tau=[1.0, 2.5], powerlaw_k=[1.0, 2.5])),
    "mixed_crossing/sfm_mixed pair laws": (
        "mixed_crossing", "sfm_mixed.toml",
        dict(pedestrian_A=[2.0, 4.5], ped_repulsive_v0=[1.5, 3.0],
             border_a=[1.0, 6.0])),
}


def scenario_sweep(case, steps):
    """Both packages' bundles of a shipped scenario built from the same
    TOML files (the scenarios' engine: the JAX jnp path, the port's
    ``env_chunked``), and its sweep."""
    name, sfm, kw = SCENARIOS[case]
    path = os.path.join(REPO, "configs", "scenarios", f"{name}.toml")
    sfm = os.path.join(REPO, "configs", sfm)
    jb = jax_scenario.build_scenario(path, sfm, steps)
    pb = scenario.build_scenario(path, sfm, steps, device=CPU)
    assert pb.cfg.env_chunked and not jb.cfg.use_pallas
    return jb, pb, kw


@pytest.mark.parametrize("case", ["config #1", "config #3 analytic",
                                  "mixed columns"])
def test_ensemble_orca_matches_jax_step_by_step(case, monkeypatch):
    """Ensembles under BENCH_LAW=orca: config #1 (three crowds of 80, the
    windowed band), config #3 with the analytic border tier (two crowds of
    48 among borders, parked cars as chunks and vehicles), and mixed
    crowds with ``(B, N)`` law_id and pair_scale columns (every pair law
    masked per row, ORCA's row mask, power-law rows' bound)."""
    if case == "config #1":
        js, jp, jc = jax_orca_ensemble(3, 80, None)
    elif case == "config #3 analytic":
        js, jp, jc = jax_orca_ensemble(2, 48, "config3")
    else:
        js, jp, jc = jax_mixed_ensemble(3, 80)
    ps, pp, pc = port_of(js, jp, jc)
    assert pc.env_analytic == jc.env_analytic
    _, seen = batched_step_by_step(
        (js, jp, jc), (ps, pp, pc), "ensemble",
        6 if case == "config #3 analytic" else 10, monkeypatch,
        tol=POWERLAW_POS_TOL_M if case == "mixed columns" else POS_TOL_M)
    assert seen > 0


def test_orca_sweep_matches_jax_step_by_step(monkeypatch):
    """A sweep of orca_tau, orca_neighbor_dist and orca_tau_static over
    three rows of config #2 with the walls' analytic feed; the JAX
    package's params carried over and the port's own batch_params give the
    same sweep."""
    js, jp, jc, kw = jax_orca_sweep()
    swept = jax_sweeps.batch_params(jp, **dict(kw))
    ps, pp, pc = port_of(js, jp, jc)
    pswept = convert.params_from_fields(fields_of(swept))
    own = sweeps.batch_params(pp, **dict(kw))
    for f in ORCA_SWEEP:
        assert torch.equal(getattr(pswept.orca, f), getattr(own.orca, f))
        assert getattr(pswept.orca, f).dtype == torch.float32
    batched_step_by_step((js, swept, jc), (ps, pswept, pc), "sweep", 10,
                         monkeypatch)


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_scenario_sweep_matches_jax_step_by_step(case, monkeypatch):
    """The shipped scenarios that were refused under a batch:
    corridor_counterflow with sfm_orca.toml (48 walkers, the full
    neighbour pass: window 64 >= N, the corridor's walls as segment
    features), obstacle_evasion with sfm_orca.toml (its obstacles stay
    sampled: the chunk feed) and mixed_crossing with sfm_mixed.toml (its
    law_id column keeps each lane
    on the Moussaid force, the power law, Helbing's ellipse or ORCA),
    swept over ORCA's and the power law's leaves or over the other pair
    laws' and the borders', on the scenarios' engine, stepped from the JAX
    package's vmapped state.  (mixed_crossing with sfm.toml does not build
    in either package: its spawners name laws that file does not
    enable.)"""
    steps = 40
    jb, pb, kw = scenario_sweep(case, steps)
    if case.startswith("mixed"):
        assert pb.scene.spawn.law_id is not None
    swept = jax_sweeps.batch_params(jb.params, **dict(kw))
    pswept = convert.params_from_fields(fields_of(swept))
    tol = (POWERLAW_POS_TOL_M if pb.params.enable_powerlaw else POS_TOL_M)
    _, seen = batched_step_by_step((jb.scene, swept, jb.cfg),
                                   (pb.scene, pswept, pb.cfg), "sweep",
                                   steps, monkeypatch, tol=tol)
    assert seen > 0


# -- every row is the unbatched rollout ---------------------------------------

def row_spawn(spawn, row):
    """Row ``row`` of an ensemble's spawn schedule (one crowd): every
    batched plane, the per-agent columns too."""
    routes = spawn.routes
    return dataclasses.replace(
        spawn, routes=dataclasses.replace(
            routes, **{f.name: getattr(routes, f.name)[row]
                       for f in dataclasses.fields(routes)
                       if isinstance(getattr(routes, f.name), torch.Tensor)}),
        **{f.name: getattr(spawn, f.name)[row]
           for f in dataclasses.fields(spawn)
           if isinstance(getattr(spawn, f.name), torch.Tensor)})


def params_row(params, swept, row):
    """``params`` with row ``row`` of every swept section of ``swept`` as
    Python numbers (float32 values, ``section_rows``)."""
    b = param_batch(swept)
    upd = {s: section_rows(getattr(swept, s), b)[row]
           for s in ("acceleration", "pedestrian", "border", "powerlaw",
                     "ped_repulsive", "orca")}
    msf = swept.max_speed_factor
    return dataclasses.replace(
        params, max_speed_factor=(msf[row].item()
                                  if isinstance(msf, torch.Tensor) else msf),
        **upd)


@pytest.mark.parametrize("case", ["config #3 analytic", "mixed columns"])
def test_ensemble_rows_equal_unbatched_rollouts(case):
    """Row b of an ORCA ensemble equals the port's unbatched rollout of
    crowd b bitwise: config #3 with the analytic tier (both wall feeds,
    vehicles) and mixed crowds with ``(B, N)`` law_id and pair_scale
    columns."""
    steps = 10
    scene, params, cfg = port_of(*(jax_orca_ensemble(2, 48, "config3")
                                   if case == "config #3 analytic"
                                   else jax_mixed_ensemble(3, 80)))
    final, rec = sweeps.make_ensemble_rollout(scene, params, cfg, steps,
                                              record=True)(scene)
    n = scene.spawn.capacity
    for row in range(scene.spawn.step.shape[0]):
        one = dataclasses.replace(scene, spawn=row_spawn(scene.spawn, row))
        f1, r1 = stepper.make_rollout_fn(one, params, cfg, steps)(
            PedState.empty(n, device=CPU))
        assert torch.equal(rec.pos[row], r1.pos), (case, row)
        assert torch.equal(rec.mode[row], r1.mode)
        assert torch.equal(final.alive[row], f1.alive)
    assert not torch.equal(rec.pos[0], rec.pos[1])


@pytest.mark.parametrize("case", ["config #2 sweep",
                                  "corridor_counterflow/sfm_orca"])
def test_sweep_rows_equal_unbatched_rollouts(case):
    """Row b of an ORCA sweep equals the unbatched rollout with row b's
    parameters bitwise: the ORCA leaves (a float32 column on one path, a
    Python number holding the same float32 value on the other) and a
    scenario's sweep through ``make_sweep_rollout(orca=True)``."""
    steps = 10
    if case == "config #2 sweep":
        js, jp, jc, kw = jax_orca_sweep()
        scene, params, cfg = port_of(js, jp, jc)
    else:
        _, pb, kw = scenario_sweep(case, steps)
        scene, params, cfg = pb.scene, pb.params, pb.cfg
    swept = sweeps.batch_params(params, **dict(kw))
    final, rec = sweeps.make_sweep_rollout(scene, cfg, steps, record=True,
                                           orca=True)(swept)
    for row in range(param_batch(swept)):
        f1, r1 = stepper.make_rollout_fn(scene, params_row(params, swept,
                                                           row), cfg, steps)(
            PedState.empty(scene.spawn.capacity, device=CPU))
        assert torch.equal(rec.pos[row], r1.pos), (case, row)
        assert torch.equal(final.alive[row], f1.alive)
    assert not torch.equal(rec.pos[0], rec.pos[-1])


# -- the per-agent columns and the refusals that stay ------------------------

def column_scene(kind, b=2, n=8):
    """A batched scene of ``kind`` ``ensemble`` (a ``(b, n)`` schedule) or
    ``sweep`` (one schedule) with ORCA and the Moussaid force, and the
    state and params its step takes."""
    scene, params, cfg, _ = synthetic.benchmark_bundle(
        n, extent=10.0, with_borders=True, device=CPU)
    params = dataclasses.replace(params, enable_orca=True)
    if kind == "ensemble":
        scene = dataclasses.replace(scene, spawn=synthetic.batched_crowds(
            b, n, extent=10.0, device=CPU))
    else:
        params = sweeps.batch_params(params, orca_tau=[1.0, 2.0][:b])
    return scene, params, cfg, PedState.empty(n, device=CPU, batch=b)


COLUMNS = {  # (kind, law_id shape, pair_scale shape, accepted)
    "ensemble (B, N)": ("ensemble", (2, 8), (2, 8), True),
    "sweep (N,)": ("sweep", (8,), (8,), True),
    "ensemble (N,)": ("ensemble", (8,), None, False),
    "ensemble (B + 1, N)": ("ensemble", None, (3, 8), False),
    "sweep (B, N)": ("sweep", (2, 8), None, False),
    "sweep (N + 1,)": ("sweep", None, (9,), False),
}


@pytest.mark.parametrize("case", sorted(COLUMNS))
def test_batched_columns_take_the_schedule_shape(case):
    """A per-agent column has the spawn schedule's shape: ``(B, N)`` in an
    ensemble, ``(N,)`` shared by every row of a sweep (the JAX vmap's
    axes); any other shape raises ValueError before a step."""
    kind, law_shape, scale_shape, accepted = COLUMNS[case]
    scene, params, cfg, state = column_scene(kind)
    upd = {}
    if law_shape is not None:
        upd["law_id"] = torch.full(law_shape, LAW_IDS["orca"],
                                   dtype=torch.int32)
    if scale_shape is not None:
        upd["pair_scale"] = torch.full(scale_shape, 0.5)
    scene = dataclasses.replace(scene, spawn=dataclasses.replace(
        scene.spawn, **upd))
    if not accepted:
        with pytest.raises(ValueError, match="pair_scale/law_id"):
            stepper.check_supported(scene, params, cfg, state)
        return
    stepper.check_supported(scene, params, cfg, state)
    scene = stepper.prepare_scene(scene, orca=True)
    nxt, _ = stepper.simulation_step(state, scene, params, cfg, 0)
    nxt, _ = stepper.simulation_step(nxt, scene, params, cfg, 1)
    assert nxt.pos_x.shape == (2, 8) and torch.isfinite(nxt.pos_x).all()


@pytest.mark.parametrize("case", ["groups", "agent axis", "autopilot fleet"])
def test_orca_batches_still_refuse_what_19b_holds(case):
    """With ORCA on, groups, an agent axis and the fleet run under a batch
    where they were refused (the test keeps the refusal's name): groups
    and the fleet through make_ensemble_rollout; over an agent axis (item
    19b.5) one step of an ensemble's slots split over a 2-shard LocalMesh,
    joined, is the step of the whole crowds within 1e-5 m (the sharded
    pair force sums its columns in another order), modes and alive
    equal."""
    from test_torch_ensemble import refusal_cases
    from carla_social_force_model_tpu_torch.parallel import make_mesh
    from carla_social_force_model_tpu_torch.parallel.sharding import (
        join_shards, shard_of)
    if case == "agent axis":
        scene, params, cfg, state = column_scene("ensemble")
        scene = stepper.prepare_scene(scene, orca=True)
        whole, _ = stepper.simulation_step(state, scene, params, cfg, 0)
        whole, _ = stepper.simulation_step(whole, scene, params, cfg, 1)
        scenes = [dataclasses.replace(scene, spawn=shard_of(scene.spawn, k,
                                                            2))
                  for k in range(2)]

        def two_steps(ax, st, sc):
            st, _ = stepper.simulation_step(st, sc, params, cfg, 0, axis=ax)
            return stepper.simulation_step(st, sc, params, cfg, 1,
                                           axis=ax)[0]

        got, _ = join_shards(make_mesh(2, device=CPU).run(
            two_steps, [shard_of(state, k, 2) for k in range(2)], scenes))
        assert torch.equal(got.alive, whole.alive)
        assert torch.equal(got.mode, whole.mode)
        assert (got.pos - whole.pos).abs().max() <= 1e-5
        assert bool(got.alive.any())
        return
    scene, params, cfg = refusal_cases()[case]
    params = dataclasses.replace(params, enable_orca=True)
    final, rec = sweeps.make_ensemble_rollout(scene, params, cfg, 2,
                                              record=True)(scene)
    if case == "autopilot fleet":
        rec, veh = rec
        assert veh.pos.shape[:2] == (2, 2)
    assert rec.pos.shape == (2, 2, 8, 2) and torch.isfinite(rec.pos).all()
    assert bool(final.alive.any())


def test_conversion_carries_swept_orca_leaves():
    """The JAX package's swept ORCA leaves arrive as float32 ``(B,)``
    tensors, the shape knobs as numbers; the step views them per row."""
    swept = jax_sweeps.batch_params(
        dataclasses.replace(jax_orca_sweep()[1]), orca_tau=[1.0, 2.0, 3.5],
        orca_neighbor_dist=np.float32([4.0, 7.3, 15.0]))
    pp = convert.params_from_fields(fields_of(swept))
    assert param_batch(pp) == 3 and pp.enable_orca
    for f in ("tau", "neighbor_dist", "tau_static"):
        leaf = getattr(pp.orca, f)
        assert leaf.shape == (3,) and leaf.dtype == torch.float32
        np.testing.assert_array_equal(leaf.numpy(),
                                      np.asarray(getattr(swept.orca, f)))
    assert pp.orca.window == 32 and pp.orca.max_statics == 3
    assert section_rows(pp.orca, 3)[1].neighbor_dist == np.float32(7.3)
