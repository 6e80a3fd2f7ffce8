"""Shared cases of the batched kernels (ensembles and parameter sweeps) for
``tests/test_torch_cuda.py`` and ``chip_smoke.py``: batches of seeded
crowds, swept parameters, one launch of a batched kernel (with a cutoff,
on rows sorted along their own curves, through the batched launch plan),
the same rows through the unbatched kernel, the plain batched version and
the tolerance each kernel is held to.

This module imports neither JAX nor the JAX package, so ``chip_smoke.py``
imports it on a machine without them.
"""
import dataclasses

import torch

from carla_social_force_model_tpu_torch.models.params import (
    MoussaidParams, PedRepulsiveParams, PowerLawParams, exp_rows, law_rows,
    section_rows)
from carla_social_force_model_tpu_torch.ops import (cuda_env, cuda_forces,
                                                    forces, pair_grid)
from carla_social_force_model_tpu_torch.ops.spatial import morton_order
from family_cases import ATOL as FAMILY_ATOL, RTOL as FAMILY_RTOL
from family_cases import family_planes

#: the batched pair kernels: (law, form) -> LAUNCHES key
PAIR_FORMS = {("moussaid", "sym"): "pair_force_sym_batched",
              ("moussaid", "dense"): "pair_force_dense_batched",
              ("powerlaw", "sym"): "powerlaw_sym_batched",
              ("powerlaw", "dense"): "powerlaw_dense_batched",
              ("helbing", "dense"): "helbing_dense_batched"}
#: the batched cutoff pair kernels: (law, form) -> LAUNCHES key, where
#: form is the walk of the batched grid that drives it
CUTOFF_FORMS = {
    (law, form): f"{cuda_forces.LAWS[law][0]}_{form}_batched"
    for law in ("moussaid", "powerlaw", "helbing")
    for form in ("sym_cutoff", "sym_compact", "dense_cutoff", "compact")
    if law != "helbing" or not form.startswith("sym")}
#: Moussaid kernels vs plain version: |err| <= ATOL + RTOL * |f| (f32
#: summation order; the symmetric kernel's atomics vary it from run to
#: run), as the unbatched kernels are held; the families keep theirs
#: (family_cases.ATOL)
ATOL = RTOL = 1e-4
#: environment kernels vs plain version (both pick the same closest point
#: and filter outcome; last-ulp differences of rsqrt, exp, atan2)
ENV_ATOL = ENV_RTOL = 1e-5
#: the swept leaf of each law's params: row b's value is its default
#: times SWEEP_SCALE[b % 4]
SWEPT = {MoussaidParams: "A", PowerLawParams: "k", PedRepulsiveParams: "v0"}
SWEEP_SCALE = (0.25, 1.0, 2.0, 4.0)


def law_params(law):
    return {"moussaid": MoussaidParams, "powerlaw": PowerLawParams,
            "helbing": PedRepulsiveParams}[law]()


def swept(p, batch, device):
    """``p`` with its law's swept leaf (``SWEPT``) a ``(batch,)`` tensor
    and every other leaf shared."""
    name = SWEPT[type(p)]
    scale = torch.tensor([SWEEP_SCALE[b % 4] for b in range(batch)],
                         dtype=torch.float32)
    return dataclasses.replace(
        p, **{name: (scale * getattr(p, name)).to(device)})


def batch_planes(batch, n, seed, device, extent=None):
    """``batch`` seeded crowds of ``family_cases.family_planes`` (row b from
    seed ``seed + b``: 10% dead, one coincident live pair, unit desired
    directions) as ``(batch, n)`` planes x, y, vx, vy, radius, alive, ex,
    ey."""
    rows = [family_planes(n, seed + b, device, extent) for b in range(batch)]
    return [torch.stack(col).contiguous() for col in zip(*rows)]


def sort_rows(planes):
    """``(B, n)`` planes with each row in its own Hilbert order, as the
    batched cutoff path gives them to its kernels."""
    perm, _ = morton_order(planes[0], planes[1], planes[5], "hilbert")
    return [t.gather(-1, perm).contiguous() for t in planes]


def cutoff_grid_of(form, planes, cutoff, max_surv=0):
    """The batched grid of sorted ``planes`` that drives ``form``: the box
    forms without a table, the table forms with a table ``max_surv`` wide
    (0: the automatic gate, which must engage)."""
    grid = pair_grid.cutoff_grid(planes[0], planes[1], planes[5], cutoff,
                                 symmetric=form.startswith("sym"),
                                 compact=form.endswith("compact"),
                                 max_surv=max_surv)
    if grid.form != form:
        raise ValueError(f"the grid drives {grid.form}, not {form}: give "
                         f"the table forms a max_surv below a row's tiles")
    return grid


def row_grid(grid, b):
    """Crowd b's grid of a batched one (equal to the grid of row b
    alone, which holds no chunk boxes)."""
    def row(t):
        return None if t is None else t[b].contiguous()
    return grid._replace(boxes=row(grid.boxes), surv=row(grid.surv),
                         counts=row(grid.counts), chunk_boxes=None)


def _kernel_args(law, planes):
    x, y, vx, vy, rad, alive, ex, ey = planes
    kw = dict(law=law)
    if law == "helbing":
        rad, kw["desired"] = None, (ex, ey)
    return (x, y, vx, vy, rad, alive), kw


def batch_run(law, form, planes, p, grid=None):
    """One launch of the batched kernel of ``law`` in ``form`` on ``(B,
    n)`` planes with params ``p`` (shared, or with a swept leaf): ``(2, B,
    n)``.  The cutoff forms take the batched ``grid`` of the same sorted
    planes (:func:`cutoff_grid_of`)."""
    args, kw = _kernel_args(law, planes)
    prm = law_rows(law, p, planes[0].shape[0], planes[0].device)
    if grid is not None:
        return torch.stack(cuda_forces.pair_force_cutoff_batched(
            *args, prm, grid, **kw))
    fn = (cuda_forces.pair_force_sym_batched if form == "sym"
          else cuda_forces.pair_force_dense_batched)
    return torch.stack(fn(*args, prm, **kw))


def row_run(law, form, planes, p, b, grid=None):
    """Row b through the unbatched kernel with row b's parameters (and,
    with a batched ``grid``, row b's grid): ``(2, n)``."""
    args, kw = _kernel_args(law, [t[b] for t in planes])
    if "desired" in kw:
        kw["desired"] = tuple(t.contiguous() for t in kw["desired"])
    args = tuple(None if t is None else t.contiguous() for t in args)
    prm = law_rows(law, p, planes[0].shape[0], planes[0].device)[b]
    if grid is not None:
        return torch.stack(cuda_forces.pair_force_cutoff(
            *args, prm.contiguous(), row_grid(grid, b), **kw))
    fn = (cuda_forces.pair_force_sym if form == "sym"
          else cuda_forces.pair_force_dense)
    return torch.stack(fn(*args, prm.contiguous(), **kw))


def _family_reference(law, planes, p, cutoff=None):
    """``family_cases.family_reference`` with the law's params ``p`` (a
    sweep's row) and ``cutoff``: the plain version and its limit, 1e-4 +
    1e-4 * sum_j |f_ij| for the power law, 1e-4 + 1e-4 * |f| for
    Helbing."""
    x, y, vx, vy, rad, alive, ex, ey = planes

    def plain(magnitudes):
        def pair(r, dx, dy, ok):
            if law == "powerlaw":
                f = forces._powerlaw_pair_force(
                    dx, dy, rad[r, None] + rad[None, :],
                    vx[r, None] - vx[None, :], vy[r, None] - vy[None, :], p,
                    ok)
            else:
                f = forces._helbing_pair_force(
                    -dx, -dy, p.step_width * vx[None, :],
                    p.step_width * vy[None, :], ex[r, None], ey[r, None], p,
                    ok)
            return tuple(c.abs() for c in f) if magnitudes else f
        return torch.stack(forces._pair_sum(x, y, alive, pair, 1024,
                                            cutoff, None))

    want = plain(False)
    scale = plain(True) if law == "powerlaw" else want.abs()
    return want, FAMILY_ATOL + FAMILY_RTOL * scale


def batch_reference(law, planes, p, cutoff=None):
    """``(want, limit)``, ``(2, B, n)`` each: the plain version row by row
    with row b's parameters and ``cutoff``, and the elementwise limit of a
    kernel's error (``ATOL`` for the Moussaid law, ``family_cases`` for the
    families)."""
    batch = planes[0].shape[0]
    wants, limits = [], []
    for b, pb in enumerate(section_rows(p, batch)):
        row = [t[b] for t in planes]
        if law == "moussaid":
            want = torch.stack(cuda_forces.plain_law_force(
                law, *row[:6], pb, False, 1024, cutoff, None))
            limit = ATOL + RTOL * want.abs()
        else:
            want, limit = _family_reference(law, row, pb, cutoff)
        wants.append(want)
        limits.append(limit)
    return torch.stack(wants, dim=1), torch.stack(limits, dim=1)


def pair_mismatch(law, form, planes, p, got=None, ref=None, grid=None,
                  cutoff=None):
    """How a batched pair launch ``got`` (launched here when None) agrees:
    ``err`` its largest error against the plain batched version (``ref``,
    ``batch_reference``'s ``(want, limit)``, computed when None) and
    ``over`` the elements over their limit; ``rows_equal`` whether every
    row equals the unbatched launch on that row bitwise, ``row_err`` the
    largest difference from it and ``row_over`` the elements farther from
    it than twice their limit (each launch within its limit of the plain
    version).  A cutoff form takes its batched ``grid`` and ``cutoff``."""
    got = batch_run(law, form, planes, p, grid) if got is None else got
    want, limit = (batch_reference(law, planes, p, cutoff) if ref is None
                   else ref)
    err = (got - want).abs()
    rows = torch.stack([row_run(law, form, planes, p, b, grid)
                        for b in range(planes[0].shape[0])], dim=1)
    row_gap = (got - rows).abs()
    return dict(err=err.max().item(), over=int((err > limit).sum()),
                rows_equal=torch.equal(got, rows),
                row_err=row_gap.max().item(),
                row_over=int((row_gap > 2 * limit).sum()))


def sorted_rows(state):
    """A batched state's planes (x, y, vx, vy, radius, alive), each row in
    its own Hilbert order, as the batched environment kernels read them."""
    perm, _ = morton_order(state.pos_x, state.pos_y, state.alive, "hilbert")
    return [a.gather(-1, perm).contiguous() for a in (
        state.pos_x, state.pos_y, state.vel_x, state.vel_y, state.radius,
        state.alive)]


def env_jobs(scene, snap, params):
    """Config #3's environment jobs: ``{label: (kernel, segments, args,
    active)}`` with the exp jobs' ``(a, b)`` and the Moussaid jobs'
    ``(obstacle_vel, params)`` (params shared, or swept)."""
    from carla_social_force_model_tpu_torch.models import vehicles
    dyn, dvel, dact = vehicles.snapshot_segment_pointset(
        snap, params.dynamic_obstacle.perception_threshold)
    return {
        "borders": ("env_exp", scene.borders_seg,
                    (params.border.a, params.border.b), None),
        "parked cars": ("env_moussaid", scene.static_obstacles_seg,
                        (scene.static_obstacle_vel, params.static_obstacle),
                        None),
        "vehicles": ("env_moussaid", dyn, (dvel.contiguous(),
                                           params.dynamic_obstacle), dact)}


#: the unbatched environment wrappers by (kernel, survivor table)
_ENV_ROW = {("env_exp", False): "env_exp", ("env_exp", True): "env_exp_compact",
            ("env_exp_analytic", False): "env_exp_analytic",
            ("env_exp_analytic", True): "env_exp_analytic_compact",
            ("env_moussaid", False): "env_moussaid",
            ("env_moussaid", True): "env_moussaid_compact"}


def env_batched_name(kernel, grid=None):
    """The LAUNCHES key (and wrapper) of the batched form of ``kernel``
    (``env_exp``, ``env_exp_analytic``, ``env_moussaid``), compacted with a
    ``grid``."""
    return _ENV_ROW[kernel, grid is not None] + "_batched"


def env_grid_of(planes, seg, active, max_surv=0):
    """The batched survivor table of sorted ``(B, n)`` planes for the job
    of ``seg`` (its own ``(B, S)`` radii if it has them) under the JAX
    package's gate with ``max_surv`` (0: auto), which must engage."""
    from carla_social_force_model_tpu_torch.ops import env_grid as eg
    engage, group, ms = eg.env_gate(seg.num_segments,
                                    forces.section_slots(seg), True,
                                    max_surv)
    if not engage:
        raise ValueError(f"the gate does not engage for {seg.num_segments} "
                         f"sections of {forces.section_slots(seg)} slots "
                         f"with max_surv={max_surv}")
    return eg.env_grid(planes[0], planes[1], planes[5], seg,
                       cuda_env.filter_r2(seg, active), group, ms)


def env_row_grid(grid, b):
    """Crowd b's table of a batched one (equal to the table of row b
    alone)."""
    return grid._replace(surv=grid.surv[b].contiguous(),
                         counts=grid.counts[b].contiguous())


def env_batch_run(kernel, planes, seg, args, active, batched=True,
                  grid=None):
    """One launch of the batched environment kernel (compacted over
    ``grid``, the batched table of the same planes) or, with ``batched``
    False, its plain batched version on sorted ``(B, n)`` planes:
    ``(2, B, n)``.  ``kernel``: ``env_exp``, ``env_exp_analytic`` (``seg``
    a SegmentGeomSet) or ``env_moussaid``."""
    px, py, vx, vy, rad, alive = planes
    table = () if grid is None else (grid,)
    moussaid = kernel == "env_moussaid"
    if batched:
        fn = getattr(cuda_env, env_batched_name(kernel, grid))
    else:
        table = ()
        fn = (cuda_env.forces.env_moussaid_force_batched if moussaid
              else cuda_env.forces.env_exp_force_batched)
    vel = (vx, vy) if moussaid else ()
    return torch.stack(fn(px, py, *vel, rad, alive, seg, *args, *table,
                          active=active))


def env_row_run(kernel, planes, seg, args, active, b, grid=None):
    """Row b through the unbatched environment kernel (compacted over row
    b's rows of ``grid``) with row b's parameters and filter radii:
    ``(2, n)``."""
    px, py, vx, vy, rad, alive = (t[b].contiguous() for t in planes)
    batch = planes[0].shape[0]
    if seg.filter_radius.dim() == 2:
        seg = dataclasses.replace(seg, filter_radius=seg.filter_radius[b])
    fn = getattr(cuda_env, _ENV_ROW[kernel, grid is not None])
    table = () if grid is None else (env_row_grid(grid, b),)
    if kernel != "env_moussaid":
        a, bb = exp_rows(*args, batch, px.device)[b].tolist()
        return torch.stack(fn(px, py, rad, alive, seg, a, bb, *table,
                              active=active))
    ovel, p = args
    return torch.stack(fn(px, py, vx, vy, rad, alive, seg, ovel,
                          section_rows(p, batch)[b], *table, active=active))


def env_mismatch(kernel, planes, seg, args, active, got=None, grid=None,
                 want=None):
    """``(err, over, rows_equal)`` of a batched environment launch
    (compacted over ``grid``) against its plain batched version (ENV_ATOL
    + ENV_RTOL * |f|; ``want`` when the caller has computed it) and the
    unbatched kernel row by row, with row b's table (bitwise)."""
    got = (env_batch_run(kernel, planes, seg, args, active, grid=grid)
           if got is None else got)
    want = (env_batch_run(kernel, planes, seg, args, active, batched=False)
            if want is None else want)
    err = (got - want).abs()
    over = int((err > ENV_ATOL + ENV_RTOL * want.abs()).sum())
    equal = all(torch.equal(got[:, b], env_row_run(kernel, planes, seg, args,
                                                   active, b, grid))
                for b in range(planes[0].shape[0]))
    return err.max().item(), over, equal


def scan_rows(px, py, fx, fy):
    """The batched chunk scan of ``(B, n)`` planes (one launch) and each
    row through the unbatched scan: ``((dmin, idx) (C, B, n), [(dmin,
    idx) (C, n) of each row])``."""
    from carla_social_force_model_tpu_torch.ops import geometry
    got = geometry.chunk_argmin(px, py, fx, fy)
    rows = [geometry.chunk_argmin(px[b].contiguous(), py[b].contiguous(), fx,
                                  fy) for b in range(px.shape[0])]
    return got, rows


def one_step_gaps(scene, params, cfg, state, steps):
    """The kernels' batched rollout of ``steps`` steps and, from each of
    its states, the plain versions' step: yields ``(k, gap, equal,
    finite)`` with the per-row L-inf position gap ``(B,)`` of step k,
    whether modes and alive masks are equal and whether the kernels'
    positions are finite (``check_rollout``'s rule, per row)."""
    from carla_social_force_model_tpu_torch.models import stepper
    plain = dataclasses.replace(cfg, plain_pair_force=True,
                                plain_env_force=True)
    scene = stepper.prepare_scene(scene, analytic=cfg.env_analytic,
                                  orca=params.enable_orca,
                                  chunked=cfg.env_chunked)
    s = state
    for k in range(steps):
        nxt, _ = stepper.simulation_step(s, scene, params, cfg, k)
        ref, _ = stepper.simulation_step(s, scene, params, plain, k)
        gap = torch.maximum((nxt.pos_x - ref.pos_x).abs(),
                            (nxt.pos_y - ref.pos_y).abs()).amax(dim=-1)
        equal = (torch.equal(nxt.mode, ref.mode)
                 and torch.equal(nxt.alive, ref.alive))
        finite = bool(torch.isfinite(nxt.pos_x).all()
                      and torch.isfinite(nxt.pos_y).all())
        yield k, gap, equal, finite
        s = nxt


# -- a batch of fleets: the per-crowd environment forms ------------------------

def fleet_batch(fleet, batch, seed, spread=4.0):
    """``batch`` fleet states of ``fleet`` (an AutopilotFleet) with every
    row's vehicles in their own places: each vehicle moved up to
    ``spread`` m off its route start, its own heading and speed, about one
    in five inactive.  Returns the batched AutopilotState."""
    import numpy as np
    rng = np.random.default_rng(seed)
    st = fleet.initial_state(batch)
    v, dev = fleet.num_vehicles, fleet.device

    def draw(lo, hi, shape):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
            np.float32)).to(dev)

    return dataclasses.replace(
        st, pos=st.pos + draw(-spread, spread, (batch, v, 2)),
        heading=draw(-3.0, 3.0, (batch, v)), speed=draw(0.0, 8.0, (batch, v)),
        active=draw(0.0, 1.0, (batch, v)) < 0.8)


def fleet_rows(fleet, state):
    """Each row of a batched fleet state as its own fleet's snapshot:
    ``(batched snapshot, [row snapshots])``."""
    from carla_social_force_model_tpu_torch.models import autopilot
    snap = autopilot.autopilot_snapshot(fleet, state)
    rows = [autopilot.autopilot_snapshot(fleet, autopilot.AutopilotState(
        **{f.name: getattr(state, f.name)[r].contiguous()
           for f in dataclasses.fields(state)}))
        for r in range(state.batch)]
    return snap, rows


def fleet_crowd(state, n, seed, spread=8.0):
    """``(B, n)`` crowds around each row's own vehicles (within ``spread``
    m of a seeded vehicle of the row), 10% dead, each row in its own
    Hilbert order: x, y, vx, vy, radius, alive."""
    import numpy as np
    rng = np.random.default_rng(seed)
    b, v = state.speed.shape
    dev = state.pos.device
    pick = torch.from_numpy(rng.integers(0, v, (b, n))).to(dev)
    near = state.pos[torch.arange(b, device=dev)[:, None], pick]

    def draw(lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, (b, n)).astype(
            np.float32)).to(dev)

    x = near[..., 0] + draw(-spread, spread)
    y = near[..., 1] + draw(-spread, spread)
    planes = [x, y, draw(-1.5, 1.5), draw(-1.5, 1.5),
              torch.full((b, n), 0.3, device=dev), draw(0.0, 1.0) < 0.9]
    return sort_rows(planes)


def percrowd_jobs(snap, rows, threshold):
    """The dynamic-obstacle job of a batch of fleets and of each row's own:
    ``(seg, obstacle_vel, active)`` of the batch (each crowd's own rows)
    and ``[(seg, obstacle_vel, active)]`` of every row; ``threshold`` a
    number or a sweep's ``(B,)`` tensor of perception thresholds."""
    from carla_social_force_model_tpu_torch.models import vehicles
    job = vehicles.snapshot_segment_pointset(snap, threshold)
    one = [vehicles.snapshot_segment_pointset(
        r, threshold if not isinstance(threshold, torch.Tensor)
        else float(threshold[b])) for b, r in enumerate(rows)]
    return tuple(t.contiguous() if isinstance(t, torch.Tensor) else t
                 for t in job), one


def percrowd_grid(planes, seg, active, max_surv):
    """The batched survivor table of the per-crowd job (each crowd's table
    from its own circles) under the JAX package's gate with ``max_surv``,
    which must engage."""
    return env_grid_of(planes, seg, active, max_surv)


def percrowd_run(planes, job, p, grid=None, batched=True):
    """One launch of ``env_moussaid_percrowd`` (``env_moussaid_compact_
    percrowd`` over ``grid``) or, with ``batched`` False, its plain batched
    version: ``(2, B, n)``."""
    px, py, vx, vy, rad, alive = planes
    seg, ov, act = job
    if not batched:
        return torch.stack(forces.env_moussaid_force_batched(
            px, py, vx, vy, rad, alive, seg, ov, p, active=act))
    if grid is None:
        return torch.stack(cuda_env.env_moussaid_percrowd(
            px, py, vx, vy, rad, alive, seg, ov, p, active=act))
    return torch.stack(cuda_env.env_moussaid_compact_percrowd(
        px, py, vx, vy, rad, alive, seg, ov, p, grid, active=act))


def percrowd_row_run(planes, one_job, p, b, grid=None):
    """Row b through the unbatched Moussaid kernel on its own set
    (compacted over row b's table): ``(2, n)``."""
    px, py, vx, vy, rad, alive = (t[b].contiguous() for t in planes)
    seg, ov, act = one_job
    if grid is None:
        return torch.stack(cuda_env.env_moussaid(
            px, py, vx, vy, rad, alive, seg, ov.contiguous(), p,
            active=act))
    return torch.stack(cuda_env.env_moussaid_compact(
        px, py, vx, vy, rad, alive, seg, ov.contiguous(), p,
        env_row_grid(grid, b), active=act))


def percrowd_mismatch(planes, job, rows_jobs, p, got, grid=None, want=None):
    """``(err, over, rows_equal)`` of a per-crowd launch against its plain
    batched version (ENV_ATOL + ENV_RTOL * |f|; ``want`` when the caller
    has it) and, row by row, the unbatched kernel on that row's own set
    with its table (bitwise)."""
    want = percrowd_run(planes, job, p, batched=False) if want is None \
        else want
    err = (got - want).abs()
    over = int((err > ENV_ATOL + ENV_RTOL * want.abs()).sum())
    equal = all(torch.equal(got[:, b], percrowd_row_run(planes, one, p, b,
                                                        grid))
                for b, one in enumerate(rows_jobs))
    return err.max().item(), over, equal


def percrowd_scan(planes, snap, rows, threshold=4.0):
    """The per-crowd chunk scan of each row's vehicle chunks (one launch)
    and each row through the unbatched scan of its own chunks: ``((dmin,
    idx) (C, B, n), [(dmin, idx) (C, n) of each row], (fx, fy) (B, C,
    K))``."""
    from carla_social_force_model_tpu_torch.models import vehicles
    from carla_social_force_model_tpu_torch.ops import geometry
    px, py = planes[0], planes[1]
    cset, _, _ = vehicles.snapshot_pointset(snap, threshold)
    fx, fy = (a.contiguous() for a in geometry.staged_chunk_planes(cset))
    got = geometry.chunk_argmin(px, py, fx, fy)
    one = []
    for b, r in enumerate(rows):
        rset, _, _ = vehicles.snapshot_pointset(r, threshold)
        rfx, rfy = (a.contiguous()
                    for a in geometry.staged_chunk_planes(rset))
        one.append(geometry.chunk_argmin(px[b].contiguous(),
                                         py[b].contiguous(), rfx, rfy))
    return got, one, (fx, fy)


def fleet_step_gaps(scene, params, cfg, state, fleet_state, steps):
    """The kernels' batched rollout with the fleet (``stepper.fleet_tick``)
    of ``steps`` steps and, from each of its states, the plain versions'
    tick: yields ``(k, gap, equal, finite)`` as :func:`one_step_gaps`,
    ``equal`` covering the fleet states too (the fleet reads the same
    walkers on both sides, so its step is the same)."""
    from carla_social_force_model_tpu_torch.models import stepper
    plain = dataclasses.replace(cfg, plain_pair_force=True,
                                plain_env_force=True)
    scene = stepper.prepare_scene(scene, analytic=cfg.env_analytic,
                                  orca=params.enable_orca,
                                  chunked=cfg.env_chunked)
    s, fl = state, fleet_state
    for k in range(steps):
        nxt, nfl, _ = stepper.fleet_tick(s, fl, scene, params, cfg, k)
        ref, rfl, _ = stepper.fleet_tick(s, fl, scene, params, plain, k)
        gap = torch.maximum((nxt.pos_x - ref.pos_x).abs(),
                            (nxt.pos_y - ref.pos_y).abs()).amax(dim=-1)
        equal = (torch.equal(nxt.mode, ref.mode)
                 and torch.equal(nxt.alive, ref.alive)
                 and all(torch.equal(getattr(nfl, f.name),
                                     getattr(rfl, f.name))
                         for f in dataclasses.fields(nfl)))
        finite = bool(torch.isfinite(nxt.pos_x).all()
                      and torch.isfinite(nxt.pos_y).all())
        yield k, gap, equal, finite
        s, fl = nxt, nfl
