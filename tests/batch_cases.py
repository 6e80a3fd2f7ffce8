"""Shared cases of the batched kernels (ensembles and parameter sweeps) for
``tests/test_torch_cuda.py`` and ``chip_smoke.py``: batches of seeded
crowds, swept parameters, one launch of a batched kernel, the same rows
through the unbatched kernel, the plain batched version and the
tolerance each kernel is held to.

This module imports neither JAX nor the JAX package, so ``chip_smoke.py``
imports it on a machine without them.
"""
import dataclasses

import torch

from carla_social_force_model_tpu_torch.models.params import (
    MoussaidParams, PedRepulsiveParams, PowerLawParams, exp_rows, law_rows,
    section_rows)
from carla_social_force_model_tpu_torch.ops import (cuda_env, cuda_forces,
                                                    forces)
from carla_social_force_model_tpu_torch.ops.spatial import morton_order
from family_cases import ATOL as FAMILY_ATOL, RTOL as FAMILY_RTOL
from family_cases import family_planes

#: the batched pair kernels: (law, form) -> LAUNCHES key
PAIR_FORMS = {("moussaid", "sym"): "pair_force_sym_batched",
              ("moussaid", "dense"): "pair_force_dense_batched",
              ("powerlaw", "sym"): "powerlaw_sym_batched",
              ("powerlaw", "dense"): "powerlaw_dense_batched",
              ("helbing", "dense"): "helbing_dense_batched"}
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


def _kernel_args(law, planes):
    x, y, vx, vy, rad, alive, ex, ey = planes
    kw = dict(law=law)
    if law == "helbing":
        rad, kw["desired"] = None, (ex, ey)
    return (x, y, vx, vy, rad, alive), kw


def batch_run(law, form, planes, p):
    """One launch of the batched kernel of ``law`` in ``form`` on ``(B,
    n)`` planes with params ``p`` (shared, or with a swept leaf): ``(2, B,
    n)``."""
    args, kw = _kernel_args(law, planes)
    prm = law_rows(law, p, planes[0].shape[0], planes[0].device)
    fn = (cuda_forces.pair_force_sym_batched if form == "sym"
          else cuda_forces.pair_force_dense_batched)
    return torch.stack(fn(*args, prm, **kw))


def row_run(law, form, planes, p, b):
    """Row b through the unbatched kernel with row b's parameters: ``(2,
    n)``."""
    args, kw = _kernel_args(law, [t[b] for t in planes])
    if "desired" in kw:
        kw["desired"] = tuple(t.contiguous() for t in kw["desired"])
    args = tuple(None if t is None else t.contiguous() for t in args)
    prm = law_rows(law, p, planes[0].shape[0], planes[0].device)[b]
    fn = (cuda_forces.pair_force_sym if form == "sym"
          else cuda_forces.pair_force_dense)
    return torch.stack(fn(*args, prm.contiguous(), **kw))


def _family_reference(law, planes, p):
    """``family_cases.family_reference`` with the law's params ``p`` (a
    sweep's row): the plain version and its limit, 1e-4 + 1e-4 * sum_j
    |f_ij| for the power law, 1e-4 + 1e-4 * |f| for Helbing."""
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
        return torch.stack(forces._pair_sum(x, y, alive, pair, 1024, None,
                                            None))

    want = plain(False)
    scale = plain(True) if law == "powerlaw" else want.abs()
    return want, FAMILY_ATOL + FAMILY_RTOL * scale


def batch_reference(law, planes, p):
    """``(want, limit)``, ``(2, B, n)`` each: the plain version row by row
    with row b's parameters, and the elementwise limit of a kernel's error
    (``ATOL`` for the Moussaid law, ``family_cases`` for the families)."""
    batch = planes[0].shape[0]
    wants, limits = [], []
    for b, pb in enumerate(section_rows(p, batch)):
        row = [t[b] for t in planes]
        if law == "moussaid":
            want = torch.stack(cuda_forces.plain_law_force(
                law, *row[:6], pb, False, 1024, None, None))
            limit = ATOL + RTOL * want.abs()
        else:
            want, limit = _family_reference(law, row, pb)
        wants.append(want)
        limits.append(limit)
    return torch.stack(wants, dim=1), torch.stack(limits, dim=1)


def pair_mismatch(law, form, planes, p, got=None, ref=None):
    """How a batched pair launch ``got`` (launched here when None) agrees:
    ``err`` its largest error against the plain batched version (``ref``,
    ``batch_reference``'s ``(want, limit)``, computed when None) and
    ``over`` the elements over their limit; ``rows_equal`` whether every
    row equals the unbatched launch on that row bitwise, ``row_err`` the
    largest difference from it and ``row_over`` the elements farther from
    it than twice their limit (each launch within its limit of the plain
    version)."""
    got = batch_run(law, form, planes, p) if got is None else got
    want, limit = batch_reference(law, planes, p) if ref is None else ref
    err = (got - want).abs()
    rows = torch.stack([row_run(law, form, planes, p, b)
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


def env_batch_run(kernel, planes, seg, args, active, batched=True):
    """One launch of the batched environment kernel (or, with ``batched``
    False, its plain batched version) on sorted ``(B, n)`` planes:
    ``(2, B, n)``."""
    px, py, vx, vy, rad, alive = planes
    if kernel == "env_exp":
        fn = (cuda_env.env_exp_batched if batched
              else cuda_env.forces.env_exp_force_batched)
        return torch.stack(fn(px, py, rad, alive, seg, *args, active=active))
    fn = (cuda_env.env_moussaid_batched if batched
          else cuda_env.forces.env_moussaid_force_batched)
    return torch.stack(fn(px, py, vx, vy, rad, alive, seg, *args,
                          active=active))


def env_row_run(kernel, planes, seg, args, active, b):
    """Row b through the unbatched environment kernel with row b's
    parameters and filter radii: ``(2, n)``."""
    px, py, vx, vy, rad, alive = (t[b].contiguous() for t in planes)
    batch = planes[0].shape[0]
    if seg.filter_radius.dim() == 2:
        seg = dataclasses.replace(seg, filter_radius=seg.filter_radius[b])
    if kernel == "env_exp":
        a, bb = exp_rows(*args, batch, px.device)[b].tolist()
        return torch.stack(cuda_env.env_exp(px, py, rad, alive, seg, a, bb,
                                            active=active))
    ovel, p = args
    return torch.stack(cuda_env.env_moussaid(
        px, py, vx, vy, rad, alive, seg, ovel, section_rows(p, batch)[b],
        active=active))


def env_mismatch(kernel, planes, seg, args, active, got=None):
    """``(err, over, rows_equal)`` of a batched environment launch against
    its plain batched version (ENV_ATOL + ENV_RTOL * |f|) and the
    unbatched kernel row by row (bitwise)."""
    got = (env_batch_run(kernel, planes, seg, args, active) if got is None
           else got)
    want = env_batch_run(kernel, planes, seg, args, active, batched=False)
    err = (got - want).abs()
    over = int((err > ENV_ATOL + ENV_RTOL * want.abs()).sum())
    equal = all(torch.equal(got[:, b],
                            env_row_run(kernel, planes, seg, args, active, b))
                for b in range(planes[0].shape[0]))
    return err.max().item(), over, equal



def one_step_gaps(scene, params, cfg, state, steps):
    """The kernels' batched rollout of ``steps`` steps and, from each of
    its states, the plain versions' step: yields ``(k, gap, equal,
    finite)`` with the per-row L-inf position gap ``(B,)`` of step k,
    whether modes and alive masks are equal and whether the kernels'
    positions are finite (``check_rollout``'s rule, per row)."""
    from carla_social_force_model_tpu_torch.models import stepper
    plain = dataclasses.replace(cfg, plain_pair_force=True,
                                plain_env_force=True)
    scene = stepper.prepare_scene(scene)
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
