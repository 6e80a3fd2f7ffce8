"""CUDA environment-force kernels and the fused environment terms (port of
ops/pallas_env.py, dense form with sampled points).

Two kernels from ``csrc/env_forces.cu``, each behind a wrapper that checks
its inputs, allocates its outputs, launches on PyTorch's current stream and
counts the launch:

* :func:`env_exp` -- ``a * exp(-d/b)`` away from each segment's closest
  point: the border force (``a``, ``b``) and the space-repulsive force
  (``u0/r``, ``r``).  The JAX package's ``_exp_kernel``.
* :func:`env_moussaid` -- the Moussaid interaction against each segment's
  closest point with the obstacle's velocity: the static and dynamic
  obstacle forces.  The JAX package's ``_moussaid_kernel``.

On CPU tensors each wrapper runs its plain PyTorch version
(``ops/forces.py``); on CUDA tensors it launches the kernel or raises.
No path falls back from the kernel to the plain version.

:func:`fused_environment_terms` sorts the pedestrians once per step along
the Hilbert curve (the kernels skip, per block of consecutive pedestrians,
every segment whose filter circle misses the block), launches one kernel
per term on the sorted planes, scatters each result back to slot order and
applies the crossing-mode rule of the border-family terms.
"""
from __future__ import annotations

import torch

from . import forces
from .spatial import morton_order
from ..models.params import MoussaidParams, moussaid_vector

#: launches per kernel since the last :func:`reset_launch_counts`; each
#: wrapper adds one where it launches its kernel and nowhere else
LAUNCHES = {"env_exp": 0, "env_moussaid": 0}

#: where each still-unported form of the JAX environment kernels belongs
_UNPORTED_FORMS = {"compact": "urban", "analytic": "analytic border"}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_planes(planes, alive, dev):
    n = planes[0].shape[0]
    for t in planes:
        if (t.device != dev or t.dtype != torch.float32 or t.shape != (n,)
                or not t.is_contiguous()):
            raise ValueError("pedestrian planes must be contiguous float32 "
                             f"({n},) tensors on {dev}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if (alive.device != dev or alive.dtype != torch.bool
            or alive.shape != (n,) or not alive.is_contiguous()):
        raise ValueError(f"alive must be a contiguous bool ({n},) tensor on "
                         f"{dev}")


def _check_segments(seg, extra, dev):
    s, k = seg.x.shape
    for name, t, shape in (("x", seg.x, (s, k)), ("y", seg.y, (s, k)),
                           ("center_x", seg.center_x, (s,)),
                           ("center_y", seg.center_y, (s,)), *extra):
        if (t.device != dev or t.dtype != torch.float32 or t.shape != shape
                or not t.is_contiguous()):
            raise ValueError(f"segment {name} must be a contiguous float32 "
                             f"{shape} tensor on {dev}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def filter_r2(seg, active=None) -> torch.Tensor:
    """(S,) squared filter radius as the kernels read it: ``r*r`` of the
    radius clamped at 0, and -1 (never inside) for inactive segments."""
    r = torch.clamp(seg.filter_radius, min=0.0)
    r2 = r * r
    return r2 if active is None else torch.where(active, r2, -1.0)


def _launch(name, lib_args_fn, pos_x):
    from ..utils.cuda_build import load_kernels
    fx = torch.empty_like(pos_x)
    fy = torch.empty_like(pos_x)
    n = pos_x.shape[0]
    if n == 0:
        return fx, fy
    lib = load_kernels()
    with torch.cuda.device(pos_x.device):
        stream = torch.cuda.current_stream(pos_x.device).cuda_stream
        err = getattr(lib, f"sfm_{name}")(*lib_args_fn(n, fx, fy), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.sfm_cuda_error_string(err).decode()})")
    LAUNCHES[name] += 1
    return fx, fy


def _device_of(pos_x) -> str:
    dev = pos_x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no environment-force path for device {dev}")
    return dev.type


def env_exp(pos_x, pos_y, radius, alive, seg, a: float, b: float,
            use_radius: bool = False, active=None):
    """Exp-magnitude environment force ``(fx, fy)``: ``a * exp(-d/b)`` away
    from each segment's closest point, summed over the segments whose
    filter circle holds the pedestrian (``ops/forces.env_exp_force``).
    ``seg`` is a :class:`..env.pointsets.SegmentPointSet` on the planes'
    device; ``active`` an optional (S,) mask of segments that act."""
    if _device_of(pos_x) == "cpu":
        return forces.env_exp_force(pos_x, pos_y, radius, alive, seg, a, b,
                                    use_radius=use_radius, active=active)
    dev = pos_x.device
    _check_planes((pos_x, pos_y, radius), alive, dev)
    _check_segments(seg, (), dev)
    r2 = filter_r2(seg, active)
    s, k = seg.x.shape

    def args(n, fx, fy):
        return (pos_x.data_ptr(), pos_y.data_ptr(), radius.data_ptr(),
                alive.data_ptr(), seg.x.data_ptr(), seg.y.data_ptr(), k,
                seg.center_x.data_ptr(), seg.center_y.data_ptr(),
                r2.data_ptr(), s, float(a), float(b), int(use_radius), n,
                fx.data_ptr(), fy.data_ptr())

    return _launch("env_exp", args, pos_x)


def env_moussaid(pos_x, pos_y, vel_x, vel_y, radius, alive, seg,
                 obstacle_vel, p: MoussaidParams, use_radius: bool = False,
                 active=None):
    """Moussaid obstacle force ``(fx, fy)`` against each segment's closest
    point, with the relative velocity ``v_ped - obstacle_vel[s]``
    (``ops/forces.env_moussaid_force``).  ``obstacle_vel`` is (S, 2)."""
    if _device_of(pos_x) == "cpu":
        return forces.env_moussaid_force(
            pos_x, pos_y, vel_x, vel_y, radius, alive, seg, obstacle_vel, p,
            use_radius=use_radius, active=active)
    dev = pos_x.device
    _check_planes((pos_x, pos_y, vel_x, vel_y, radius), alive, dev)
    s, k = seg.x.shape
    _check_segments(seg, (("velocity", obstacle_vel, (s, 2)),), dev)
    r2 = filter_r2(seg, active)
    prm = moussaid_vector(p, dev)

    def args(n, fx, fy):
        return (pos_x.data_ptr(), pos_y.data_ptr(), vel_x.data_ptr(),
                vel_y.data_ptr(), radius.data_ptr(), alive.data_ptr(),
                seg.x.data_ptr(), seg.y.data_ptr(), k,
                seg.center_x.data_ptr(), seg.center_y.data_ptr(),
                r2.data_ptr(), obstacle_vel.data_ptr(), s, prm.data_ptr(),
                int(use_radius), n, fx.data_ptr(), fy.data_ptr())

    return _launch("env_moussaid", args, pos_x)


def environment_jobs(scene, params, veh_snap):
    """The environment terms this step computes, in the JAX package's
    order: ``(name, kind, segments, args, use_radius, active)`` with
    ``args`` ``(a, b)`` for the exp kind and ``(obstacle_vel, params)``
    for the Moussaid kind."""
    from ..models.vehicles import snapshot_segment_pointset
    jobs = []
    if params.enable_border and scene.borders_seg is not None:
        b = params.border
        jobs.append(("border_force", "exp", scene.borders_seg, (b.a, b.b),
                     params.use_ped_radius, None))
    if params.enable_space_repulsive and scene.borders_seg is not None:
        sp = params.space_repulsive
        jobs.append(("space_repulsive_force", "exp", scene.borders_seg,
                     (sp.u0 / sp.r, sp.r), False, None))
    if (params.enable_static_obstacle
            and scene.static_obstacles_seg is not None):
        jobs.append(("static_obstacle_force", "moussaid",
                     scene.static_obstacles_seg,
                     (scene.static_obstacle_vel, params.static_obstacle),
                     params.use_ped_radius, None))
    if params.enable_dynamic_obstacle and veh_snap is not None:
        p = params.dynamic_obstacle
        dset, dvel, dact = snapshot_segment_pointset(veh_snap,
                                                     p.perception_threshold)
        jobs.append(("dynamic_obstacle_force", "moussaid", dset, (dvel, p),
                     params.use_ped_radius, dact))
    return jobs


def fused_environment_terms(state, scene, params, veh_snap,
                            compact: bool = False, analytic: bool = False,
                            order=None):
    """Environment force terms through the kernels, keyed like
    ``models.stepper.force_terms``: one Hilbert sort of the pedestrians
    shared by every term, one kernel launch per term, then the scatter
    back to slot order and the crossing-mode rule.

    ``order``: an optional ``(perm, inv)`` of :func:`.spatial.morton_order`
    with ``"hilbert"`` on the state's positions and liveness (the same
    permutation this function would compute), so that a caller sorting for
    another kernel sorts once.

    Covers the dense form over sampled points (``prepare_scene``'s
    segment-major layouts).  ``compact`` and ``analytic`` raise: their
    kernels belong to later slices of the port.
    """
    for form, on in (("compact", compact), ("analytic", analytic)):
        if on:
            raise NotImplementedError(
                f"the {form} environment kernels are not ported to PyTorch "
                f"yet (the {_UNPORTED_FORMS[form]} slice of the port)")
    jobs = environment_jobs(scene, params, veh_snap)
    if not jobs:
        return {}
    perm, inv = order if order is not None else morton_order(
        state.pos_x, state.pos_y, state.alive, order="hilbert")
    px, py, vx, vy, rad, alive = (
        a[perm] for a in (state.pos_x, state.pos_y, state.vel_x,
                          state.vel_y, state.radius, state.alive))
    crossing = forces.crossing_mask(state.mode)
    terms = {}
    for name, kind, seg, args, use_radius, active in jobs:
        if kind == "exp":
            fx, fy = env_exp(px, py, rad, alive, seg, *args,
                             use_radius=use_radius, active=active)
        else:
            fx, fy = env_moussaid(px, py, vx, vy, rad, alive, seg, *args,
                                  use_radius=use_radius, active=active)
        fx, fy = fx[inv], fy[inv]
        if kind == "exp":
            fx = torch.where(crossing, 0.0, fx)
            fy = torch.where(crossing, 0.0, fy)
        terms[name] = (fx, fy)
    return terms
