"""CUDA environment-force kernels and the fused environment terms (port of
ops/pallas_env.py: sampled points and the analytic border geometry, dense
and compacted forms).

Fourteen kernels from ``csrc/env_forces.cu``, each behind a wrapper that checks
its inputs, allocates its outputs, launches on PyTorch's current stream and
counts the launch:

* :func:`env_exp` -- ``a * exp(-d/b)`` away from each segment's closest
  point: the border force (``a``, ``b``) and the space-repulsive force
  (``u0/r``, ``r``).  The JAX package's ``_exp_kernel``.
* :func:`env_moussaid` -- the Moussaid interaction against each segment's
  closest point with the obstacle's velocity: the static and dynamic
  obstacle forces.  The JAX package's ``_moussaid_kernel``.
* :func:`env_exp_compact`, :func:`env_moussaid_compact` -- the same over the
  groups of sections that a per-step survivor table lists for each 128
  sorted pedestrians (``ops/env_grid.py``; four kernel blocks of 32 read
  one table row).  The JAX package's
  ``_exp_kernel_compact`` and ``_moussaid_kernel_compact``.  Their output
  equals the dense kernels' bitwise.
* :func:`env_exp_analytic`, :func:`env_exp_analytic_compact` -- the exp
  force with each section's closest point taken ON its Douglas-Peucker
  line segments (``env/pointsets.SegmentGeomSet``).  The JAX package's
  ``_exp_kernel`` and ``_exp_kernel_compact`` with ``analytic=True``.

* :func:`env_exp_batched`, :func:`env_moussaid_batched` -- :func:`env_exp`
  and :func:`env_moussaid` on B independent crowds (``(B, n)`` planes)
  against one set of segments, one launch for every row, each row with its
  own parameters (a ``(B, P)`` matrix on the device, stride 0 when shared)
  and, for a swept perception threshold, its own filter radii: the JAX
  package's ``_exp_kernel`` and ``_moussaid_kernel`` under ``vmap``.
  :func:`env_exp_compact_batched`, :func:`env_moussaid_compact_batched`,
  :func:`env_exp_analytic_batched` and
  :func:`env_exp_analytic_compact_batched` are the batched forms of the
  compacted and analytic kernels, each crowd walking its own rows of a
  batched survivor table (``ops/env_grid.env_grid`` of ``(B, n)``
  planes).  Row b of every batched form equals the unbatched launch on
  row b (with its table) bitwise.
* :func:`env_moussaid_percrowd`, :func:`env_moussaid_compact_percrowd` --
  the batched Moussaid forms where every crowd reads its own segment set
  (a batch of fleets' vehicles: ``(B, S, K)`` rows, ``(B, S)`` centers,
  ``(B, S, 2)`` velocities; the compacted form over a table built from
  each crowd's own circles): the JAX package's ``_moussaid_kernel`` and
  ``_moussaid_kernel_compact`` under ``vmap`` with per-row geometry.  A
  second kernel over the batched forms' walk body, which also offsets the
  geometry by the crowd; row b equals the unbatched launch on crowd b's
  own set bitwise.

On CPU tensors each wrapper runs its plain PyTorch version
(``ops/forces.py``; the table changes no value, so the compacted forms have
the same one); on CUDA tensors it launches the kernel or raises.  No path
falls back from the kernel to the plain version.

:func:`fused_environment_terms` sorts the pedestrians once per step along
the Hilbert curve (the kernels skip, per block of consecutive pedestrians,
every segment whose filter circle misses the block), launches one kernel
per job on the sorted planes (the compacted form where the JAX package's
static gate would, with ``compact``; the analytic form on the line-segment
geometry, with ``analytic``), scatters each result back to slot order and
applies the crossing-mode rule of the border-family terms; on ``(B, N)``
planes it sorts each row on its own and launches the batched form of the
same kernel, once for every row.  :func:`plain_environment_terms`
computes the same jobs with the plain versions.
"""
from __future__ import annotations

import torch

from . import forces
from .env_grid import EnvGrid, env_gate, env_grid
from .spatial import morton_order
from ..env.pointsets import SegmentGeomSet, per_crowd
from ..models.params import (MoussaidParams, exp_rows, law_rows,
                             moussaid_vector)

#: launches per kernel since the last :func:`reset_launch_counts`; each
#: wrapper adds one where it launches its kernel and nowhere else
LAUNCHES = {"env_exp": 0, "env_moussaid": 0, "env_exp_compact": 0,
            "env_moussaid_compact": 0, "env_exp_analytic": 0,
            "env_exp_analytic_compact": 0, "env_exp_batched": 0,
            "env_moussaid_batched": 0, "env_exp_compact_batched": 0,
            "env_moussaid_compact_batched": 0, "env_exp_analytic_batched": 0,
            "env_exp_analytic_compact_batched": 0,
            "env_moussaid_percrowd": 0, "env_moussaid_compact_percrowd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_planes(planes, alive, dev, batch=None):
    """``(n,)`` planes, or ``(batch, n)`` ones for the batched forms."""
    n = planes[0].shape[-1]
    shape = (n,) if batch is None else (batch, n)
    for t in planes:
        if (t.device != dev or t.dtype != torch.float32 or t.shape != shape
                or not t.is_contiguous()):
            raise ValueError("pedestrian planes must be contiguous float32 "
                             f"{shape} tensors on {dev}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if (alive.device != dev or alive.dtype != torch.bool
            or alive.shape != shape or not alive.is_contiguous()):
        raise ValueError(f"alive must be a contiguous bool {shape} tensor on "
                         f"{dev}")


def _check_segments(seg, extra, dev, batch=None):
    """The point rows ``(S, K)`` and centers ``(S,)`` of a segment set, or
    of a set of each of ``batch`` crowds' own, ``(B, S, K)`` and ``(B,
    S)``."""
    lead = () if batch is None else (batch,)
    s, k = seg.num_segments, seg.points_per_segment
    for name, t, shape in (("x", seg.x, (*lead, s, k)),
                           ("y", seg.y, (*lead, s, k)),
                           ("center_x", seg.center_x, (*lead, s)),
                           ("center_y", seg.center_y, (*lead, s)), *extra):
        if (t.device != dev or t.dtype != torch.float32 or t.shape != shape
                or not t.is_contiguous()):
            raise ValueError(f"segment {name} must be a contiguous float32 "
                             f"{shape} tensor on {dev}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _lengths_ptr(seg, dev) -> int:
    """Address of the set's per-row real lengths (int32 (S,), or a set of
    each crowd's own's (B, S)), or 0 (a null pointer: the kernel scans
    every slot) when it has none."""
    lengths = seg.lengths
    if lengths is None:
        return 0
    shape = tuple(seg.center_x.shape)
    if (lengths.device != dev or lengths.dtype != torch.int32
            or tuple(lengths.shape) != shape or not lengths.is_contiguous()):
        raise ValueError(f"segment lengths must be a contiguous int32 "
                         f"{shape} tensor on {dev}; got {lengths.dtype} "
                         f"{tuple(lengths.shape)} on {lengths.device}")
    return lengths.data_ptr()


def _check_grid(grid: EnvGrid, n: int, dev, batch=None):
    """The table of ``n`` sorted pedestrians, or of ``batch`` crowds of
    ``n``: ``(batch, blocks, max_surv)`` and ``(batch, blocks)``."""
    blocks = -(-n // 128)
    lead = () if batch is None else (batch,)
    for name, t, shape in (("surv", grid.surv,
                            (*lead, blocks, grid.max_surv)),
                           ("counts", grid.counts, (*lead, blocks))):
        if (t.device != dev or t.dtype != torch.int32 or t.shape != shape
                or not t.is_contiguous()):
            raise ValueError(f"survivor table {name} must be a contiguous "
                             f"int32 {shape} tensor on {dev}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if grid.max_surv < 1 or grid.group < 1:
        raise ValueError(f"survivor table width {grid.max_surv} and group "
                         f"{grid.group} must be positive")


def filter_r2(seg, active=None) -> torch.Tensor:
    """(S,) squared filter radius as the kernels read it: ``r*r`` of the
    radius clamped at 0, and -1 (never inside) for inactive segments."""
    r = torch.clamp(seg.filter_radius, min=0.0)
    r2 = r * r
    return r2 if active is None else torch.where(active, r2, -1.0)


def _launch(name, args, pos_x, grid=None):
    """Launch ``sfm_<name>`` with ``args`` (everything before ``n``), then
    ``n``, for ``(B, n)`` planes (the batched forms) ``B``, the table
    (``grid``, compacted forms), the outputs and the stream."""
    from ..utils.cuda_build import load_kernels
    fx = torch.empty_like(pos_x)
    fy = torch.empty_like(pos_x)
    n = pos_x.shape[-1]
    if n == 0:
        return fx, fy
    table = () if grid is None else (grid.surv.data_ptr(),
                                     grid.counts.data_ptr(), grid.max_surv,
                                     grid.group)
    if pos_x.dim() == 2:
        table = (pos_x.shape[0], *table)
    lib = load_kernels()
    with torch.cuda.device(pos_x.device):
        stream = torch.cuda.current_stream(pos_x.device).cuda_stream
        err = getattr(lib, f"sfm_{name}")(*args, n, *table, fx.data_ptr(),
                                          fy.data_ptr(), stream)
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


def _exp_args(pos_x, pos_y, radius, alive, seg, a, b, use_radius, active):
    """The exp entries' arguments before ``n``, checked, and the tensors
    made here that they point into (the caller holds them until the
    launch is queued)."""
    dev = pos_x.device
    _check_planes((pos_x, pos_y, radius), alive, dev)
    _check_segments(seg, (), dev)
    r2 = filter_r2(seg, active)
    s, k = seg.x.shape
    return (pos_x.data_ptr(), pos_y.data_ptr(), radius.data_ptr(),
            alive.data_ptr(), seg.x.data_ptr(), seg.y.data_ptr(), k,
            _lengths_ptr(seg, dev), seg.center_x.data_ptr(),
            seg.center_y.data_ptr(), r2.data_ptr(), s, float(a), float(b),
            int(use_radius)), r2


def _moussaid_args(pos_x, pos_y, vel_x, vel_y, radius, alive, seg,
                   obstacle_vel, p, use_radius, active):
    """The Moussaid entries' arguments before ``n`` (see :func:`_exp_args`)."""
    dev = pos_x.device
    _check_planes((pos_x, pos_y, vel_x, vel_y, radius), alive, dev)
    s, k = seg.x.shape
    _check_segments(seg, (("velocity", obstacle_vel, (s, 2)),), dev)
    r2 = filter_r2(seg, active)
    prm = moussaid_vector(p, dev)
    return (pos_x.data_ptr(), pos_y.data_ptr(), vel_x.data_ptr(),
            vel_y.data_ptr(), radius.data_ptr(), alive.data_ptr(),
            seg.x.data_ptr(), seg.y.data_ptr(), k, _lengths_ptr(seg, dev),
            seg.center_x.data_ptr(), seg.center_y.data_ptr(), r2.data_ptr(),
            obstacle_vel.data_ptr(), s, prm.data_ptr(),
            int(use_radius)), (r2, prm)


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
    args, _held = _exp_args(pos_x, pos_y, radius, alive, seg, a, b,
                            use_radius, active)
    return _launch("env_exp", args, pos_x)


def env_exp_compact(pos_x, pos_y, radius, alive, seg, a: float, b: float,
                    grid: EnvGrid, use_radius: bool = False, active=None):
    """:func:`env_exp` over the sections of the groups that ``grid``
    (:func:`.env_grid.env_grid`, built on the same sorted planes, segments
    and ``active``) lists for each block; a block that overflowed its row
    walks every section.  Equal to :func:`env_exp` bitwise."""
    if _device_of(pos_x) == "cpu":
        return forces.env_exp_force(pos_x, pos_y, radius, alive, seg, a, b,
                                    use_radius=use_radius, active=active)
    args, _held = _exp_args(pos_x, pos_y, radius, alive, seg, a, b,
                            use_radius, active)
    _check_grid(grid, pos_x.shape[0], pos_x.device)
    return _launch("env_exp_compact", args, pos_x, grid)


def _check_geom(geom, dev):
    """The analytic segment planes (S, M) and the section centers (S,)."""
    s, m = geom.ax.shape
    for name, t, shape in (("ax", geom.ax, (s, m)), ("ay", geom.ay, (s, m)),
                           ("ux", geom.ux, (s, m)), ("uy", geom.uy, (s, m)),
                           ("inv_len2", geom.inv_len2, (s, m)),
                           ("center_x", geom.center_x, (s,)),
                           ("center_y", geom.center_y, (s,))):
        if (t.device != dev or t.dtype != torch.float32 or t.shape != shape
                or not t.is_contiguous()):
            raise ValueError(f"segment geometry {name} must be a contiguous "
                             f"float32 {shape} tensor on {dev}; got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return (geom.ax.data_ptr(), geom.ay.data_ptr(), geom.ux.data_ptr(),
            geom.uy.data_ptr(), geom.inv_len2.data_ptr(), m)


def _analytic_args(pos_x, pos_y, radius, alive, geom, a, b, use_radius,
                   active):
    """The analytic exp entries' arguments before ``n`` (see
    :func:`_exp_args`)."""
    dev = pos_x.device
    _check_planes((pos_x, pos_y, radius), alive, dev)
    planes = _check_geom(geom, dev)
    r2 = filter_r2(geom, active)
    return (pos_x.data_ptr(), pos_y.data_ptr(), radius.data_ptr(),
            alive.data_ptr(), *planes, _lengths_ptr(geom, dev),
            geom.center_x.data_ptr(), geom.center_y.data_ptr(),
            r2.data_ptr(), geom.num_segments, float(a), float(b),
            int(use_radius)), r2


def env_exp_analytic(pos_x, pos_y, radius, alive, geom, a: float, b: float,
                     use_radius: bool = False, active=None):
    """:func:`env_exp` with the closest point of each section taken ON its
    line segments: ``geom`` is a :class:`..env.pointsets.SegmentGeomSet`
    on the planes' device (the analytic border tier; the JAX package's
    ``_exp_kernel`` with ``analytic=True``)."""
    if _device_of(pos_x) == "cpu":
        return forces.env_exp_force(pos_x, pos_y, radius, alive, geom, a, b,
                                    use_radius=use_radius, active=active)
    args, _held = _analytic_args(pos_x, pos_y, radius, alive, geom, a, b,
                                 use_radius, active)
    return _launch("env_exp_analytic", args, pos_x)


def env_exp_analytic_compact(pos_x, pos_y, radius, alive, geom, a: float,
                             b: float, grid: EnvGrid,
                             use_radius: bool = False, active=None):
    """:func:`env_exp_analytic` over the groups of sections that ``grid``
    lists for each block (see :func:`env_exp_compact`).  Equal to
    :func:`env_exp_analytic` bitwise."""
    if _device_of(pos_x) == "cpu":
        return forces.env_exp_force(pos_x, pos_y, radius, alive, geom, a, b,
                                    use_radius=use_radius, active=active)
    args, _held = _analytic_args(pos_x, pos_y, radius, alive, geom, a, b,
                                 use_radius, active)
    _check_grid(grid, pos_x.shape[0], pos_x.device)
    return _launch("env_exp_analytic_compact", args, pos_x, grid)


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
    args, _held = _moussaid_args(pos_x, pos_y, vel_x, vel_y, radius, alive,
                                 seg, obstacle_vel, p, use_radius, active)
    return _launch("env_moussaid", args, pos_x)


def env_moussaid_compact(pos_x, pos_y, vel_x, vel_y, radius, alive, seg,
                         obstacle_vel, p: MoussaidParams, grid: EnvGrid,
                         use_radius: bool = False, active=None):
    """:func:`env_moussaid` over the groups of sections that ``grid`` lists
    for each block (see :func:`env_exp_compact`).  Equal to
    :func:`env_moussaid` bitwise."""
    if _device_of(pos_x) == "cpu":
        return forces.env_moussaid_force(
            pos_x, pos_y, vel_x, vel_y, radius, alive, seg, obstacle_vel, p,
            use_radius=use_radius, active=active)
    args, _held = _moussaid_args(pos_x, pos_y, vel_x, vel_y, radius, alive,
                                 seg, obstacle_vel, p, use_radius, active)
    _check_grid(grid, pos_x.shape[0], pos_x.device)
    return _launch("env_moussaid_compact", args, pos_x, grid)


def _batched_args(pos_x, pos_y, vel_x, vel_y, radius, alive, seg, r2,
                  moussaid, obstacle_vel=None):
    """The batched entries' plane, segment and filter arguments, checked:
    ``(B, n)`` planes (vel_x, vel_y only for the Moussaid form), the
    segments of :func:`_check_segments` (shared, or each crowd's own) or,
    for a :class:`..env.pointsets.SegmentGeomSet`, the planes of
    :func:`_check_geom`, ``r2`` ``(S,)`` or ``(B, S)``."""
    dev = pos_x.device
    if pos_x.dim() != 2:
        raise ValueError(f"the batched kernels take (B, n) planes, got "
                         f"{tuple(pos_x.shape)}")
    batch, n = pos_x.shape
    if batch * n >= 2 ** 31:
        raise ValueError(f"{batch} x {n} pedestrians exceed the kernels' "
                         f"32-bit indices")
    _check_planes((pos_x, pos_y, *((vel_x, vel_y) if moussaid else ()),
                   radius), alive, dev, batch)
    s = seg.num_segments
    if isinstance(seg, SegmentGeomSet):
        rows = _check_geom(seg, dev)
    else:
        own = per_crowd(seg)
        lead = (batch,) if own else ()
        extra = () if not moussaid else (("velocity", obstacle_vel,
                                          (*lead, s, 2)),)
        _check_segments(seg, extra, dev, batch if own else None)
        rows = (seg.x.data_ptr(), seg.y.data_ptr(), seg.points_per_segment)
    if (r2.shape not in ((s,), (batch, s)) or r2.stride(-1) != 1
            or r2.dim() == 2 and r2.stride(0) not in (0, s)):
        raise ValueError(f"segment filter radii must be ({s},) or "
                         f"({batch}, {s}) with contiguous rows; got "
                         f"{tuple(r2.shape)}")
    r2_stride = 0 if r2.dim() == 1 else r2.stride(0)
    ptrs = (pos_x.data_ptr(), pos_y.data_ptr(),
            *((vel_x.data_ptr(), vel_y.data_ptr()) if moussaid else ()),
            radius.data_ptr(), alive.data_ptr(), *rows,
            _lengths_ptr(seg, dev), seg.center_x.data_ptr(),
            seg.center_y.data_ptr(), r2.data_ptr(), r2_stride)
    return ptrs, batch


def _launch_batched(name, pos_x, pos_y, vel_x, vel_y, radius, alive, seg,
                    active, prm, use_radius, obstacle_vel=None, grid=None):
    """Check and launch the batched entry ``sfm_<name>``: the exp forms
    (``obstacle_vel`` None) or the Moussaid forms, with the crowds' table
    ``grid`` for the compacted ones; ``prm`` the ``(B, P)`` parameter
    rows.  A ``_percrowd`` entry takes a set of each crowd's own (and
    only such a set), the others one set for all."""
    if per_crowd(seg) != name.endswith("_percrowd"):
        raise ValueError(f"{name} takes "
                         + ("a segment set of each crowd's own, (B, S, K)"
                            if name.endswith("_percrowd")
                            else "one segment set for every crowd, (S, K)")
                         + f"; got rows {tuple(seg.x.shape)}")
    moussaid = obstacle_vel is not None
    r2 = filter_r2(seg, active)
    ptrs, batch = _batched_args(pos_x, pos_y, vel_x, vel_y, radius, alive,
                                seg, r2, moussaid, obstacle_vel)
    if grid is not None:
        _check_grid(grid, pos_x.shape[1], pos_x.device, batch)
    ov = (obstacle_vel.data_ptr(),) if moussaid else ()
    return _launch(name, (*ptrs, *ov, seg.num_segments, prm.data_ptr(),
                          prm.stride(0), int(use_radius)), pos_x, grid)


def _exp_batched(name, pos_x, pos_y, radius, alive, seg, a, b, use_radius,
                 active, grid=None):
    """The batched exp forms: the plain batched version on CPU tensors,
    else the entry ``sfm_<name>``."""
    if _device_of(pos_x) == "cpu":
        return forces.env_exp_force_batched(pos_x, pos_y, radius, alive, seg,
                                            a, b, use_radius=use_radius,
                                            active=active)
    prm = exp_rows(a, b, pos_x.shape[0], pos_x.device)
    return _launch_batched(name, pos_x, pos_y, None, None, radius, alive,
                           seg, active, prm, use_radius, grid=grid)


def _moussaid_batched(name, pos_x, pos_y, vel_x, vel_y, radius, alive, seg,
                      obstacle_vel, p, use_radius, active, grid=None):
    """The batched Moussaid forms (see :func:`_exp_batched`)."""
    if _device_of(pos_x) == "cpu":
        return forces.env_moussaid_force_batched(
            pos_x, pos_y, vel_x, vel_y, radius, alive, seg, obstacle_vel, p,
            use_radius=use_radius, active=active)
    prm = law_rows("moussaid", p, pos_x.shape[0], pos_x.device)
    return _launch_batched(name, pos_x, pos_y, vel_x, vel_y, radius, alive,
                           seg, active, prm, use_radius, obstacle_vel, grid)


def env_exp_batched(pos_x, pos_y, radius, alive, seg, a, b,
                    use_radius: bool = False, active=None):
    """:func:`env_exp` on B crowds, ``(B, n)`` planes against one segment
    set, one launch for every row: ``(fx, fy)``, ``(B, n)``.  ``a``, ``b``:
    numbers shared by every row, or ``(B,)`` tensors (a sweep of the
    border or space-repulsive parameters).  A ``(B, S)`` filter radius
    gives each row its own filter."""
    return _exp_batched("env_exp_batched", pos_x, pos_y, radius, alive, seg,
                        a, b, use_radius, active)


def env_exp_compact_batched(pos_x, pos_y, radius, alive, seg, a, b,
                            grid: EnvGrid, use_radius: bool = False,
                            active=None):
    """:func:`env_exp_batched` over the groups of sections that each
    crowd's rows of ``grid`` (:func:`.env_grid.env_grid` of the same ``(B,
    n)`` sorted planes, segments and radii) list for its blocks; a row that
    overflowed walks every section.  Row b equals :func:`env_exp_compact`
    on row b with its table, bitwise."""
    return _exp_batched("env_exp_compact_batched", pos_x, pos_y, radius,
                        alive, seg, a, b, use_radius, active, grid)


def env_exp_analytic_batched(pos_x, pos_y, radius, alive, geom, a, b,
                             use_radius: bool = False, active=None):
    """:func:`env_exp_analytic` on B crowds (see :func:`env_exp_batched`):
    each section's closest point ON its line segments (``geom``, a
    :class:`..env.pointsets.SegmentGeomSet`)."""
    return _exp_batched("env_exp_analytic_batched", pos_x, pos_y, radius,
                        alive, geom, a, b, use_radius, active)


def env_exp_analytic_compact_batched(pos_x, pos_y, radius, alive, geom, a,
                                     b, grid: EnvGrid,
                                     use_radius: bool = False, active=None):
    """:func:`env_exp_analytic_batched` over each crowd's survivor table
    (see :func:`env_exp_compact_batched`)."""
    return _exp_batched("env_exp_analytic_compact_batched", pos_x, pos_y,
                        radius, alive, geom, a, b, use_radius, active, grid)


def env_moussaid_batched(pos_x, pos_y, vel_x, vel_y, radius, alive, seg,
                         obstacle_vel, p: MoussaidParams,
                         use_radius: bool = False, active=None):
    """:func:`env_moussaid` on B crowds, ``(B, n)`` planes against one
    segment set, one launch for every row: ``(fx, fy)``, ``(B, n)``.
    ``p``: shared by every row, or with ``(B,)`` tensor leaves (a sweep of
    the obstacle parameters)."""
    return _moussaid_batched("env_moussaid_batched", pos_x, pos_y, vel_x,
                             vel_y, radius, alive, seg, obstacle_vel, p,
                             use_radius, active)


def env_moussaid_compact_batched(pos_x, pos_y, vel_x, vel_y, radius, alive,
                                 seg, obstacle_vel, p: MoussaidParams,
                                 grid: EnvGrid, use_radius: bool = False,
                                 active=None):
    """:func:`env_moussaid_batched` over each crowd's survivor table (see
    :func:`env_exp_compact_batched`)."""
    return _moussaid_batched("env_moussaid_compact_batched", pos_x, pos_y,
                             vel_x, vel_y, radius, alive, seg, obstacle_vel,
                             p, use_radius, active, grid)


def env_moussaid_percrowd(pos_x, pos_y, vel_x, vel_y, radius, alive, seg,
                          obstacle_vel, p: MoussaidParams,
                          use_radius: bool = False, active=None):
    """:func:`env_moussaid_batched` where every crowd reads its own segment
    set (``seg`` with ``(B, S, K)`` rows and ``(B, S)`` centers,
    ``obstacle_vel`` ``(B, S, 2)``, ``active`` ``(B, S)``: a batch of
    fleets' vehicles, ``models/vehicles.snapshot_segment_pointset``), one
    launch for every row.  Row b equals :func:`env_moussaid` on crowd b's
    own set bitwise."""
    return _moussaid_batched("env_moussaid_percrowd", pos_x, pos_y, vel_x,
                             vel_y, radius, alive, seg, obstacle_vel, p,
                             use_radius, active)


def env_moussaid_compact_percrowd(pos_x, pos_y, vel_x, vel_y, radius, alive,
                                  seg, obstacle_vel, p: MoussaidParams,
                                  grid: EnvGrid, use_radius: bool = False,
                                  active=None):
    """:func:`env_moussaid_percrowd` over each crowd's survivor table, built
    from that crowd's own circles (:func:`.env_grid.env_grid` of the same
    ``(B, n)`` sorted planes and set).  Row b equals
    :func:`env_moussaid_compact` on crowd b's set with its table,
    bitwise."""
    return _moussaid_batched("env_moussaid_compact_percrowd", pos_x, pos_y,
                             vel_x, vel_y, radius, alive, seg, obstacle_vel,
                             p, use_radius, active, grid)


def environment_jobs(scene, params, veh_snap, analytic: bool = False):
    """The environment terms this step computes, in the JAX package's
    order: ``(name, kind, segments, args, use_radius, active)`` with
    ``args`` ``(a, b)`` for the exp kind and ``(obstacle_vel, params)``
    for the Moussaid kind.  With ``analytic`` and an analytic border
    geometry (``scene.borders_geom``), each border-family term reads it,
    and a ``<term>#rest`` job the sampled remainder of the split
    (``scene.borders_seg_rest``), which is summed into its term
    (pallas_env.py:513-528 of the JAX package)."""
    from ..models.vehicles import snapshot_segment_pointset
    jobs = []
    use_geom = analytic and scene.borders_geom is not None

    def border_jobs(name, args, use_radius):
        if not use_geom:
            jobs.append((name, "exp", scene.borders_seg, args, use_radius,
                         None))
            return
        jobs.append((name, "exp", scene.borders_geom, args, use_radius, None))
        if scene.borders_seg_rest is not None:
            jobs.append((name + "#rest", "exp", scene.borders_seg_rest, args,
                         use_radius, None))

    if params.enable_border and scene.borders_seg is not None:
        b = params.border
        border_jobs("border_force", (b.a, b.b), params.use_ped_radius)
    if params.enable_space_repulsive and scene.borders_seg is not None:
        sp = params.space_repulsive
        border_jobs("space_repulsive_force", (sp.u0 / sp.r, sp.r), False)
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


#: The wrapper of each job form, by (kind, analytic, compacted, batched):
#: its name, looked up when the job runs (so that a test may patch it).
_FORMS = {
    ("exp", False, False, False): "env_exp",
    ("exp", False, True, False): "env_exp_compact",
    ("exp", True, False, False): "env_exp_analytic",
    ("exp", True, True, False): "env_exp_analytic_compact",
    ("moussaid", False, False, False): "env_moussaid",
    ("moussaid", False, True, False): "env_moussaid_compact",
    ("exp", False, False, True): "env_exp_batched",
    ("exp", False, True, True): "env_exp_compact_batched",
    ("exp", True, False, True): "env_exp_analytic_batched",
    ("exp", True, True, True): "env_exp_analytic_compact_batched",
    ("moussaid", False, False, True): "env_moussaid_batched",
    ("moussaid", False, True, True): "env_moussaid_compact_batched",
}
#: the Moussaid forms of a batch whose crowds each read their own set (a
#: batch of fleets), by their compaction
_PERCROWD_FORMS = {False: "env_moussaid_percrowd",
                   True: "env_moussaid_compact_percrowd"}


def fused_environment_terms(state, scene, params, veh_snap,
                            compact: bool = False, max_surv: int = 0,
                            analytic: bool = False, order=None):
    """Environment force terms through the kernels, keyed like
    ``models.stepper.force_terms``: one Hilbert sort of the pedestrians
    shared by every term, one kernel launch per term, then the scatter
    back to slot order and the crossing-mode rule.

    ``compact`` (``StepConfig.env_compact``): each term whose job passes the
    JAX package's static gate (:func:`.env_grid.env_gate`, table width
    ``max_surv`` or auto at 0) gets a survivor table built on the sorted
    planes and launches the compacted kernel; the others launch the dense
    one.  The values are the same either way.

    ``order``: an optional ``(perm, inv)`` of :func:`.spatial.morton_order`
    with ``"hilbert"`` on the state's positions and liveness (the same
    permutation this function would compute), so that a caller sorting for
    another kernel sorts once.

    ``analytic`` (``StepConfig.env_analytic``): the border-family terms
    read the line-segment geometry (``prepare_scene(analytic=True)``)
    through :func:`env_exp_analytic` (or its compacted form, gated with
    ``K`` = segments per section), and their sampled remainder through
    the sampled kernel, summed into the term.

    ``(B, N)`` planes (a batch of crowds) sort each row on its own, build
    each job's table (the gate is one for every crowd) over each row's
    blocks and launch the batched form of the same kernel once for every
    row; a batch of fleets' vehicles (each crowd's own set) launch the
    ``_percrowd`` forms, each crowd's table built from its own circles.
    """
    jobs = environment_jobs(scene, params, veh_snap, analytic)
    if not jobs:
        return {}
    batched = state.batch is not None
    perm, inv = order if order is not None else morton_order(
        state.pos_x, state.pos_y, state.alive, order="hilbert")
    px, py, vx, vy, rad, alive = (
        a.gather(-1, perm) for a in (state.pos_x, state.pos_y, state.vel_x,
                                     state.vel_y, state.radius, state.alive))
    crossing = forces.crossing_mask(state.mode)
    terms = {}
    for name, kind, seg, args, use_radius, active in jobs:
        engage, group, ms = env_gate(seg.num_segments,
                                     forces.section_slots(seg), compact,
                                     max_surv)
        grid = (env_grid(px, py, alive, seg, filter_r2(seg, active), group,
                         ms) if engage else None)
        form = (_PERCROWD_FORMS[grid is not None] if per_crowd(seg)
                else _FORMS[kind, isinstance(seg, SegmentGeomSet),
                            grid is not None, batched])
        fn = globals()[form]
        table = () if grid is None else (grid,)
        vel = () if kind == "exp" else (vx, vy)
        fx, fy = fn(px, py, *vel, rad, alive, seg, *args, *table,
                    use_radius=use_radius, active=active)
        _collect(terms, name, kind, fx.gather(-1, inv), fy.gather(-1, inv),
                 crossing)
    return terms


def plain_environment_terms(state, scene, params, veh_snap,
                            analytic: bool = False):
    """The terms of :func:`fused_environment_terms` through the plain
    versions on the unsorted planes (no sort, no kernel, no table): the
    reference the kernel path is compared with.  ``(B, N)`` planes go row
    by row, each with its row's parameters."""
    crossing = forces.crossing_mask(state.mode)
    terms = {}
    for name, kind, seg, args, use_radius, active in environment_jobs(
            scene, params, veh_snap, analytic):
        if state.batch is not None:
            fn = (forces.env_exp_force_batched if kind == "exp"
                  else forces.env_moussaid_force_batched)
            vel = () if kind == "exp" else (state.vel_x, state.vel_y)
            fx, fy = fn(state.pos_x, state.pos_y, *vel, state.radius,
                        state.alive, seg, *args, use_radius=use_radius,
                        active=active)
        elif kind == "exp":
            fx, fy = forces.env_exp_force(
                state.pos_x, state.pos_y, state.radius, state.alive, seg,
                *args, use_radius=use_radius, active=active)
        else:
            fx, fy = forces.env_moussaid_force(
                state.pos_x, state.pos_y, state.vel_x, state.vel_y,
                state.radius, state.alive, seg, *args, use_radius=use_radius,
                active=active)
        _collect(terms, name, kind, fx, fy, crossing)
    return terms


def _collect(terms, name, kind, fx, fy, crossing):
    """Add one job's slot-order force to ``terms``: the border-family
    (exp) terms are off for pedestrians crossing the road (reference
    forces.py:176-177), and a ``<term>#rest`` job sums into its term."""
    if kind == "exp":
        fx = torch.where(crossing, 0.0, fx)
        fy = torch.where(crossing, 0.0, fy)
    base = name.split("#")[0]
    if base in terms:
        gx, gy = terms[base]
        fx, fy = gx + fx, gy + fy
    terms[base] = (fx, fy)
