"""CUDA pair-force kernels and their dispatch (port of ops/pallas_forces.py).

The kernels of ``csrc/pair_forces.cu``, each behind a ctypes wrapper that
checks its inputs, allocates its outputs, launches on PyTorch's current
stream and counts the launch.  Every wrapper takes ``law``: the pair law
of the kernel, ``"moussaid"`` (the reference's force, the default),
``"powerlaw"`` (the Karamouzas time-to-collision law) or ``"helbing"`` (the
Helbing ellipse, which needs ``desired=(ex, ey)``, the pedestrians' unit
desired directions, and has only the dense forms: it is not antisymmetric).

* :func:`pair_force_sym` -- each unordered pair once, +f to the row and -f
  to the column (the JAX package's ``_pair_kernel_sym``); the default.
* :func:`pair_force_dense` -- every row summed over every column (the JAX
  package's ``_pair_kernel``); deterministic.
* :func:`pair_force_cutoff` -- their cutoff forms, on Hilbert-sorted
  planes with the boxes and table of ``ops/pair_grid.cutoff_grid``, one
  kernel per form: ``sym_cutoff`` (the static triangle with the box test),
  ``sym_compact`` (driven by the survivor table of hits and triangle),
  ``dense_cutoff`` (every column tile with the box test) and ``compact``
  (the JAX package's ``_pair_kernel_compact``: only the surviving column
  tiles; equal to ``dense_cutoff`` bitwise).
* :func:`pair_force_rect` -- the dense walks on row planes against other
  column planes (a shard's rows against gathered or rotated columns),
  with the global slots of both sides for the self-pair test; on equal
  planes the square call bitwise.
* :func:`pair_force_sym_dense` -- the full block of two shards' agents,
  every pair once, +f to the rows and -f to the columns' own output (the
  JAX package's ``_pair_kernel_sym_dense``, the half-ring's off-diagonal
  step), with ``sym_dense_cutoff`` its cutoff form.

* :func:`pair_force_sym_batched`, :func:`pair_force_dense_batched` -- the
  symmetric and dense walks on a batch of B independent crowds, ``(B, n)``
  planes and a ``(B, P)`` parameter matrix (row b's parameters; stride 0
  when every row shares them), one launch for every row: the JAX package's
  ``_pair_kernel_sym`` and ``_pair_kernel`` under ``vmap`` (ensembles and
  parameter sweeps, ``parallel/sweeps.py``).  Row b of the dense form
  equals the unbatched launch on row b bitwise.
* :func:`pair_force_cutoff_batched` -- the four cutoff forms on a batch,
  each row sorted on its own, with the batched grid of
  ``ops/pair_grid.cutoff_grid`` (``sym_cutoff_batched``,
  ``sym_compact_batched``, ``dense_cutoff_batched``, ``compact_batched``):
  ``_pair_kernel_sym`` with its cutoff, ``_pair_kernel`` with its box skip
  and ``_pair_kernel_compact`` under ``vmap``.  Row b of the dense forms
  equals the unbatched cutoff launch on row b bitwise.
* :func:`pair_force_rect_batched`, :func:`pair_force_sym_dense_batched` --
  the rectangular and full-block forms on a batch of crowds whose slots
  are sharded over an agent axis (``parallel/sweeps.
  make_sharded_ensemble_rollout``): ``(B, n_rows)`` rows against ``(B,
  n_cols)`` columns, the offsets the same for every crowd
  (``dense_rect_batched``, ``dense_cutoff_rect_batched``,
  ``compact_rect_batched``, ``sym_dense_batched``,
  ``sym_dense_cutoff_batched``).  Row b of the dense forms equals the
  unbatched rectangular launch on row b bitwise.

One C entry per form, ``sfm_pair_<form>``, takes the law's id
(:data:`LAW_IDS`).  A kernel's name, and its key in :data:`LAUNCHES`, is
the law's prefix and the form: ``pair_force_sym`` ...
``pair_force_sym_dense_cutoff`` for the Moussaid law, ``powerlaw_sym`` ...
``powerlaw_sym_dense_cutoff``, ``helbing_dense``, ``helbing_dense_cutoff``
and ``helbing_compact``.

:func:`pedestrian_force_kernel` (all pairs) and
:func:`pedestrian_force_sorted` (the cutoff path: sort, force, unsort)
choose by the tensors' device: CPU tensors go to the plain PyTorch version
(:func:`..ops.forces.pedestrian_force`, ``powerlaw_force`` or
``ped_repulsive_force``), CUDA tensors go to a kernel or raise.  No path
falls back from the kernel to the plain version.
:func:`pedestrian_force_batched` does the same for ``(B, N)`` planes, with
or without a cutoff: the batched kernels on a card,
:func:`plain_batched_force` (row by row) on the CPU; it never loops the
unbatched kernels over rows.  With ``axis`` (the tensors are one shard's
slots of an agent axis, ``parallel/``; one crowd's ``(n,)`` planes or a
batch's ``(B, n)``) :func:`pedestrian_force_kernel` and
:func:`pedestrian_force_sorted` run the sharded schedules:
:func:`plain_sharded_force` on the CPU, :func:`kernel_sharded_force` on a
card (the in-kernel ring is ``ops/cuda_ring.py``), with the batched forms
under a batch.
"""
from __future__ import annotations

import torch

from . import forces
from .pair_grid import (CHUNK, COL_TILE, SYM_TILE, CutoffGrid, block_grid,
                        box_planes, cutoff_grid, rect_grid)
from .spatial import morton_order
from ..models.params import (helbing_vector, law_rows, moussaid_vector,
                             powerlaw_vector, section_rows)

#: the forms on one set of planes, each with a batched form
_SQUARE_FORMS = ("sym", "dense", "sym_cutoff", "sym_compact",
                 "dense_cutoff", "compact")
#: the batched forms on row and column planes
_RECT_BATCHED = ("dense_rect_batched", "dense_cutoff_rect_batched",
                 "compact_rect_batched")
_SYM_DENSE = ("sym_dense", "sym_dense_cutoff", "sym_dense_batched",
              "sym_dense_cutoff_batched")
#: kernel-name prefix, parameter-vector length and the forms of each law
LAWS = {
    "moussaid": ("pair_force", 6, (*_SQUARE_FORMS, *_SYM_DENSE,
                                   *(f + "_batched" for f in _SQUARE_FORMS),
                                   *_RECT_BATCHED)),
    "powerlaw": ("powerlaw", 4, (*_SQUARE_FORMS, *_SYM_DENSE,
                                 *(f + "_batched" for f in _SQUARE_FORMS),
                                 *_RECT_BATCHED)),
    "helbing": ("helbing", 6, ("dense", "dense_cutoff", "compact",
                               "dense_batched", "dense_cutoff_batched",
                               "compact_batched", *_RECT_BATCHED)),
}

#: the law ids of the C entries (csrc/pair_laws.cuh LawId)
LAW_IDS = {"moussaid": 0, "powerlaw": 1, "helbing": 2}

#: the forms whose entry takes row and column planes (the others take one
#: set of planes)
RECT_FORMS = ("dense", "dense_cutoff", "compact", *_SYM_DENSE,
              *_RECT_BATCHED)

#: launches per kernel since the last :func:`reset_launch_counts`; each
#: wrapper adds one where it launches its kernel and nowhere else
LAUNCHES = {f"{prefix}_{form}": 0 for prefix, _, forms in LAWS.values()
            for form in forms}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def law_vector(law: str, p, device) -> torch.Tensor:
    """The parameter vector the kernels of ``law`` read, for params ``p``
    (``MoussaidParams``, ``PowerLawParams`` or ``PedRepulsiveParams``)."""
    return {"moussaid": moussaid_vector, "powerlaw": powerlaw_vector,
            "helbing": helbing_vector}[law](p, device)


def _check_side(planes, prm=None, prm_len=0, batch=None):
    """One side's planes (x, y, u, v, radius or None, alive) against what
    the C entries assume; returns the count.  ``batch``: the planes are
    ``(batch, n)`` and ``prm`` a ``(batch, prm_len)`` matrix whose rows
    lie ``prm_len`` apart, or all at one address (stride 0: shared)."""
    x = planes[0]
    if x.device.type != "cuda":
        raise ValueError(f"CUDA pair-force kernels take CUDA tensors, got "
                         f"{x.device}")
    n = x.shape[-1]
    shape = (n,) if batch is None else (batch, n)
    for t in planes[:5]:
        if t is None:
            continue
        if (t.device != x.device or t.dtype != torch.float32
                or t.shape != shape or not t.is_contiguous()):
            raise ValueError("pair-force planes must be contiguous float32 "
                             f"{shape} tensors on {x.device}; got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    alive = planes[5]
    if (alive.device != x.device or alive.dtype != torch.bool
            or alive.shape != shape or not alive.is_contiguous()):
        raise ValueError(f"alive must be a contiguous bool {shape} tensor on "
                         f"{x.device}")
    if prm is None:
        return n
    if batch is None:
        ok = prm.shape == (prm_len,) and prm.is_contiguous()
    else:
        ok = (prm.shape == (batch, prm_len) and prm.stride(-1) == 1
              and prm.stride(0) in (0, prm_len))
    if prm.device != x.device or prm.dtype != torch.float32 or not ok:
        raise ValueError(f"prm must be a float32 "
                         f"{(prm_len,) if batch is None else (batch, prm_len)}"
                         f" tensor on {x.device} with contiguous rows"
                         + ("" if batch is None else " (or one row at "
                            "stride 0)"))
    return n


def _check_grid(grid: CutoffGrid, n_rows: int, n_cols: int, dev,
                batch: int | None = None):
    """The boxes and table a cutoff kernel reads, against the shapes its C
    entry assumes for ``n_rows`` rows and ``n_cols`` columns (each crowd's,
    with a leading ``batch`` axis on every tensor; the batched box-skip
    and table walks also read the columns' chunk boxes)."""
    tile = SYM_TILE if grid.form.startswith("sym") else COL_TILE
    lead = () if batch is None else (batch,)
    want = [("boxes", grid.boxes, torch.float32,
             (*lead, 4, -(-n_cols // tile)))]
    if grid.form in ("dense_cutoff", "compact") and batch is not None:
        want.append(("chunk_boxes", grid.chunk_boxes, torch.float32,
                     (batch, 4, -(-n_cols // CHUNK))))
    if grid.form == "sym_dense_cutoff":
        want.append(("row_boxes", grid.row_boxes, torch.float32,
                     (*lead, 4, -(-n_rows // SYM_TILE))))
    if grid.form.endswith("compact"):
        rows = -(-n_rows // SYM_TILE)
        if grid.max_surv < 1:
            raise ValueError("a survivor table needs max_surv >= 1")
        want += [("surv", grid.surv, torch.int32,
                  (*lead, rows, grid.max_surv)),
                 ("counts", grid.counts, torch.int32, (*lead, rows))]
    for name, t, dtype, shape in want:
        if (t is None or t.device != dev or t.dtype != dtype
                or t.shape != shape or not t.is_contiguous()):
            raise ValueError(f"{grid.form} needs {name} as a contiguous "
                             f"{dtype} {shape} tensor on {dev}")


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _launch(law: str, form: str, pos_x, pos_y, vel_x, vel_y, radius, alive,
            prm, use_radius: bool, grid: CutoffGrid | None = None,
            desired=None, cols=None, row_offset: int = 0,
            col_offset: int = 0):
    """Check, launch and count the kernel of ``law`` in ``form``.  The
    Moussaid entries read the radii and ``use_radius``; the power-law
    entries the radii (always summed); the Helbing entries the desired
    directions in the rows' velocity slots, and no radius.

    ``cols``: the column planes ``(x, y, vx, vy, radius, alive)`` of a
    rectangular form (``RECT_FORMS``), with the global slots ``row_offset``
    and ``col_offset`` of both sides' first agents; None: the rows'
    own (the square call).  Returns ``(fx, fy)``, and for the full-block
    forms also the columns' ``(fxc, fyc)``.  The batched forms
    (``"<form>_batched"``, ``"<form>_rect_batched"``) take ``(B, n)``
    planes (and columns), a ``(B, P)`` ``prm`` and, for the cutoff forms,
    the batched grid of ``<form>``, and launch once for every row."""
    from ..utils.cuda_build import load_kernels
    if law not in LAWS:
        raise ValueError(f"unknown pair law {law!r}; one of {sorted(LAWS)}")
    prefix, prm_len, forms = LAWS[law]
    if form not in forms:
        raise ValueError(f"the {law} law has no {form} kernel (its forms: "
                         f"{', '.join(forms)})")
    if (law == "helbing") != (desired is not None):
        raise ValueError("desired=(ex, ey) planes go with law='helbing' "
                         "only, and that law needs them")
    if use_radius and law != "moussaid":
        raise ValueError(f"use_radius applies to the Moussaid law only (the "
                         f"{law} law reads radii as it is defined)")
    if cols is not None and form not in RECT_FORMS:
        raise ValueError(f"the {form} form takes one set of planes")
    batch = None
    base = form.removesuffix("_batched").removesuffix("_rect")
    if base != form:
        if pos_x.dim() != 2:
            raise ValueError(f"the batched kernels take (B, n) planes, got "
                             f"{tuple(pos_x.shape)}")
        batch = pos_x.shape[0]
    name = f"{prefix}_{form}"
    if law == "helbing":
        radius = None
    u, v = desired if law == "helbing" else (vel_x, vel_y)
    rows = (pos_x, pos_y, u, v, radius, alive)
    if cols is None:
        cols = (pos_x, pos_y, vel_x, vel_y, radius, alive)
    elif law == "helbing":
        cols = (*cols[:4], None, cols[5])
    n = _check_side(rows, prm, prm_len, batch)
    n_cols = _check_side(cols, batch=batch)
    if cols[0].device != pos_x.device:
        raise ValueError("row and column planes must share a device")
    grid_args = []
    if grid is not None:
        if grid.form != base:
            raise ValueError(f"a {grid.form} grid drives the {grid.form} "
                             f"kernel, not {form}")
        _check_grid(grid, n, n_cols, pos_x.device, batch)
        if grid.row_boxes is not None:
            grid_args.append(grid.row_boxes.data_ptr())
        # the batched table walk tests the chunk boxes instead of the
        # tiles'; the batched box-skip launch takes both and reads the
        # boxes of the walk its shapes choose
        if base == "compact" and batch is not None:
            grid_args.append(grid.chunk_boxes.data_ptr())
        else:
            grid_args.append(grid.boxes.data_ptr())
            if base == "dense_cutoff" and batch is not None:
                grid_args.append(grid.chunk_boxes.data_ptr())
        if grid.surv is not None:
            grid_args += [grid.surv.data_ptr(), grid.counts.data_ptr(),
                          grid.max_surv]
        grid_args.append(grid.c2)
    elif base.endswith(("cutoff", "compact")):
        raise ValueError(f"the {form} form needs a grid")
    fx = torch.zeros_like(pos_x)
    fy = torch.zeros_like(pos_y)
    outs = [fx, fy]
    if form.startswith("sym_dense"):
        outs += [torch.zeros_like(cols[0]), torch.zeros_like(cols[0])]
    if n == 0 or (form.startswith("sym_dense") and n_cols == 0):
        return tuple(outs)
    if batch is not None and batch * max(n, n_cols) >= 2 ** 31:
        raise ValueError(f"{batch} x {max(n, n_cols)} agents exceed the "
                         f"kernels' 32-bit indices")
    if batch is not None and form in RECT_FORMS:
        planes = [*map(_ptr, rows), n, row_offset, *map(_ptr, cols), n_cols,
                  col_offset, prm.data_ptr(), prm.stride(0),
                  int(use_radius), batch]
    elif batch is not None:
        sides = ((*rows[:2], *cols[2:]) if base.startswith("sym")
                 else (*rows, *cols))
        planes = [*map(_ptr, sides), prm.data_ptr(), prm.stride(0),
                  int(use_radius), n, batch]
    elif form in RECT_FORMS:
        planes = [*map(_ptr, rows), n, row_offset, *map(_ptr, cols), n_cols,
                  col_offset, prm.data_ptr(), int(use_radius)]
    else:
        planes = [*map(_ptr, rows[:2]), *map(_ptr, cols[2:]), prm.data_ptr(),
                  int(use_radius), n]
    lib = load_kernels()
    with torch.cuda.device(pos_x.device):
        stream = torch.cuda.current_stream(pos_x.device).cuda_stream
        err = getattr(lib, f"sfm_pair_{form}")(
            LAW_IDS[law], *planes, *grid_args, *(t.data_ptr() for t in outs),
            stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.sfm_cuda_error_string(err).decode()})")
    LAUNCHES[name] += 1
    return tuple(outs)


def pair_force_sym(pos_x, pos_y, vel_x, vel_y, radius, alive, prm,
                   use_radius: bool = False, law: str = "moussaid"):
    """Pair force of ``law`` (an antisymmetric one), Newton's-third-law
    kernel: ``(fx, fy)``.

    Row and column partials are combined with atomics, so the summation
    order (and the last bits of the result) vary from run to run."""
    return _launch(law, "sym", pos_x, pos_y, vel_x, vel_y, radius, alive,
                   prm, use_radius)


def pair_force_dense(pos_x, pos_y, vel_x, vel_y, radius, alive, prm,
                     use_radius: bool = False, law: str = "moussaid",
                     desired=None):
    """Pair force of ``law``, dense per-row kernel: ``(fx, fy)``,
    deterministic.  Helbing: ``radius`` is not read (may be None) and
    ``desired`` is required."""
    return _launch(law, "dense", pos_x, pos_y, vel_x, vel_y, radius, alive,
                   prm, use_radius, desired=desired)


def pair_force_cutoff(pos_x, pos_y, vel_x, vel_y, radius, alive, prm,
                      grid: CutoffGrid, use_radius: bool = False,
                      law: str = "moussaid", desired=None):
    """Pair force of ``law`` over the pairs within the cutoff, ``(fx,
    fy)``, through the kernel of ``grid.form`` (the grid comes from
    :func:`..ops.pair_grid.cutoff_grid` of the same planes; Helbing takes
    the non-symmetric grids only).  The planes should be sorted along a
    space-filling curve, or few tile pairs skip; the result does not depend
    on the order beyond f32 summation order.  The symmetric forms use
    atomics (the last bits vary from run to run); the dense forms are
    deterministic, and ``"compact"`` equals ``"dense_cutoff"`` bitwise."""
    return _launch(law, grid.form, pos_x, pos_y, vel_x, vel_y, radius, alive,
                   prm, use_radius, grid, desired)


def pair_force_rect(pos_x, pos_y, vel_x, vel_y, radius, alive, prm, cols,
                    row_offset: int = 0, col_offset: int = 0,
                    grid: CutoffGrid | None = None, use_radius: bool = False,
                    law: str = "moussaid", desired=None):
    """Pair force of ``law`` on the rows from the column planes ``cols``
    (x, y, vx, vy, radius, alive): ``(fx, fy)``, through the dense kernel,
    or with ``grid`` (:func:`..ops.pair_grid.rect_grid`) its cutoff or
    compacted form -- the rectangular forms of the dense walks (the JAX
    package's ``_slab_call`` of a shard's rows against gathered or rotated
    columns).  ``row_offset``/``col_offset``: the global slots of both
    sides' first agents (the self-pair test).  Deterministic; on equal
    planes and offsets equal to the square call bitwise."""
    form = "dense" if grid is None else grid.form
    return _launch(law, form, pos_x, pos_y, vel_x, vel_y, radius, alive,
                   prm, use_radius, grid, desired, cols, row_offset,
                   col_offset)


def pair_force_sym_dense(pos_x, pos_y, vel_x, vel_y, radius, alive, prm,
                         cols, row_offset: int = 0, col_offset: int = 0,
                         grid: CutoffGrid | None = None,
                         use_radius: bool = False, law: str = "moussaid"):
    """The full-block Newton's-third-law kernel of an antisymmetric ``law``
    (the JAX package's ``_pair_kernel_sym_dense``): every pair of the rows
    and the column planes ``cols`` once, ``(fx, fy, fxc, fyc)`` with +f in
    the rows' and -f in the columns' outputs.  With ``grid``
    (:func:`..ops.pair_grid.block_grid`) the cutoff and the box skip.
    Atomics: the last bits vary from run to run."""
    form = "sym_dense" if grid is None else grid.form
    if form not in ("sym_dense", "sym_dense_cutoff"):
        raise ValueError(f"a {grid.form} grid does not drive the full-block "
                         f"kernel")
    return _launch(law, form, pos_x, pos_y, vel_x, vel_y, radius, alive,
                   prm, use_radius, grid, None, cols, row_offset, col_offset)


def pair_force_sym_batched(pos_x, pos_y, vel_x, vel_y, radius, alive, prm,
                           use_radius: bool = False, law: str = "moussaid"):
    """:func:`pair_force_sym` on B independent crowds at once: ``(B, n)``
    planes, ``prm`` ``(B, P)`` (row b's parameters; a stride-0 expand of
    one vector when the rows share them), one launch.  ``(fx, fy)``,
    ``(B, n)``.  Atomics: the last bits vary from run to run."""
    return _launch(law, "sym_batched", pos_x, pos_y, vel_x, vel_y, radius,
                   alive, prm, use_radius)


def pair_force_dense_batched(pos_x, pos_y, vel_x, vel_y, radius, alive, prm,
                             use_radius: bool = False, law: str = "moussaid",
                             desired=None):
    """:func:`pair_force_dense` on B independent crowds at once (see
    :func:`pair_force_sym_batched`); Helbing's ``desired`` planes are
    ``(B, n)`` too.  Deterministic: row b equals the unbatched launch on
    row b bitwise."""
    return _launch(law, "dense_batched", pos_x, pos_y, vel_x, vel_y, radius,
                   alive, prm, use_radius, desired=desired)


def pair_force_cutoff_batched(pos_x, pos_y, vel_x, vel_y, radius, alive, prm,
                              grid: CutoffGrid, use_radius: bool = False,
                              law: str = "moussaid", desired=None):
    """:func:`pair_force_cutoff` on B independent crowds at once: ``(B, n)``
    planes, each row sorted along its own curve, ``prm`` ``(B, P)`` (see
    :func:`pair_force_sym_batched`) and the batched grid of
    :func:`..ops.pair_grid.cutoff_grid` of the same planes; one launch of
    the batched kernel of ``grid.form``.  ``(fx, fy)``, ``(B, n)``.  The
    dense forms are deterministic, row b equal to the unbatched launch on
    row b bitwise; the symmetric forms use atomics."""
    return _launch(law, grid.form + "_batched", pos_x, pos_y, vel_x, vel_y,
                   radius, alive, prm, use_radius, grid, desired)


def pair_force_rect_batched(pos_x, pos_y, vel_x, vel_y, radius, alive, prm,
                            cols, row_offset: int = 0, col_offset: int = 0,
                            grid: CutoffGrid | None = None,
                            use_radius: bool = False, law: str = "moussaid",
                            desired=None):
    """:func:`pair_force_rect` on B independent crowds at once: ``(B,
    n_rows)`` row planes against ``(B, n_cols)`` column planes ``cols``,
    ``prm`` ``(B, P)`` (see :func:`pair_force_sym_batched`), the offsets
    the same for every crowd, ``grid`` the batched grid of
    :func:`..ops.pair_grid.rect_grid`; one launch.  ``(fx, fy)``, ``(B,
    n_rows)``.  Deterministic: row b equals the unbatched launch on row b
    bitwise."""
    form = ("dense" if grid is None else grid.form) + "_rect_batched"
    return _launch(law, form, pos_x, pos_y, vel_x, vel_y, radius, alive,
                   prm, use_radius, grid, desired, cols, row_offset,
                   col_offset)


def pair_force_sym_dense_batched(pos_x, pos_y, vel_x, vel_y, radius, alive,
                                 prm, cols, row_offset: int = 0,
                                 col_offset: int = 0,
                                 grid: CutoffGrid | None = None,
                                 use_radius: bool = False,
                                 law: str = "moussaid"):
    """:func:`pair_force_sym_dense` on B independent crowds at once: ``(B,
    n_rows)`` rows against ``(B, n_cols)`` columns, ``prm`` ``(B, P)``,
    ``grid`` the batched :func:`..ops.pair_grid.block_grid`; one launch.
    ``(fx, fy, fxc, fyc)``.  Atomics: the last bits vary from run to
    run."""
    form = "sym_dense" if grid is None else grid.form
    if form not in ("sym_dense", "sym_dense_cutoff"):
        raise ValueError(f"a {grid.form} grid does not drive the full-block "
                         f"kernel")
    return _launch(law, form + "_batched", pos_x, pos_y, vel_x, vel_y,
                   radius, alive, prm, use_radius, grid, None, cols,
                   row_offset, col_offset)


def plain_batched_force(law, pos_x, pos_y, vel_x, vel_y, radius, alive, p,
                        use_ped_radius: bool = False, row_block: int = 1024,
                        desired=None, cutoff: float | None = None, cols=None,
                        row_offset=0, col_offset=0, mirror: bool = False):
    """The plain version of the batched pair kernels: row b of the ``(B,
    N)`` planes through :func:`plain_law_force` with row b's parameters
    (``p``: a section with ``(B,)`` tensor leaves, or one shared by every
    row) and ``cutoff``.  ``(fx, fy)``, ``(B, N)``.  ``cols``: ``(B,
    n_cols)`` column planes (``None`` entries stay None) with the offsets
    of every crowd (the plain version of :func:`pair_force_rect_batched`);
    with ``mirror`` also the columns' ``(fxc, fyc)`` (of
    :func:`pair_force_sym_dense_batched`)."""
    batch = pos_x.shape[0]
    out = []
    for b, pb in enumerate(section_rows(p, batch)):
        out.append(plain_law_force(
            law, pos_x[b], pos_y[b], vel_x[b], vel_y[b],
            None if radius is None else radius[b], alive[b], pb,
            use_ped_radius, row_block, cutoff,
            None if desired is None else (desired[0][b], desired[1][b]),
            None if cols is None else tuple(None if c is None else c[b]
                                            for c in cols),
            row_offset, col_offset, mirror))
    return tuple(torch.stack(parts) for parts in zip(*out))


def pedestrian_force_batched(pos_x, pos_y, vel_x, vel_y, radius, alive, p,
                             use_ped_radius: bool = False,
                             symmetric: bool = True, row_block: int = 1024,
                             law: str = "moussaid", desired=None,
                             plain: bool = False,
                             cutoff: float | None = None,
                             compact: bool = True, max_surv: int = 0,
                             spatial_order: str = "hilbert", order=None):
    """Pair force of ``law`` on B independent crowds, ``(B, N)`` planes:
    ``(fx, fy)``.  ``p``: the law's params, with ``(B,)`` tensor leaves
    (a sweep) or numbers shared by every row (an ensemble).

    Without ``cutoff``: on CPU tensors, or with ``plain``, the plain
    version row by row (:func:`plain_batched_force`); on CUDA tensors one
    launch of :func:`pair_force_sym_batched` (``symmetric``; ignored for
    Helbing) or :func:`pair_force_dense_batched` for all rows, or it
    raises.

    With ``cutoff`` (the batched counterpart of
    :func:`pedestrian_force_sorted`): with ``plain``, the plain version
    with the cutoff on the unsorted rows; otherwise each row is sorted
    along its own curve (``spatial_order``, or ``order``: a ``(perm,
    inv)`` of :func:`..ops.spatial.morton_order` of the same ``(B, N)``
    positions and liveness), then on the CPU the plain version row by row
    and on a card one launch of :func:`pair_force_cutoff_batched` with the
    batched grid of :func:`..ops.pair_grid.cutoff_grid` (``symmetric``,
    ``compact``, ``max_surv``), and the result is scattered back to slot
    order."""
    dev = pos_x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no pair-force path for device {dev}")
    if plain or (dev.type == "cpu" and cutoff is None):
        return plain_batched_force(law, pos_x, pos_y, vel_x, vel_y, radius,
                                   alive, p, use_ped_radius, row_block,
                                   desired, cutoff)
    if cutoff is not None:
        perm, inv = order if order is not None else morton_order(
            pos_x, pos_y, alive, spatial_order)
        planes = [a.gather(-1, perm) for a in (pos_x, pos_y, vel_x, vel_y)]
        srad = None if law == "helbing" else radius.gather(-1, perm)
        salive = alive.gather(-1, perm)
        sdesired = (None if desired is None
                    else tuple(a.gather(-1, perm) for a in desired))
        if dev.type == "cpu":
            fx, fy = plain_batched_force(law, *planes, srad, salive, p,
                                         use_ped_radius, row_block, sdesired,
                                         cutoff)
        else:
            grid = cutoff_grid(planes[0], planes[1], salive, cutoff,
                               symmetric=symmetric and law != "helbing",
                               compact=compact, max_surv=max_surv)
            fx, fy = pair_force_cutoff_batched(
                *planes, srad, salive, law_rows(law, p, pos_x.shape[0], dev),
                grid, use_radius=use_ped_radius, law=law, desired=sdesired)
        return fx.gather(-1, inv), fy.gather(-1, inv)
    prm = law_rows(law, p, pos_x.shape[0], dev)
    if symmetric and law != "helbing":
        return pair_force_sym_batched(pos_x, pos_y, vel_x, vel_y, radius,
                                      alive, prm, use_ped_radius, law)
    return pair_force_dense_batched(pos_x, pos_y, vel_x, vel_y, radius,
                                    alive, prm, use_ped_radius, law, desired)


def plain_law_force(law, pos_x, pos_y, vel_x, vel_y, radius, alive, p,
                    use_ped_radius, row_block, cutoff, desired, cols=None,
                    row_offset=0, col_offset=0, mirror: bool = False):
    """The plain PyTorch version of ``law``: the CPU path, and the
    reference a step through the kernels is compared with.  ``cols``, the
    offsets and ``mirror`` (antisymmetric laws) as in
    :func:`..ops.forces.pedestrian_force`."""
    kw = dict(row_block=row_block, cutoff=cutoff, cols=cols,
              row_offset=row_offset, col_offset=col_offset)
    if law == "moussaid":
        return forces.pedestrian_force(pos_x, pos_y, vel_x, vel_y, radius,
                                       alive, p, use_ped_radius=use_ped_radius,
                                       mirror=mirror, **kw)
    if law == "powerlaw":
        return forces.powerlaw_force(pos_x, pos_y, vel_x, vel_y, radius,
                                     alive, p, mirror=mirror, **kw)
    if mirror:
        raise ValueError("the Helbing law is not antisymmetric: no mirror")
    return forces.ped_repulsive_force(pos_x, pos_y, vel_x, vel_y, *desired,
                                      alive, p, **kw)


#: the column communication schedules of the sharded pair force
AXIS_COMMS = ("gather", "ring", "ring_kernel")


def _rotate(axis, tensors, perm):
    """``ppermute`` of every tensor of a block (None entries stay None)."""
    return tuple(None if t is None else axis.ppermute(t, perm)
                 for t in tensors)


def _gather(axis, tensors):
    return tuple(None if t is None else axis.all_gather(t) for t in tensors)


def plain_sharded_force(law, pos_x, pos_y, vel_x, vel_y, radius, alive, p,
                        axis, comm: str, use_ped_radius: bool = False,
                        row_block: int = 1024, cutoff: float | None = None,
                        desired=None):
    """The plain pair force of ``law`` on this shard's rows of ``axis``
    (the JAX package's jnp path under ``axis_name``, forces.py:115-228):
    ``"gather"`` all-gathers the column planes; ``"ring"`` and
    ``"ring_kernel"`` run the plain ring, the column block and its global
    slot rotating shard i -> i + 1 once per step for D steps
    (``_ring_force``, forces.py:183-203).  Self pairs are masked by global
    slot.  ``(fx, fy)``.  A batch of crowds (``(B, n)`` planes, ``p``
    shared or with ``(B,)`` leaves) goes row by row through
    :func:`plain_batched_force` (the JAX package's vmap of the same
    schedule)."""
    if comm not in AXIS_COMMS:
        raise ValueError(f"axis_comm {comm!r}: one of {AXIS_COMMS}")
    n = pos_x.shape[-1]
    me, d = axis.index, axis.size
    rad = None if law == "helbing" else radius
    cols0 = (pos_x, pos_y, vel_x, vel_y, rad, alive)
    plain = plain_law_force if pos_x.dim() == 1 else plain_batched_force
    args = (law, pos_x, pos_y, vel_x, vel_y, rad, alive, p)
    kw = dict(use_ped_radius=use_ped_radius, row_block=row_block,
              cutoff=cutoff, desired=desired, row_offset=me * n)
    if comm == "gather":
        return plain(*args, cols=_gather(axis, cols0), **kw)
    perm = [(i, (i + 1) % d) for i in range(d)]
    tile = (*cols0, torch.full((1,), me * n, device=pos_x.device))
    fx = torch.zeros_like(pos_x)
    fy = torch.zeros_like(pos_y)
    for step in range(d):
        gx, gy = plain(*args, cols=tile[:6], col_offset=tile[6], **kw)
        fx, fy = fx + gx, fy + gy
        if step < d - 1:
            tile = _rotate(axis, tile, perm)
    return fx, fy


def kernel_sharded_force(law, pos_x, pos_y, vel_x, vel_y, radius, alive, p,
                         axis, comm: str, use_ped_radius: bool = False,
                         symmetric: bool = True, desired=None,
                         cutoff: float | None = None, compact: bool = True,
                         max_surv: int = 0):
    """The pair force of ``law`` on this shard's rows of ``axis`` through
    the kernels (the JAX package's ``pedestrian_force_pallas`` under
    ``axis_name``, pallas_forces.py:751-964), ``(fx, fy)``:

    * ``"gather"``: all-gather the column planes, one rectangular launch
      (with ``cutoff``: the box skip, and above the gate the survivor
      table of ``compact``/``max_surv``);
    * ``"ring"``: the column block (with its tile boxes under a cutoff,
      and a batch's chunk boxes) rotates shard d -> d - 1 (the Pallas
      ring's direction, :753), one rectangular launch per step; with
      ``symmetric`` and an antisymmetric law the half-ring: the local
      triangle on the diagonal, then D // 2 full-block launches whose
      mirrored column sums ride an accumulator with the block and hop
      home at the end (:774-829);
    * ``"ring_kernel"``: the in-kernel ring (:mod:`.cuda_ring`), one launch
      for every shard.

    Rows and columns are the shard's planes as given (sorted, under a
    cutoff); self pairs are masked by global slot.  A batch of crowds
    (``(B, n)`` planes, every crowd sharded alike) launches the batched
    forms, each once for all of the shard's crowds
    (:func:`pair_force_rect_batched`, :func:`pair_force_sym_batched` or
    :func:`pair_force_cutoff_batched` on the diagonal,
    :func:`pair_force_sym_dense_batched`, ``cuda_ring.ring_force_batched``),
    with the batched grids."""
    if comm not in AXIS_COMMS:
        raise ValueError(f"axis_comm {comm!r}: one of {AXIS_COMMS}")
    dev = pos_x.device
    batched = pos_x.dim() == 2
    prm = (law_rows(law, p, pos_x.shape[0], dev) if batched
           else law_vector(law, p, dev))
    rect = pair_force_rect_batched if batched else pair_force_rect
    n = pos_x.shape[-1]
    me, d = axis.index, axis.size
    rad = None if law == "helbing" else radius
    rows = (pos_x, pos_y, vel_x, vel_y, rad, alive)
    kw = dict(use_radius=use_ped_radius, law=law, desired=desired)
    if comm == "gather":
        cols = _gather(axis, rows)
        grid = None if cutoff is None else rect_grid(
            pos_x, pos_y, alive, box_planes(cols[0], cols[1], cols[5],
                                            COL_TILE),
            cols[0].shape[-1], cutoff, compact=compact, max_surv=max_surv,
            cols=(cols[0], cols[1], cols[5]))
        return rect(*rows, prm, cols, row_offset=me * n, grid=grid, **kw)
    if comm == "ring_kernel":
        from .cuda_ring import ring_force_sharded
        return ring_force_sharded(axis, *rows, prm, n, cutoff=cutoff, **kw)
    perm = [(i, (i - 1) % d) for i in range(d)]
    if symmetric and law != "helbing" and d > 1:
        return _half_ring(axis, law, rows, prm, perm, use_ped_radius, cutoff)
    boxes = (None if cutoff is None
             else box_planes(pos_x, pos_y, alive, COL_TILE))
    # a batch's block also carries its chunk boxes (the batched box-skip
    # walk's): built once from the shard's own block, they rotate with it
    chunks = (box_planes(pos_x, pos_y, alive, CHUNK)
              if cutoff is not None and batched else None)
    blk = (*rows, boxes, chunks)
    fx = torch.zeros_like(pos_x)
    fy = torch.zeros_like(pos_y)
    for step in range(d):
        # issue the block's permute before the launch, as the JAX package
        # does so that the transfer overlaps the compute
        nxt = _rotate(axis, blk, perm) if step < d - 1 else None
        grid = None if cutoff is None else rect_grid(
            pos_x, pos_y, alive, blk[6], n, cutoff, compact=False,
            chunk_bb=blk[7])
        gx, gy = rect(*rows, prm, blk[:6], row_offset=me * n,
                      col_offset=((me + step) % d) * n, grid=grid, **kw)
        fx, fy = fx + gx, fy + gy
        blk = nxt
    return fx, fy


def _half_ring(axis, law, rows, prm, perm, use_radius, cutoff):
    """The Newton's-third-law half-ring (pallas_forces.py:774-829): the
    diagonal block through the square symmetric kernel, then s = 1 .. D // 2
    rotations, each a full-block launch against the block of shard
    (me + s) mod D whose -f column sums are added to an accumulator that
    travels with the block; with even D the opposite pair {d, d + D/2} at
    the last step is computed by the lower id only.  Block b's accumulator
    ends at shard b - D // 2 - 1, and one hop of +(D // 2 + 1) sends it
    home.  ``(B, n)`` rows: the batched forms, for all of the shard's
    crowds at once."""
    x, y, vx, vy, rad, alive = rows
    n = x.shape[-1]
    me, d = axis.index, axis.size
    s_comp = d // 2
    tie = d % 2 == 0
    batched = x.dim() == 2
    if cutoff is None:
        sym = pair_force_sym_batched if batched else pair_force_sym
        fx, fy = sym(*rows, prm, use_radius=use_radius, law=law)
        boxes = None
    else:
        grid = cutoff_grid(x, y, alive, cutoff, symmetric=True,
                           compact=False)
        sym = pair_force_cutoff_batched if batched else pair_force_cutoff
        fx, fy = sym(*rows, prm, grid, use_radius=use_radius, law=law)
        boxes = grid.boxes
    blk = _rotate(axis, (*rows, boxes), perm)
    ax = torch.zeros_like(x)
    ay = torch.zeros_like(y)
    for step in range(1, s_comp + 1):
        nxt = _rotate(axis, blk, perm) if step < s_comp else None
        if tie and step == s_comp and me >= d // 2:
            axp, ayp = torch.zeros_like(x), torch.zeros_like(y)
        else:
            grid = (None if cutoff is None
                    else block_grid(boxes, blk[6], cutoff))
            fxp, fyp, axp, ayp = (
                pair_force_sym_dense_batched if batched
                else pair_force_sym_dense)(
                *rows, prm, blk[:6], row_offset=me * n,
                col_offset=((me + step) % d) * n, grid=grid,
                use_radius=use_radius, law=law)
            fx, fy = fx + fxp, fy + fyp
        ax, ay = _rotate(axis, (ax + axp, ay + ayp), perm)
        blk = nxt
    home = [(i, (i + s_comp + 1) % d) for i in range(d)]
    ax, ay = _rotate(axis, (ax, ay), home)
    return fx + ax, fy + ay


def pedestrian_force_kernel(pos_x, pos_y, vel_x, vel_y, radius, alive, p,
                            use_ped_radius: bool = False,
                            symmetric: bool = True, row_block: int = 1024,
                            law: str = "moussaid", desired=None, axis=None,
                            comm: str = "gather"):
    """Pair force of ``law`` on planar tensors, ``(fx, fy)``; ``p`` is the
    law's params (``MoussaidParams``, ``PowerLawParams``,
    ``PedRepulsiveParams``).

    On CPU tensors this is the plain PyTorch version (``row_block`` sizes
    its pairwise blocks); on CUDA tensors it launches
    :func:`pair_force_sym` (``symmetric``; ignored for Helbing, which is
    not antisymmetric, as in the JAX package) or :func:`pair_force_dense`,
    and raises if the kernel cannot be built or launched.  ``axis``: the
    tensors are this shard's rows of an agent axis, and ``comm`` (one of
    ``AXIS_COMMS``) brings in the columns (:func:`plain_sharded_force`,
    :func:`kernel_sharded_force`)."""
    dev = pos_x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no pair-force path for device {dev}")
    if axis is not None:
        if dev.type == "cpu":
            return plain_sharded_force(law, pos_x, pos_y, vel_x, vel_y,
                                       radius, alive, p, axis, comm,
                                       use_ped_radius, row_block,
                                       desired=desired)
        return kernel_sharded_force(law, pos_x, pos_y, vel_x, vel_y, radius,
                                    alive, p, axis, comm, use_ped_radius,
                                    symmetric, desired)
    if dev.type == "cpu":
        return plain_law_force(law, pos_x, pos_y, vel_x, vel_y, radius,
                               alive, p, use_ped_radius, row_block, None,
                               desired)
    form = "sym" if symmetric and law != "helbing" else "dense"
    return _launch(law, form, pos_x, pos_y, vel_x, vel_y, radius, alive,
                   law_vector(law, p, dev), use_ped_radius, desired=desired)


def pedestrian_force_sorted(pos_x, pos_y, vel_x, vel_y, radius, alive, p,
                            cutoff: float, use_ped_radius: bool = False,
                            symmetric: bool = True, compact: bool = True,
                            max_surv: int = 0, spatial_order: str = "hilbert",
                            row_block: int = 1024, order=None,
                            law: str = "moussaid", desired=None, axis=None,
                            comm: str = "gather"):
    """The cutoff pair force of ``law``, ``(fx, fy)`` in slot order: the
    counterpart of the JAX package's ``pedestrian_force_pallas_sorted``.

    Sorts the operands (with ``desired``, the Helbing law's desired
    directions) along the space-filling curve (``spatial_order``; ``order``
    may pass a ``(perm, inv)`` from :func:`..ops.spatial.morton_order` of
    the same positions and liveness, which is the same permutation),
    computes the force over the pairs within ``cutoff``, and scatters it
    back.  On CPU tensors the force is the plain version; on CUDA tensors it is the kernel of
    :func:`..ops.pair_grid.cutoff_grid` (``symmetric``, ``compact``,
    ``max_surv`` choose it; Helbing takes the dense forms whatever
    ``symmetric`` says), or it raises.  ``axis``: the tensors are this
    shard's rows of an agent axis; each shard sorts its own slots and the
    columns come in by ``comm``, their tile boxes with them
    (pallas_forces.py:1102-1154); with ``axis`` the planes may be a batch
    of crowds' ``(B, n)``, each row sorted on its own.  For the Moussaid
    law a cutoff >= 110*gamma*(2*lambda*v_max + 1) gives the no-cutoff
    result exactly."""
    dev = pos_x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no pair-force path for device {dev}")
    perm, inv = order if order is not None else morton_order(
        pos_x, pos_y, alive, spatial_order)
    planes = [a.gather(-1, perm) for a in (pos_x, pos_y, vel_x, vel_y)]
    srad = None if law == "helbing" else radius.gather(-1, perm)
    salive = alive.gather(-1, perm)
    sdesired = (None if desired is None
                else tuple(a.gather(-1, perm) for a in desired))
    plain = dev.type == "cpu"
    if axis is not None and plain:
        fx, fy = plain_sharded_force(law, *planes, srad, salive, p, axis,
                                     comm, use_ped_radius, row_block, cutoff,
                                     sdesired)
    elif axis is not None:
        fx, fy = kernel_sharded_force(law, *planes, srad, salive, p, axis,
                                      comm, use_ped_radius, symmetric,
                                      sdesired, cutoff, compact, max_surv)
    elif plain:
        fx, fy = plain_law_force(law, *planes, srad, salive, p,
                                 use_ped_radius, row_block, cutoff, sdesired)
    else:
        grid = cutoff_grid(planes[0], planes[1], salive, cutoff,
                           symmetric=symmetric and law != "helbing",
                           compact=compact, max_surv=max_surv)
        fx, fy = pair_force_cutoff(*planes, srad, salive,
                                   law_vector(law, p, dev), grid,
                                   use_radius=use_ped_radius, law=law,
                                   desired=sdesired)
    return fx.gather(-1, inv), fy.gather(-1, inv)
