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

A kernel's name, and its key in :data:`LAUNCHES`, is the law's prefix and
the form: ``pair_force_sym`` ... ``pair_force_compact`` for the Moussaid
law, ``powerlaw_sym`` ... ``powerlaw_compact``, ``helbing_dense``,
``helbing_dense_cutoff`` and ``helbing_compact``.

:func:`pedestrian_force_kernel` (all pairs) and
:func:`pedestrian_force_sorted` (the cutoff path: sort, force, unsort)
choose by the tensors' device: CPU tensors go to the plain PyTorch version
(:func:`..ops.forces.pedestrian_force`, ``powerlaw_force`` or
``ped_repulsive_force``), CUDA tensors go to a kernel or raise.  No path
falls back from the kernel to the plain version.
"""
from __future__ import annotations

import torch

from . import forces
from .pair_grid import COL_TILE, SYM_TILE, CutoffGrid, cutoff_grid
from .spatial import morton_order
from ..models.params import (helbing_vector, moussaid_vector,
                             powerlaw_vector)

#: kernel-name prefix, parameter-vector length and the forms of each law
LAWS = {
    "moussaid": ("pair_force", 6, ("sym", "dense", "sym_cutoff",
                                   "sym_compact", "dense_cutoff", "compact")),
    "powerlaw": ("powerlaw", 4, ("sym", "dense", "sym_cutoff",
                                 "sym_compact", "dense_cutoff", "compact")),
    "helbing": ("helbing", 6, ("dense", "dense_cutoff", "compact")),
}

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


def _check_inputs(planes, alive, prm, prm_len):
    x = planes[0]
    if x.device.type != "cuda":
        raise ValueError(f"CUDA pair-force kernels take CUDA tensors, got "
                         f"{x.device}")
    n = x.shape[0]
    for t in planes:
        if (t.device != x.device or t.dtype != torch.float32
                or t.shape != (n,) or not t.is_contiguous()):
            raise ValueError("pair-force planes must be contiguous float32 "
                             f"({n},) tensors on {x.device}; got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if (alive.device != x.device or alive.dtype != torch.bool
            or alive.shape != (n,) or not alive.is_contiguous()):
        raise ValueError(f"alive must be a contiguous bool ({n},) tensor on "
                         f"{x.device}")
    if (prm.device != x.device or prm.dtype != torch.float32
            or prm.shape != (prm_len,) or not prm.is_contiguous()):
        raise ValueError(f"prm must be a contiguous float32 ({prm_len},) "
                         f"tensor on {x.device}")


def _check_grid(grid: CutoffGrid, n: int, dev):
    """The boxes and table a cutoff kernel reads, against the shapes its C
    entry assumes for ``n`` agents."""
    tile = SYM_TILE if grid.form.startswith("sym") else COL_TILE
    want = [("boxes", grid.boxes, torch.float32, (4, -(-n // tile)))]
    if grid.form.endswith("compact"):
        rows = -(-n // SYM_TILE)
        if grid.max_surv < 1:
            raise ValueError("a survivor table needs max_surv >= 1")
        want += [("surv", grid.surv, torch.int32, (rows, grid.max_surv)),
                 ("counts", grid.counts, torch.int32, (rows,))]
    for name, t, dtype, shape in want:
        if (t is None or t.device != dev or t.dtype != dtype
                or t.shape != shape or not t.is_contiguous()):
            raise ValueError(f"{grid.form} needs {name} as a contiguous "
                             f"{dtype} {shape} tensor on {dev}")


def _launch(law: str, form: str, pos_x, pos_y, vel_x, vel_y, radius, alive,
            prm, use_radius: bool, grid: CutoffGrid | None = None,
            desired=None):
    """Check, launch and count the kernel of ``law`` in ``form``.  The
    Moussaid entries read the radii and ``use_radius``; the power-law
    entries the radii (always summed); the Helbing entries the desired
    directions in place of the radii."""
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
    name = f"{prefix}_{form}"
    if law == "helbing":
        planes = (pos_x, pos_y, vel_x, vel_y, *desired)
        flags = []
    else:
        planes = (pos_x, pos_y, vel_x, vel_y, radius)
        flags = [int(use_radius)] if law == "moussaid" else []
    _check_inputs(planes, alive, prm, prm_len)
    n = pos_x.shape[0]
    grid_args = []
    if grid is not None:
        _check_grid(grid, n, pos_x.device)
        grid_args.append(grid.boxes.data_ptr())
        if grid.surv is not None:
            grid_args += [grid.surv.data_ptr(), grid.counts.data_ptr(),
                          grid.max_surv]
        grid_args.append(grid.c2)
    fx = torch.zeros_like(pos_x)
    fy = torch.zeros_like(pos_y)
    if n == 0:
        return fx, fy
    lib = load_kernels()
    with torch.cuda.device(pos_x.device):
        stream = torch.cuda.current_stream(pos_x.device).cuda_stream
        err = getattr(lib, f"sfm_{name}")(
            *(t.data_ptr() for t in planes), alive.data_ptr(), prm.data_ptr(),
            *flags, n, *grid_args, fx.data_ptr(), fy.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.sfm_cuda_error_string(err).decode()})")
    LAUNCHES[name] += 1
    return fx, fy


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


def plain_law_force(law, pos_x, pos_y, vel_x, vel_y, radius, alive, p,
                    use_ped_radius, row_block, cutoff, desired):
    """The plain PyTorch version of ``law``: the CPU path, and the
    reference a step through the kernels is compared with."""
    if law == "moussaid":
        return forces.pedestrian_force(pos_x, pos_y, vel_x, vel_y, radius,
                                       alive, p, use_ped_radius=use_ped_radius,
                                       row_block=row_block, cutoff=cutoff)
    if law == "powerlaw":
        return forces.powerlaw_force(pos_x, pos_y, vel_x, vel_y, radius,
                                     alive, p, row_block=row_block,
                                     cutoff=cutoff)
    return forces.ped_repulsive_force(pos_x, pos_y, vel_x, vel_y, *desired,
                                      alive, p, row_block=row_block,
                                      cutoff=cutoff)


def pedestrian_force_kernel(pos_x, pos_y, vel_x, vel_y, radius, alive, p,
                            use_ped_radius: bool = False,
                            symmetric: bool = True, row_block: int = 1024,
                            law: str = "moussaid", desired=None):
    """Pair force of ``law`` on planar tensors, ``(fx, fy)``; ``p`` is the
    law's params (``MoussaidParams``, ``PowerLawParams``,
    ``PedRepulsiveParams``).

    On CPU tensors this is the plain PyTorch version (``row_block`` sizes
    its pairwise blocks); on CUDA tensors it launches
    :func:`pair_force_sym` (``symmetric``; ignored for Helbing, which is
    not antisymmetric, as in the JAX package) or :func:`pair_force_dense`,
    and raises if the kernel cannot be built or launched."""
    dev = pos_x.device
    if dev.type == "cpu":
        return plain_law_force(law, pos_x, pos_y, vel_x, vel_y, radius,
                               alive, p, use_ped_radius, row_block, None,
                               desired)
    if dev.type != "cuda":
        raise ValueError(f"no pair-force path for device {dev}")
    form = "sym" if symmetric and law != "helbing" else "dense"
    return _launch(law, form, pos_x, pos_y, vel_x, vel_y, radius, alive,
                   law_vector(law, p, dev), use_ped_radius, desired=desired)


def pedestrian_force_sorted(pos_x, pos_y, vel_x, vel_y, radius, alive, p,
                            cutoff: float, use_ped_radius: bool = False,
                            symmetric: bool = True, compact: bool = True,
                            max_surv: int = 0, spatial_order: str = "hilbert",
                            row_block: int = 1024, order=None,
                            law: str = "moussaid", desired=None):
    """The cutoff pair force of ``law``, ``(fx, fy)`` in slot order: the
    counterpart of the JAX package's ``pedestrian_force_pallas_sorted``.

    Sorts the operands (with ``desired``, the Helbing law's desired
    directions) along the space-filling curve (``spatial_order``; ``order``
    may pass a ``(perm, inv)`` from :func:`..ops.spatial.morton_order` of
    the same positions and liveness, which is the same permutation),
    computes the force over the pairs within ``cutoff``, and scatters it
    back.  On CPU tensors the force is the plain version; on CUDA tensors
    it is the kernel of :func:`..ops.pair_grid.cutoff_grid` (``symmetric``,
    ``compact``, ``max_surv`` choose it; Helbing takes the dense forms
    whatever ``symmetric`` says), or it raises.  For the Moussaid law a
    cutoff >= 110*gamma*(2*lambda*v_max + 1) gives the no-cutoff result
    exactly."""
    dev = pos_x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no pair-force path for device {dev}")
    perm, inv = order if order is not None else morton_order(
        pos_x, pos_y, alive, spatial_order)
    planes = [a[perm] for a in (pos_x, pos_y, vel_x, vel_y)]
    srad = None if law == "helbing" else radius[perm]
    salive = alive[perm]
    sdesired = (None if desired is None
                else tuple(a[perm] for a in desired))
    if dev.type == "cpu":
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
    return fx[inv], fy[inv]
