"""CUDA pair-force kernels and their dispatch (port of ops/pallas_forces.py).

Two kernels from ``csrc/pair_forces.cu``, each behind a ctypes wrapper that
checks its inputs, allocates its outputs, launches on PyTorch's current
stream and counts the launch:

* :func:`pair_force_sym` -- each unordered pair once, +f to the row and -f
  to the column (the JAX package's ``_pair_kernel_sym``); the default.
* :func:`pair_force_dense` -- every row summed over every column (the JAX
  package's ``_pair_kernel``); deterministic.

:func:`pedestrian_force_kernel` chooses by the tensors' device: CPU tensors
go to the plain PyTorch version (:func:`..ops.forces.pedestrian_force`),
CUDA tensors go to a kernel or raise.  No path falls back from the kernel to
the plain version.
"""
from __future__ import annotations

import torch

from . import forces
from ..models.params import MoussaidParams, moussaid_vector

#: launches per kernel since the last :func:`reset_launch_counts`; each
#: wrapper adds one where it launches its kernel and nowhere else
LAUNCHES = {"pair_force_sym": 0, "pair_force_dense": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_inputs(planes, alive, prm):
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
            or prm.shape != (6,) or not prm.is_contiguous()):
        raise ValueError(f"prm must be a contiguous float32 (6,) tensor on "
                         f"{x.device}")


def _launch(name: str, pos_x, pos_y, vel_x, vel_y, radius, alive, prm,
            use_radius: bool):
    from ..utils.cuda_build import load_kernels
    planes = (pos_x, pos_y, vel_x, vel_y, radius)
    _check_inputs(planes, alive, prm)
    fx = torch.zeros_like(pos_x)
    fy = torch.zeros_like(pos_y)
    n = pos_x.shape[0]
    if n == 0:
        return fx, fy
    lib = load_kernels()
    with torch.cuda.device(pos_x.device):
        stream = torch.cuda.current_stream(pos_x.device).cuda_stream
        err = getattr(lib, f"sfm_{name}")(
            *(t.data_ptr() for t in planes), alive.data_ptr(), prm.data_ptr(),
            int(use_radius), n, fx.data_ptr(), fy.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.sfm_cuda_error_string(err).decode()})")
    LAUNCHES[name] += 1
    return fx, fy


def pair_force_sym(pos_x, pos_y, vel_x, vel_y, radius, alive, prm,
                   use_radius: bool = False):
    """Moussaid pair force, Newton's-third-law kernel: ``(fx, fy)``.

    Row and column partials are combined with atomics, so the summation
    order (and the last bits of the result) vary from run to run."""
    return _launch("pair_force_sym", pos_x, pos_y, vel_x, vel_y, radius,
                   alive, prm, use_radius)


def pair_force_dense(pos_x, pos_y, vel_x, vel_y, radius, alive, prm,
                     use_radius: bool = False):
    """Moussaid pair force, dense per-row kernel: ``(fx, fy)``,
    deterministic."""
    return _launch("pair_force_dense", pos_x, pos_y, vel_x, vel_y, radius,
                   alive, prm, use_radius)


def pedestrian_force_kernel(pos_x, pos_y, vel_x, vel_y, radius, alive,
                            p: MoussaidParams, use_ped_radius: bool = False,
                            symmetric: bool = True, row_block: int = 1024):
    """Pedestrian pair force on planar tensors, ``(fx, fy)``.

    On CPU tensors this is the plain PyTorch version (``row_block`` sizes
    its pairwise blocks); on CUDA tensors it launches
    :func:`pair_force_sym` (``symmetric``) or :func:`pair_force_dense`,
    and raises if the kernel cannot be built or launched."""
    dev = pos_x.device
    if dev.type == "cpu":
        return forces.pedestrian_force(pos_x, pos_y, vel_x, vel_y, radius,
                                       alive, p, use_ped_radius=use_ped_radius,
                                       row_block=row_block)
    if dev.type != "cuda":
        raise ValueError(f"no pair-force path for device {dev}")
    kernel = pair_force_sym if symmetric else pair_force_dense
    return kernel(pos_x, pos_y, vel_x, vel_y, radius, alive,
                  moussaid_vector(p, dev), use_radius=use_ped_radius)
