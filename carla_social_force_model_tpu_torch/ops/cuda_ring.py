"""The in-kernel ring of the sharded pair force (port of ops/pallas_ring.py).

:func:`ring_force` launches ``csrc/ring.cu``'s ``sfm_ring_force``: D
virtual devices of ``n_local`` agents each, every device's rows against all
D column blocks, the blocks rotating device to device inside one kernel
(the JAX package's ``_ring_kernel``, ``StepConfig.axis_comm =
"ring_kernel"``).  :func:`ring_force_plain` is its plain PyTorch version:
the plain ring, block by block, in the kernel's rotation order.

:func:`ring_force_sharded` is the shard's view under an agent axis: on a
:class:`..parallel.mesh.LocalMesh` the shards hand their planes in at a
barrier, shard 0 launches once for all of them, and each takes its rows
back (the launch is a collective); a one-process axis launches with one
device; across processes it raises (peer pointers between cards are not
ported yet).  The wrappers take CUDA tensors and launch the kernel or
raise: nothing falls back (on the CPU, ``StepConfig.axis_comm =
"ring_kernel"`` runs the plain ring, ``cuda_forces.plain_sharded_force``).
"""
from __future__ import annotations

import torch

from .cuda_forces import plain_law_force
from .pair_grid import COL_TILE, box_planes, cutoff_sq

#: launches of the ring kernel since the last :func:`reset_launch_counts`
LAUNCHES = {"ring_force": 0}

#: the law ids of the C entry (csrc/pair_laws.cuh LawId)
LAW_IDS = {"moussaid": 0, "powerlaw": 1, "helbing": 2}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


#: the comm slots, the counters and the row sets' accumulator of the last
#: shape launched, by device: (n_dev, n_local, comm, sync, acc); reused
#: while the shape stays the same
_BUFFERS: dict = {}

#: floats of the accumulator per agent: 8 warps' (x, y) sums, rows rounded
#: up to 128 (the largest row set, csrc/ring.cu)
_ACC_PER_ROW, _ACC_ROUND = 16, 128


def _buffers(dev, n_dev: int, n_local: int, slot: int):
    """The ``(n_dev, 2, slot)`` comm buffer, the ``4 * n_dev + 1``
    counters and the accumulator of a launch (kept across launches of one
    shape: every launch zeroes the counters on the stream first).  Raises
    (out of memory) only where the buffers do not fit on the card."""
    key = str(dev)
    got = _BUFFERS.get(key)
    if got is None or got[:2] != (n_dev, n_local):
        _BUFFERS.pop(key, None)
        rows = -(-n_local // _ACC_ROUND) * _ACC_ROUND
        got = (n_dev, n_local,
               torch.empty((n_dev, 2, slot), dtype=torch.float32,
                           device=dev),
               torch.zeros(4 * n_dev + 1, dtype=torch.int32, device=dev),
               torch.empty(n_dev * rows * _ACC_PER_ROW, dtype=torch.float32,
                           device=dev))
        _BUFFERS[key] = got
    return got[2:]


def _row_planes(law, x, y, vx, vy, radius, alive, desired):
    """The row slots the kernel reads: (x, y, u, v, radius, alive), with
    (u, v) the velocity, or Helbing's desired direction."""
    u, v = desired if law == "helbing" else (vx, vy)
    rad = torch.zeros_like(x) if radius is None else radius
    return x, y, u, v, rad, alive


def ring_force(x, y, vx, vy, radius, alive, prm, n_dev: int,
               use_radius: bool = False, law: str = "moussaid",
               desired=None, cutoff: float | None = None):
    """One launch of the ring over ``n_dev`` virtual devices: every plane is
    the ``(n_dev * n_local,)`` concatenation of the devices' planes, in
    device order (each device's rows are also its column block).  Returns
    ``(fx, fy)`` in the same layout.  ``prm``: the law's parameter vector
    (``cuda_forces.law_vector``); Helbing needs ``desired=(ex, ey)`` and
    reads no radius.  ``cutoff`` [m]: the per-pair cutoff and the skip of
    tile boxes beyond it (the planes of each device should then be sorted
    along a space-filling curve).  Any shard that fits in memory runs: the
    kernel's blocks loop over row sets where one block per row set would
    not be resident.  Raises when the kernel cannot be built, its buffers do
    not fit on the card, or a spin overran."""
    from ..utils.cuda_build import load_kernels
    if law not in LAW_IDS:
        raise ValueError(f"unknown pair law {law!r}; one of {sorted(LAW_IDS)}")
    if (law == "helbing") != (desired is not None):
        raise ValueError("desired=(ex, ey) planes go with law='helbing' "
                         "only, and that law needs them")
    rows = _row_planes(law, x, y, vx, vy, radius, alive, desired)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the ring kernel takes CUDA tensors, got {dev}")
    total = x.shape[0]
    if n_dev < 1 or total % n_dev:
        raise ValueError(f"{total} agents do not split into {n_dev} devices")
    for t in (*rows[:5], vx, vy):
        if (t.device != dev or t.dtype != torch.float32
                or t.shape != (total,) or not t.is_contiguous()):
            raise ValueError("ring planes must be contiguous float32 "
                             f"({total},) tensors on {dev}")
    if alive.dtype != torch.bool or alive.shape != (total,) \
            or alive.device != dev or not alive.is_contiguous():
        raise ValueError(f"alive must be a contiguous bool ({total},) "
                         f"tensor on {dev}")
    n = total // n_dev
    fx = torch.zeros_like(x)
    fy = torch.zeros_like(y)
    if n == 0:
        return fx, fy
    n_ct = -(-n // COL_TILE)
    # each device's own block: the planes, then its 256-column tile boxes
    planes = torch.stack([x, y, vx, vy, rows[4], alive.to(torch.float32)])
    planes = planes.reshape(6, n_dev, n).transpose(0, 1).reshape(n_dev, -1)
    if cutoff is not None:
        boxes = torch.stack([box_planes(x[d * n:(d + 1) * n],
                                        y[d * n:(d + 1) * n],
                                        alive[d * n:(d + 1) * n], COL_TILE)
                             for d in range(n_dev)]).reshape(n_dev, -1)
    else:
        boxes = planes.new_zeros((n_dev, 4 * n_ct))
    cols = torch.cat([planes, boxes], dim=1).contiguous()
    comm, sync, acc = _buffers(dev, n_dev, n, cols.shape[1])
    sync.zero_()  # the counters start from zero on every launch
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sfm_ring_force(
            LAW_IDS[law], n_dev, n, *(t.data_ptr() for t in rows),
            cols.data_ptr(), comm.data_ptr(), sync.data_ptr(),
            acc.data_ptr(), prm.data_ptr(),
            int(use_radius), int(cutoff is not None),
            cutoff_sq(cutoff) if cutoff is not None else 0.0,
            fx.data_ptr(), fy.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ring_force launch failed: CUDA error {err} "
                           f"({lib.sfm_cuda_error_string(err).decode()})")
    LAUNCHES["ring_force"] += 1
    if int(sync[-1].item()) != 0:
        raise RuntimeError("ring_force: a device waited past its spin limit "
                           "for its neighbour (the ring did not complete)")
    return fx, fy


def ring_force_plain(x, y, vx, vy, radius, alive, p, n_dev: int,
                     use_radius: bool = False, law: str = "moussaid",
                     desired=None, cutoff: float | None = None,
                     row_block: int = 1024):
    """The plain version of :func:`ring_force` on the same layout: device
    d's rows against the block of device (d - k) mod D at step k, summed in
    that order (``p`` is the law's params)."""
    n = x.shape[0] // n_dev
    out_x, out_y = [], []
    for d in range(n_dev):
        sl = slice(d * n, (d + 1) * n)
        ex = None if desired is None else tuple(a[sl] for a in desired)
        ax = torch.zeros(n, dtype=x.dtype, device=x.device)
        ay = torch.zeros_like(ax)
        for k in range(n_dev):
            s = (d - k) % n_dev
            cs = slice(s * n, (s + 1) * n)
            cols = tuple(None if a is None else a[cs]
                         for a in (x, y, vx, vy, radius, alive))
            fx, fy = plain_law_force(
                law, x[sl], y[sl], vx[sl], vy[sl],
                None if radius is None else radius[sl], alive[sl], p,
                use_radius, row_block, cutoff, ex, cols, d * n, s * n)
            ax, ay = ax + fx, ay + fy
        out_x.append(ax)
        out_y.append(ay)
    return torch.cat(out_x), torch.cat(out_y)


def ring_force_sharded(axis, x, y, vx, vy, radius, alive, prm, n_local: int,
                       use_radius: bool = False, law: str = "moussaid",
                       desired=None, cutoff: float | None = None):
    """This shard's rows of :func:`ring_force` over every shard of
    ``axis``: a collective (every shard must call it).  The planes are the
    shard's own, on a card."""
    mine = (x, y, vx, vy, radius, alive, desired)

    def launch(parts):
        def cat(i):
            if parts[0][i] is None:
                return None
            if i == 6:
                return tuple(torch.cat([q[6][c] for q in parts])
                             for c in range(2))
            return torch.cat([q[i] for q in parts])
        fx, fy = ring_force(*(cat(i) for i in range(6)), prm, len(parts),
                            use_radius=use_radius, law=law, desired=cat(6),
                            cutoff=cutoff)
        return [(fx[d * n_local:(d + 1) * n_local],
                 fy[d * n_local:(d + 1) * n_local])
                for d in range(len(parts))]

    return axis.host_collective(launch, mine)
