"""The in-kernel ring of the sharded pair force (port of ops/pallas_ring.py).

:func:`ring_force` launches ``csrc/ring.cu``'s ``sfm_ring_force``: D
virtual devices of ``n_local`` agents each, every device's rows against all
D column blocks, the blocks rotating device to device inside one kernel
(the JAX package's ``_ring_kernel``, ``StepConfig.axis_comm =
"ring_kernel"``).  :func:`ring_force_plain` is its plain PyTorch version:
the plain ring, block by block, in the kernel's rotation order.

:func:`ring_force_batched` launches ``sfm_ring_force_batched``: B crowds,
each over the same D virtual devices, in one launch (the JAX package's
``_ring_kernel`` under vmap), and :func:`ring_force_batched_plain` is its
plain version, crowd by crowd through :func:`ring_force_plain`.

:func:`ring_force_sharded` is the shard's view under an agent axis: on a
:class:`..parallel.mesh.LocalMesh` the shards hand their planes in at a
barrier, shard 0 launches once for all of them, and each takes its rows
back (the launch is a collective); a batch of crowds (``(B, n)`` planes)
on a 2-D mesh launches :func:`ring_force_batched` once for every shard of
every batch row, each row's crowds rings of their own.  A one-process axis
launches with one device; across processes it raises (peer pointers
between cards are not ported yet).  The wrappers take CUDA tensors and
launch the kernel or raise: nothing falls back (on the CPU,
``StepConfig.axis_comm = "ring_kernel"`` runs the plain ring,
``cuda_forces.plain_sharded_force``).
"""
from __future__ import annotations

import torch

from ..models.params import section_rows
from .cuda_forces import plain_law_force
from .pair_grid import COL_TILE, box_planes, cutoff_sq

#: launches of the ring kernels since the last :func:`reset_launch_counts`
LAUNCHES = {"ring_force": 0, "ring_force_batched": 0}

#: the law ids of the C entry (csrc/pair_laws.cuh LawId)
LAW_IDS = {"moussaid": 0, "powerlaw": 1, "helbing": 2}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


#: the comm slots, the counters and the row sets' accumulator of the last
#: shape launched, by device and kernel: ((batch, n_dev, n_local), comm,
#: sync, acc); reused while the shape stays the same
_BUFFERS: dict = {}

#: floats of the accumulator per agent: 8 chunk slots' (x, y) sums, rows
#: rounded up to 256 (the largest item of the batched ring, csrc/ring.cu)
_ACC_PER_ROW, _ACC_ROUND = 16, 256


def _buffers(dev, n_dev: int, n_local: int, slot: int, batch=None):
    """The ``(n_dev, 2, slot)`` comm buffer, the ``4 * n_dev + 1``
    counters and the accumulator of a launch (each ``batch`` times over
    for the batched kernel, whose error word each device's next-crowd
    counter follows; kept across launches of one shape: every launch
    zeroes the counters on the stream first).  Raises (out of memory)
    only where the buffers do not fit on the card."""
    key = (str(dev), batch is not None)
    b = 1 if batch is None else batch
    got = _BUFFERS.get(key)
    if got is None or got[0] != (b, n_dev, n_local):
        _BUFFERS.pop(key, None)
        rows = -(-n_local // _ACC_ROUND) * _ACC_ROUND
        got = ((b, n_dev, n_local),
               torch.empty((b * n_dev, 2, slot), dtype=torch.float32,
                           device=dev),
               torch.zeros(4 * b * n_dev + 1
                           + (0 if batch is None else n_dev),
                           dtype=torch.int32, device=dev),
               torch.empty(b * n_dev * rows * _ACC_PER_ROW,
                           dtype=torch.float32, device=dev))
        _BUFFERS[key] = got
    return got[1:]


def _row_planes(law, x, y, vx, vy, radius, alive, desired):
    """The row slots the kernel reads: (x, y, u, v, radius, alive), with
    (u, v) the velocity, or Helbing's desired direction."""
    if law not in LAW_IDS:
        raise ValueError(f"unknown pair law {law!r}; one of {sorted(LAW_IDS)}")
    if (law == "helbing") != (desired is not None):
        raise ValueError("desired=(ex, ey) planes go with law='helbing' "
                         "only, and that law needs them")
    u, v = desired if law == "helbing" else (vx, vy)
    rad = torch.zeros_like(x) if radius is None else radius
    return x, y, u, v, rad, alive


def _check_planes(planes, alive, shape, dev):
    """The ring's float planes and ``alive`` against ``shape``."""
    for t in planes:
        if (t.device != dev or t.dtype != torch.float32
                or t.shape != shape or not t.is_contiguous()):
            raise ValueError("ring planes must be contiguous float32 "
                             f"{shape} tensors on {dev}")
    if alive.dtype != torch.bool or alive.shape != shape \
            or alive.device != dev or not alive.is_contiguous():
        raise ValueError(f"alive must be a contiguous bool {shape} tensor "
                         f"on {dev}")


def _raise_on(lib, err, word, name):
    """Raise for a refused launch (``err``) or an overrun spin (the error
    ``word`` of the counters); count the launch otherwise."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.sfm_cuda_error_string(err).decode()})")
    LAUNCHES[name] += 1
    if int(word.item()) != 0:
        raise RuntimeError(f"{name}: a device waited past its spin limit "
                           f"for its neighbour (the ring did not complete)")


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
    rows = _row_planes(law, x, y, vx, vy, radius, alive, desired)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the ring kernel takes CUDA tensors, got {dev}")
    total = x.shape[0]
    if n_dev < 1 or total % n_dev:
        raise ValueError(f"{total} agents do not split into {n_dev} devices")
    _check_planes((*rows[:5], vx, vy), alive, (total,), dev)
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
    _raise_on(lib, err, sync[4 * n_dev], "ring_force")
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


def ring_force_batched(x, y, vx, vy, radius, alive, prm, n_dev: int,
                       use_radius: bool = False, law: str = "moussaid",
                       desired=None, cutoff: float | None = None):
    """:func:`ring_force` on B independent crowds at once, one launch: every
    plane ``(B, n_dev * n_local)``, crowd b's device d rows at ``[d *
    n_local, (d + 1) * n_local)`` of row b; ``prm`` ``(B, P)`` (row b's
    parameter vector, ``models/params.law_rows``; one row at stride 0 when
    the crowds share it).  Returns ``(fx, fy)``, ``(B, n_dev * n_local)``:
    row b equals :func:`ring_force` on crowd b bitwise.  Raises as
    :func:`ring_force`."""
    from ..utils.cuda_build import load_kernels
    rows = _row_planes(law, x, y, vx, vy, radius, alive, desired)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the ring kernel takes CUDA tensors, got {dev}")
    if x.dim() != 2:
        raise ValueError(f"the batched ring takes (B, N) planes, got "
                         f"{tuple(x.shape)}")
    batch, total = x.shape
    if n_dev < 1 or total % n_dev:
        raise ValueError(f"{total} agents do not split into {n_dev} devices")
    _check_planes((*rows[:5], vx, vy), alive, (batch, total), dev)
    if (prm.device != dev or prm.dtype != torch.float32 or prm.dim() != 2
            or prm.shape[0] != batch or prm.stride(-1) != 1
            or prm.stride(0) not in (0, prm.shape[1])):
        raise ValueError(f"prm must be a float32 (B={batch}, P) tensor on "
                         f"{dev} with contiguous rows (or one row at "
                         f"stride 0)")
    if batch * total >= 2 ** 31:
        raise ValueError(f"{batch} x {total} agents exceed the kernel's "
                         f"32-bit indices")
    n = total // n_dev
    fx = torch.zeros_like(x)
    fy = torch.zeros_like(y)
    if n == 0:
        return fx, fy
    n_ct = -(-n // COL_TILE)
    # each (crowd, device)'s own block: the planes, then its tile boxes
    planes = torch.stack([x, y, vx, vy, rows[4], alive.to(torch.float32)])
    planes = planes.reshape(6, batch, n_dev, n).permute(1, 2, 0, 3)
    planes = planes.reshape(batch, n_dev, 6 * n)
    if cutoff is not None:
        boxes = box_planes(x.reshape(batch * n_dev, n),
                           y.reshape(batch * n_dev, n),
                           alive.reshape(batch * n_dev, n), COL_TILE)
        boxes = boxes.reshape(batch, n_dev, 4 * n_ct)
    else:
        boxes = planes.new_zeros((batch, n_dev, 4 * n_ct))
    cols = torch.cat([planes, boxes], dim=2).contiguous()
    comm, sync, acc = _buffers(dev, n_dev, n, cols.shape[2], batch)
    sync.zero_()  # the counters start from zero on every launch
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sfm_ring_force_batched(
            LAW_IDS[law], batch, n_dev, n, *(t.data_ptr() for t in rows),
            cols.data_ptr(), comm.data_ptr(), sync.data_ptr(),
            acc.data_ptr(), prm.data_ptr(), prm.stride(0),
            int(use_radius), int(cutoff is not None),
            cutoff_sq(cutoff) if cutoff is not None else 0.0,
            fx.data_ptr(), fy.data_ptr(), stream)
    _raise_on(lib, err, sync[4 * batch * n_dev], "ring_force_batched")
    return fx, fy


def ring_force_batched_plain(x, y, vx, vy, radius, alive, p, n_dev: int,
                             use_radius: bool = False, law: str = "moussaid",
                             desired=None, cutoff: float | None = None,
                             row_block: int = 1024):
    """The plain version of :func:`ring_force_batched`: crowd b through
    :func:`ring_force_plain` with row b's parameters (``p``: the law's
    params, shared or with ``(B,)`` leaves)."""
    out = []
    for b, pb in enumerate(section_rows(p, x.shape[0])):
        out.append(ring_force_plain(
            x[b], y[b], vx[b], vy[b], None if radius is None else radius[b],
            alive[b], pb, n_dev, use_radius, law,
            None if desired is None else (desired[0][b], desired[1][b]),
            cutoff, row_block))
    return tuple(torch.stack(parts) for parts in zip(*out))


def ring_force_sharded(axis, x, y, vx, vy, radius, alive, prm, n_local: int,
                       use_radius: bool = False, law: str = "moussaid",
                       desired=None, cutoff: float | None = None):
    """This shard's rows of :func:`ring_force` over every shard of
    ``axis``: a collective (every shard must call it).  The planes are the
    shard's own, on a card.  ``(B, n_local)`` planes (a batch of crowds,
    ``prm`` the shard's ``(B, P)`` rows) launch :func:`ring_force_batched`
    once for every shard of the mesh: batch row r's crowds follow row r -
    1's, each crowd ringing over its own row's shards."""
    if x.dim() == 2:
        return _ring_sharded_batched(axis, x, y, vx, vy, radius, alive, prm,
                                     n_local, use_radius, law, desired,
                                     cutoff)
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


def _ring_sharded_batched(axis, x, y, vx, vy, radius, alive, prm,
                          n_local, use_radius, law, desired, cutoff):
    """:func:`ring_force_sharded` of ``(B, n_local)`` planes."""
    mine = (x, y, vx, vy, radius, alive, desired, prm)
    d_size = axis.size

    def launch(parts):
        rows = [parts[r:r + d_size] for r in range(0, len(parts), d_size)]

        def cat(get):
            # each batch row's crowds with its shards' slots side by side,
            # the rows one after the other
            if get(parts[0]) is None:
                return None
            return torch.cat([torch.cat([get(q) for q in row], dim=-1)
                              for row in rows])
        planes = [cat(lambda q, i=i: q[i]) for i in range(6)]
        want = (None if desired is None else
                tuple(cat(lambda q, c=c: q[6][c]) for c in range(2)))
        prms = torch.cat([row[0][7].contiguous() for row in rows])
        fx, fy = ring_force_batched(*planes, prms, d_size,
                                    use_radius=use_radius, law=law,
                                    desired=want, cutoff=cutoff)
        out, lo = [], 0
        for row in rows:
            hi = lo + row[0][0].shape[0]
            out += [(fx[lo:hi, d * n_local:(d + 1) * n_local],
                     fy[lo:hi, d * n_local:(d + 1) * n_local])
                    for d in range(d_size)]
            lo = hi
        return out

    return axis.host_collective(launch, mine)
