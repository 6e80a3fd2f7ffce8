"""The ORCA wall feed: each pedestrian's ``k`` nearest wall features (port
of ops/pallas_statics.py, and of the JAX package's ``_cpc_kernel`` behind
``geometry.closest_point_per_chunk``), and the chunk scan of the chunked
environment forces (the JAX package's ``_cp_kernel`` behind
``geometry.closest_point_per_segment``).

Four kernels from ``csrc/statics.cu`` and three batched forms, each behind
a wrapper that checks its inputs, allocates its outputs, launches on
PyTorch's current stream and counts the launch:

* :func:`seg_topk` -- a running top-k (k <= 8) of ``(d2, wx, wy)`` over the
  segment features (``env/pointsets.SegmentFeatures``) within the
  neighbour distance, the closest point taken exactly on each segment.
  The JAX package's ``_seg_topk_kernel``.
* :func:`chunk_topk` -- the same over the chunks of a sampled remainder
  (``env/pointsets.ChunkFeatures``), each chunk's first-occurrence closest
  point being one candidate.  The JAX package's ``_chunk_topk_kernel``.
* :func:`chunk_closest` -- the (C, N) planes of every chunk's closest
  point, the scan of :func:`chunk_topk` without the merge.  The JAX
  package's ``_cpc_kernel``.
* :func:`seg_topk_batched`, :func:`chunk_topk_batched` and
  :func:`chunk_closest_batched` -- the three over B crowds' ``(B, n)``
  planes in one launch each (an ensemble, or a sweep whose neighbour
  distance is a ``(B,)`` tensor), row b equal to the unbatched kernel on
  row b bitwise.  The JAX package runs its kernels under ``vmap`` there.
* :func:`chunk_argmin` -- every (chunk, pedestrian)'s minimum squared
  distance and the flat index of the first point that reaches it, (C, N),
  over every pair (no skip).  The JAX package's ``_cp_kernel``; its plain
  version is ``geometry.chunk_argmin_plain``, its entry
  ``geometry.closest_point_per_segment``.  :func:`chunk_argmin_batched` is
  the same kernel over B crowds' flattened ``(B, N)`` planes (counted
  apart), and :func:`chunk_argmin_percrowd` its form for B crowds that
  each scan their own chunks (a batch of fleets' vehicles), crowd on the
  grid's third axis.

Each block of the three wall-feed kernels holds 32 consecutive
pedestrians (the caller's order: ORCA's are Hilbert-sorted, so the boxes
are tight), 4 or 8 threads each, and skips every feature whose
filter circle, inflated by the neighbour distance, misses the box of its
alive pedestrians; the in-kernel ``d2 <= neigh_dist^2`` test keeps the skip
exact.  Features are visited in ascending index, and each enters its
running list before the first strictly larger entry, so the selection and
its order (ties to the lower index) are those of
``geometry.k_smallest_features``.  A dead pedestrian's row is undefined
when ``alive`` is given (its block's box leaves it out); the caller masks
it.

:func:`nearest_features_topk` is the entry: on CUDA tensors it launches
:func:`seg_topk` or :func:`chunk_topk`; on CPU tensors it runs the plain
version :func:`topk_plain`, the (F, N) planes of ``ops/geometry.py``
reduced by ``k_smallest_features``.  No path falls back from a kernel to the
plain version.
"""
from __future__ import annotations

import torch

from .geometry import (chunk_closest_plain, feature_closest_planes,
                       k_smallest_features, squared_reach)
from ..env.pointsets import SegmentFeatures

#: the most nearest features a kernel keeps per pedestrian (its running list
#: lives in registers; the JAX package's ``_KP`` output rows)
MAX_K = 8

#: launches per kernel since the last :func:`reset_launch_counts`; each
#: wrapper adds one where it launches its kernel and nowhere else
LAUNCHES = {"seg_topk": 0, "chunk_topk": 0, "chunk_closest": 0,
            "chunk_argmin": 0, "chunk_argmin_batched": 0,
            "seg_topk_batched": 0, "chunk_topk_batched": 0,
            "chunk_closest_batched": 0, "chunk_argmin_percrowd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(named, dev):
    for name, t, shape in named:
        if (t.device != dev or t.dtype != torch.float32 or t.shape != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 {shape} "
                             f"tensor on {dev}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _peds(pos_x, pos_y, alive, dims=1):
    """Checked pedestrian arguments, ``(n,)`` planes or with ``dims`` 2 a
    batch's ``(B, n)`` (B crowds on one grid axis): the planes' pointers
    and the alive mask's (0 = every pedestrian in the boxes)."""
    dev, shape = pos_x.device, tuple(pos_x.shape)
    if pos_x.dim() != dims or (dims == 2 and shape[0] > 65_535):
        raise ValueError(f"the {'batched ' if dims == 2 else ''}statics "
                         f"kernels take {'(B, n)' if dims == 2 else '(n,)'} "
                         f"planes (B <= 65,535), got {shape}")
    if dev.type != "cuda":
        raise ValueError(f"the statics kernels need CUDA tensors, got {dev}")
    _check((("pos_x", pos_x, shape), ("pos_y", pos_y, shape)), dev)
    if alive is not None and (alive.device != dev or alive.dtype != torch.bool
                              or tuple(alive.shape) != shape
                              or not alive.is_contiguous()):
        raise ValueError(f"alive must be a contiguous bool {shape} tensor on "
                         f"{dev}")
    return (pos_x.data_ptr(), pos_y.data_ptr(),
            0 if alive is None else alive.data_ptr())


def _launch(name, args, outs, dev, key=None):
    """Launch ``sfm_<name>`` and count it under ``key`` (default
    ``name``)."""
    from ..utils.cuda_build import load_kernels
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"sfm_{name}")(*args, *(o.data_ptr() for o in outs),
                                          stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.sfm_cuda_error_string(err).decode()})")
    LAUNCHES[key or name] += 1
    return outs


def _nd(neigh_dist):
    return float(neigh_dist), squared_reach(neigh_dist)


def _nd_rows(neigh_dist, batch, dev):
    """The neighbour-distance arguments of a batched launch, ``(nd, nd2,
    nd_rows, nd2_rows)``, and the tensors they point into: a number is
    every crowd's (null rows); a sweep's ``(batch,)`` tensor gives each
    crowd its float32 value and that value's float32 square (the JAX
    package's ``jnp.float32(neigh_dist) ** 2`` under vmap)."""
    if not isinstance(neigh_dist, torch.Tensor):
        return (*_nd(neigh_dist), None, None), ()
    nd = neigh_dist.to(device=dev, dtype=torch.float32).contiguous()
    if nd.shape != (batch,):
        raise ValueError(f"a swept neighbour distance must be a ({batch},) "
                         f"tensor, got {tuple(nd.shape)}")
    nd2 = nd * nd
    return (0.0, 0.0, nd.data_ptr(), nd2.data_ptr()), (nd, nd2)


def _check_k(k: int):
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if k > MAX_K:
        raise ValueError(f"k must be <= {MAX_K}, got {k} (the running list "
                         f"of the top-k kernels holds {MAX_K} slots)")


def _features(feat: SegmentFeatures, dev):
    """The checked segment-feature arguments of the segment top-k: the
    eight planes' pointers and F."""
    f = feat.num_features
    names = ("ax", "ay", "ux", "uy", "il2", "ccx", "ccy", "rad")
    _check(((name, getattr(feat, name), (f,)) for name in names), dev)
    return (*(getattr(feat, name).data_ptr() for name in names), f)


def seg_topk(pos_x, pos_y, feat: SegmentFeatures, k: int, neigh_dist,
             alive=None):
    """The ``k`` nearest segment features of each pedestrian within
    ``neigh_dist`` on the card: ``(d2, wx, wy)`` of shape (k, N),
    ascending, ``d2 = inf`` (and ``wx = wy = 0``) in empty slots."""
    _check_k(k)
    peds = _peds(pos_x, pos_y, alive)
    dev, n = pos_x.device, pos_x.shape[0]
    args = (*peds, *_features(feat, dev), *_nd(neigh_dist), k, n)
    outs = tuple(torch.empty((k, n), dtype=torch.float32, device=dev)
                 for _ in range(3))
    if n == 0:
        return outs
    return _launch("seg_topk", args, outs, dev)


def _chunks(chunks, dev):
    """The checked chunk arguments of the chunk kernels: the point planes'
    pointers, C, K, the real lengths' pointer and the circles'."""
    c, kk = chunks.x.shape
    _check((("chunk x", chunks.x, (c, kk)), ("chunk y", chunks.y, (c, kk)),
            ("center_x", chunks.center_x, (c,)),
            ("center_y", chunks.center_y, (c,)),
            ("radius", chunks.radius, (c,))), dev)
    lens = chunks.lengths
    if (lens.device != dev or lens.dtype != torch.int32 or lens.shape != (c,)
            or not lens.is_contiguous()):
        raise ValueError(f"chunk lengths must be a contiguous int32 ({c},) "
                         f"tensor on {dev}")
    return (chunks.x.data_ptr(), chunks.y.data_ptr(), c, kk, lens.data_ptr(),
            chunks.center_x.data_ptr(), chunks.center_y.data_ptr(),
            chunks.radius.data_ptr())


def chunk_topk(pos_x, pos_y, chunks, k: int, neigh_dist, alive=None):
    """:func:`seg_topk` over the chunks of ``chunks``
    (``env/pointsets.ChunkFeatures``): one candidate per chunk, its
    first-occurrence closest point, each chunk scanned up to its last
    valid slot (``chunks.lengths``)."""
    _check_k(k)
    peds = _peds(pos_x, pos_y, alive)
    n, dev = pos_x.shape[0], pos_x.device
    args = (*peds, *_chunks(chunks, dev), *_nd(neigh_dist), k, n)
    outs = tuple(torch.empty((k, n), dtype=torch.float32, device=dev)
                 for _ in range(3))
    if n == 0:
        return outs
    return _launch("chunk_topk", args, outs, dev)


def chunk_closest(pos_x, pos_y, chunks, neigh_dist, alive=None):
    """Every chunk's closest point on the card: ``(d2, wx, wy)`` of shape
    (C, N), ``d2 = inf`` beyond ``neigh_dist`` (a chunk skipped for a block
    leaves ``wx = wy = 0``), each chunk scanned up to its last valid slot
    (``chunks.lengths``); see ``geometry.closest_point_per_chunk``."""
    peds = _peds(pos_x, pos_y, alive)
    n, dev = pos_x.shape[0], pos_x.device
    args = (*peds, *_chunks(chunks, dev), *_nd(neigh_dist), n)
    outs = tuple(torch.empty((chunks.num_chunks, n), dtype=torch.float32,
                             device=dev) for _ in range(3))
    if n == 0 or chunks.num_chunks == 0:
        return outs
    return _launch("chunk_closest", args, outs, dev)


def seg_topk_batched(pos_x, pos_y, feat: SegmentFeatures, k: int,
                     neigh_dist, alive=None):
    """:func:`seg_topk` of B crowds, ``(B, n)`` planes against one set of
    features, in one launch: ``(d2, wx, wy)`` of shape (B, k, n), row b
    equal to :func:`seg_topk` on row b bitwise.  ``neigh_dist`` a number
    (an ensemble) or a ``(B,)`` tensor (a sweep: each crowd's own filter
    and gate)."""
    _check_k(k)
    peds = _peds(pos_x, pos_y, alive, dims=2)
    (batch, n), dev = pos_x.shape, pos_x.device
    nds, _keep = _nd_rows(neigh_dist, batch, dev)
    args = (*peds, *_features(feat, dev), *nds, k, n, batch)
    outs = tuple(torch.empty((batch, k, n), dtype=torch.float32, device=dev)
                 for _ in range(3))
    if batch * n == 0:
        return outs
    return _launch("seg_topk_batched", args, outs, dev)


def chunk_topk_batched(pos_x, pos_y, chunks, k: int, neigh_dist,
                       alive=None):
    """:func:`chunk_topk` of B crowds in one launch, laid out as
    :func:`seg_topk_batched`'s (B, k, n) outputs."""
    _check_k(k)
    peds = _peds(pos_x, pos_y, alive, dims=2)
    (batch, n), dev = pos_x.shape, pos_x.device
    nds, _keep = _nd_rows(neigh_dist, batch, dev)
    args = (*peds, *_chunks(chunks, dev), *nds, k, n, batch)
    outs = tuple(torch.empty((batch, k, n), dtype=torch.float32, device=dev)
                 for _ in range(3))
    if batch * n == 0:
        return outs
    return _launch("chunk_topk_batched", args, outs, dev)


def chunk_closest_batched(pos_x, pos_y, chunks, neigh_dist, alive=None):
    """:func:`chunk_closest` of B crowds in one launch: ``(d2, wx, wy)`` of
    shape (C, B, n), the layout of :func:`chunk_argmin_batched`, as views
    of (B, C, n) planes (each crowd's (C, n) planes contiguous, where the
    kernel writes them); row b equals :func:`chunk_closest` on row b
    bitwise (a block never holds two crowds, so each crowd's boxes skip
    what they skip alone)."""
    peds = _peds(pos_x, pos_y, alive, dims=2)
    (batch, n), dev = pos_x.shape, pos_x.device
    nds, _keep = _nd_rows(neigh_dist, batch, dev)
    args = (*peds, *_chunks(chunks, dev), *nds, n, batch)
    outs = tuple(torch.empty((batch, chunks.num_chunks, n),
                             dtype=torch.float32, device=dev)
                 for _ in range(3))
    if batch * n > 0 and chunks.num_chunks > 0:
        _launch("chunk_closest_batched", args, outs, dev)
    return tuple(o.transpose(0, 1) for o in outs)


def chunk_argmin(pos_x, pos_y, fx, fy):
    """Every chunk's minimum squared distance and first-occurrence flat
    index on the card: ``(dmin, idx)`` of shape (C, N), float32 and int32,
    from the staged (C, K) chunk planes ``fx, fy`` (``PAD_COORD`` in invalid
    slots, ``geometry.staged_chunk_planes``); see
    ``geometry.chunk_argmin_plain``."""
    peds = _peds(pos_x, pos_y, None)[:2]
    c, kk = fx.shape
    n, dev = pos_x.shape[0], pos_x.device
    _check((("fx", fx, (c, kk)), ("fy", fy, (c, kk))), dev)
    outs = (torch.empty((c, n), dtype=torch.float32, device=dev),
            torch.empty((c, n), dtype=torch.int32, device=dev))
    if n == 0 or c == 0:
        return outs
    return _launch("chunk_argmin", (*peds, fx.data_ptr(), fy.data_ptr(), c,
                                    kk, n), outs, dev)


def chunk_argmin_batched(pos_x, pos_y, fx, fy):
    """:func:`chunk_argmin` of B crowds, ``(B, n)`` planes against one set
    of chunks: ``(dmin, idx)`` of shape (C, B, n), one launch of the same
    kernel over the B * n pedestrians of the flattened planes (the scan
    reads nothing of a crowd but its pedestrians, so under the JAX
    package's ``vmap`` of ``_cp_kernel`` only the pedestrians are batched).
    Row b equals :func:`chunk_argmin` on row b bitwise: each (chunk,
    pedestrian)'s scan is the same sequence of operations wherever the
    pedestrian lies in the grid."""
    if pos_x.dim() != 2:
        raise ValueError(f"chunk_argmin_batched takes (B, n) planes, got "
                         f"{tuple(pos_x.shape)}")
    batch, n = pos_x.shape
    c, kk = fx.shape
    # the kernel's pedestrian index and flat point index are 32-bit; its
    # output offsets ch * (B * n) + i are 64-bit
    if batch * n >= 2 ** 31 or c * kk >= 2 ** 31:
        raise ValueError(f"{batch} x {n} pedestrians or {c} x {kk} chunk "
                         f"slots exceed the kernel's 32-bit indices")
    _check((("pos_x", pos_x, (batch, n)), ("pos_y", pos_y, (batch, n))),
           pos_x.device)
    peds = _peds(pos_x.view(-1), pos_y.view(-1), None)[:2]
    dev = pos_x.device
    _check((("fx", fx, (c, kk)), ("fy", fy, (c, kk))), dev)
    outs = (torch.empty((c, batch, n), dtype=torch.float32, device=dev),
            torch.empty((c, batch, n), dtype=torch.int32, device=dev))
    if batch * n == 0 or c == 0:
        return outs
    return _launch("chunk_argmin", (*peds, fx.data_ptr(), fy.data_ptr(), c,
                                    kk, batch * n), outs, dev,
                   key="chunk_argmin_batched")


def chunk_argmin_percrowd(pos_x, pos_y, fx, fy):
    """:func:`chunk_argmin` of B crowds that each scan their own chunks:
    ``(B, n)`` planes against ``(B, C, K)`` staged planes (a batch of
    fleets' vehicle outlines), one launch: ``(dmin, idx)`` of shape (C, B,
    n), the layout of :func:`chunk_argmin_batched`, as views of (B, C, n)
    planes; crowd b's flat indices point into its own (C, K) planes.  Row
    b equals :func:`chunk_argmin` on crowd b's planes bitwise (a block
    holds one crowd's pedestrians)."""
    if pos_x.dim() != 2 or fx.dim() != 3:
        raise ValueError(f"chunk_argmin_percrowd takes (B, n) planes and "
                         f"(B, C, K) chunk planes, got {tuple(pos_x.shape)} "
                         f"and {tuple(fx.shape)}")
    peds = _peds(pos_x, pos_y, None, dims=2)[:2]
    (batch, n), dev = pos_x.shape, pos_x.device
    _, c, kk = fx.shape
    if c * kk >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"{c} x {kk} chunk slots or {n} pedestrians exceed "
                         f"the kernel's 32-bit indices")
    _check((("fx", fx, (batch, c, kk)), ("fy", fy, (batch, c, kk))), dev)
    outs = (torch.empty((batch, c, n), dtype=torch.float32, device=dev),
            torch.empty((batch, c, n), dtype=torch.int32, device=dev))
    if batch * n > 0 and c > 0:
        _launch("chunk_argmin_percrowd", (*peds, fx.data_ptr(),
                                          fy.data_ptr(), c, kk, n, batch),
                outs, dev)
    return tuple(o.transpose(0, 1) for o in outs)


def topk_plain(pos_x, pos_y, src, k: int, neigh_dist):
    """The plain version of :func:`seg_topk` and :func:`chunk_topk` on any
    device: the (F, N) planes of ``ops/geometry.py`` reduced by
    ``k_smallest_features`` (the JAX package's pallas_statics.py:329-345);
    every row computed.  A batch's ``(B, N)`` planes give (B, k, N), the
    plain version of the batched kernels (``neigh_dist`` a number or a
    sweep's ``(B,)`` tensor); row b equals the function on row b
    bitwise."""
    if isinstance(src, SegmentFeatures):
        d2, wx, wy = feature_closest_planes(pos_x, pos_y, src, neigh_dist)
    else:
        d2, wx, wy = chunk_closest_plain(pos_x, pos_y, src, neigh_dist)
    # the features' axis next to the pedestrians' ((F, B, N) -> (B, F, N))
    d2, wx, wy = (a.movedim(0, -2) for a in (d2, wx, wy))
    dfin = torch.where(torch.isfinite(d2), d2, 0.0)
    (swx, swy, sd2), valid = k_smallest_features(d2, (wx, wy, dfin), k)
    return torch.where(valid, sd2, torch.inf), swx, swy


def nearest_features_topk(pos_x, pos_y, src, k: int, neigh_dist,
                          alive=None):
    """The ``k`` nearest wall features of each pedestrian within
    ``neigh_dist``: ``(d2, wx, wy)`` of shape (k, N), distances ascending,
    ``d2 = inf`` in empty slots.  ``src`` is a
    :class:`..env.pointsets.SegmentFeatures` or
    :class:`..env.pointsets.ChunkFeatures`; ``alive`` tightens the kernels'
    skip (a dead row is then undefined).  On CUDA tensors the
    ``seg_topk`` or ``chunk_topk`` kernel, on CPU tensors
    :func:`topk_plain`.  The JAX package's pallas_statics.py:302-345.
    A batch of crowds' ``(B, N)`` planes give (B, k, N): on a card one
    launch of ``seg_topk_batched`` or ``chunk_topk_batched`` for every
    row, ``neigh_dist`` a number or a sweep's ``(B,)`` tensor."""
    _check_k(k)
    if pos_x.device.type == "cuda":
        seg = isinstance(src, SegmentFeatures)
        if pos_x.dim() == 1:
            fn = seg_topk if seg else chunk_topk
        else:
            fn = seg_topk_batched if seg else chunk_topk_batched
        return fn(pos_x, pos_y, src, k, neigh_dist, alive)
    return topk_plain(pos_x, pos_y, src, k, neigh_dist)
