"""The ORCA wall feed: each pedestrian's ``k`` nearest wall features (port
of ops/pallas_statics.py, and of the JAX package's ``_cpc_kernel`` behind
``geometry.closest_point_per_chunk``), and the chunk scan of the chunked
environment forces (the JAX package's ``_cp_kernel`` behind
``geometry.closest_point_per_segment``).

Four kernels from ``csrc/statics.cu``, each behind a wrapper that checks
its inputs, allocates its outputs, launches on PyTorch's current stream and
counts the launch:

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
* :func:`chunk_argmin` -- every (chunk, pedestrian)'s minimum squared
  distance and the flat index of the first point that reaches it, (C, N),
  over every pair (no skip).  The JAX package's ``_cp_kernel``; its plain
  version is ``geometry.chunk_argmin_plain``, its entry
  ``geometry.closest_point_per_segment``.  :func:`chunk_argmin_batched` is
  the same kernel over B crowds' flattened ``(B, N)`` planes (counted
  apart).

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
            "chunk_argmin": 0, "chunk_argmin_batched": 0}


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


def _peds(pos_x, pos_y, alive):
    """Checked pedestrian arguments: the planes' pointers and the alive
    mask's (0 = every pedestrian in the boxes)."""
    dev, n = pos_x.device, pos_x.shape[0]
    if dev.type != "cuda":
        raise ValueError(f"the statics kernels need CUDA tensors, got {dev}")
    _check((("pos_x", pos_x, (n,)), ("pos_y", pos_y, (n,))), dev)
    if alive is not None and (alive.device != dev or alive.dtype != torch.bool
                              or alive.shape != (n,)
                              or not alive.is_contiguous()):
        raise ValueError(f"alive must be a contiguous bool ({n},) tensor on "
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


def _check_k(k: int):
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if k > MAX_K:
        raise ValueError(f"k must be <= {MAX_K}, got {k} (the running list "
                         f"of the top-k kernels holds {MAX_K} slots)")


def seg_topk(pos_x, pos_y, feat: SegmentFeatures, k: int, neigh_dist,
             alive=None):
    """The ``k`` nearest segment features of each pedestrian within
    ``neigh_dist`` on the card: ``(d2, wx, wy)`` of shape (k, N),
    ascending, ``d2 = inf`` (and ``wx = wy = 0``) in empty slots."""
    _check_k(k)
    peds = _peds(pos_x, pos_y, alive)
    f, dev, n = feat.num_features, pos_x.device, pos_x.shape[0]
    _check(((name, getattr(feat, name), (f,)) for name in
            ("ax", "ay", "ux", "uy", "il2", "ccx", "ccy", "rad")), dev)
    outs = tuple(torch.empty((k, n), dtype=torch.float32, device=dev)
                 for _ in range(3))
    if n == 0:
        return outs
    return _launch("seg_topk", (*peds, *(getattr(feat, a).data_ptr() for a in
                                         ("ax", "ay", "ux", "uy", "il2",
                                          "ccx", "ccy", "rad")),
                                f, *_nd(neigh_dist), k, n), outs, dev)


def _chunk_args(pos_x, pos_y, chunks, neigh_dist, alive):
    peds = _peds(pos_x, pos_y, alive)
    c, kk = chunks.x.shape
    _check((("chunk x", chunks.x, (c, kk)), ("chunk y", chunks.y, (c, kk)),
            ("center_x", chunks.center_x, (c,)),
            ("center_y", chunks.center_y, (c,)),
            ("radius", chunks.radius, (c,))), pos_x.device)
    return (*peds, chunks.x.data_ptr(), chunks.y.data_ptr(), c, kk,
            chunks.center_x.data_ptr(), chunks.center_y.data_ptr(),
            chunks.radius.data_ptr(), *_nd(neigh_dist))


def _lengths(chunks, dev):
    """The pointer of the chunks' real lengths."""
    lens, c = chunks.lengths, chunks.num_chunks
    if (lens.device != dev or lens.dtype != torch.int32 or lens.shape != (c,)
            or not lens.is_contiguous()):
        raise ValueError(f"chunk lengths must be a contiguous int32 ({c},) "
                         f"tensor on {dev}")
    return lens.data_ptr()


def chunk_topk(pos_x, pos_y, chunks, k: int, neigh_dist, alive=None):
    """:func:`seg_topk` over the chunks of ``chunks``
    (``env/pointsets.ChunkFeatures``): one candidate per chunk, its
    first-occurrence closest point, each chunk scanned up to its last
    valid slot (``chunks.lengths``)."""
    _check_k(k)
    args = _chunk_args(pos_x, pos_y, chunks, neigh_dist, alive)
    n, dev = pos_x.shape[0], pos_x.device
    outs = tuple(torch.empty((k, n), dtype=torch.float32, device=dev)
                 for _ in range(3))
    if n == 0:
        return outs
    args = (*args[:7], _lengths(chunks, dev), *args[7:])
    return _launch("chunk_topk", (*args, k, n), outs, dev)


def chunk_closest(pos_x, pos_y, chunks, neigh_dist, alive=None):
    """Every chunk's closest point on the card: ``(d2, wx, wy)`` of shape
    (C, N), ``d2 = inf`` beyond ``neigh_dist`` (a chunk skipped for a block
    leaves ``wx = wy = 0``), each chunk scanned up to its last valid slot
    (``chunks.lengths``); see ``geometry.closest_point_per_chunk``."""
    args = _chunk_args(pos_x, pos_y, chunks, neigh_dist, alive)
    n, dev = pos_x.shape[0], pos_x.device
    outs = tuple(torch.empty((chunks.num_chunks, n), dtype=torch.float32,
                             device=dev) for _ in range(3))
    if n == 0 or chunks.num_chunks == 0:
        return outs
    args = (*args[:7], _lengths(chunks, dev), *args[7:])
    return _launch("chunk_closest", (*args, n), outs, dev)


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


def topk_plain(pos_x, pos_y, src, k: int, neigh_dist):
    """The plain version of :func:`seg_topk` and :func:`chunk_topk` on any
    device: the (F, N) planes of ``ops/geometry.py`` reduced by
    ``k_smallest_features`` (the JAX package's pallas_statics.py:329-345);
    every row computed."""
    if isinstance(src, SegmentFeatures):
        d2, wx, wy = feature_closest_planes(pos_x, pos_y, src, neigh_dist)
    else:
        d2, wx, wy = chunk_closest_plain(pos_x, pos_y, src, neigh_dist)
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
    :func:`topk_plain`.  The JAX package's pallas_statics.py:302-345."""
    _check_k(k)
    if pos_x.device.type == "cuda":
        fn = seg_topk if isinstance(src, SegmentFeatures) else chunk_topk
        return fn(pos_x, pos_y, src, k, neigh_dist, alive)
    return topk_plain(pos_x, pos_y, src, k, neigh_dist)
