"""Content-addressed cache for extracted map geometry (a copy of the JAX
package's env/cache.py, numpy only).

Generalizes the reference's sidewalk-border cache (obstacles.py:27-64: .npz
keyed by SHA1(OpenDRIVE content) + resolution, with stale-version eviction
per town) to any named geometry payload (borders, obstacle outlines, nav
graphs).
"""
from __future__ import annotations

import glob
import hashlib
import os

import numpy as np

DEFAULT_CACHE_DIR = os.path.join("cache", "map_geometry")
#: prefix of the names the port's extractions store under (``torch_sidewalk_
#: <town>``, ``torch_navgraph_<town>``).  The JAX package stores the same
#: maps as ``sidewalk_<town>``/``navgraph_<town>`` and evicts ``<name>_*``:
#: neither package's glob matches the other's names
PORT_PREFIX = "torch_"


def content_key(content: str | bytes, *parts) -> str:
    """SHA1 of the content plus stringified parts (e.g. resolution)."""
    h = hashlib.sha1()
    h.update(content.encode("utf-8") if isinstance(content, str) else content)
    for p in parts:
        h.update(str(p).encode("utf-8"))
    return h.hexdigest()


def cache_path(name: str, key: str, cache_dir: str = DEFAULT_CACHE_DIR) -> str:
    return os.path.join(cache_dir, f"{name}_{key}.npz")


def load(name: str, key: str, cache_dir: str = DEFAULT_CACHE_DIR):
    """Return the cached dict-of-arrays or None."""
    path = cache_path(name, key, cache_dir)
    if not os.path.isfile(path):
        return None
    with np.load(path, allow_pickle=True) as data:
        return {k: data[k] for k in data.files}


def store(name: str, key: str, arrays: dict, cache_dir: str = DEFAULT_CACHE_DIR,
          evict_stale: bool = True) -> str:
    """Save arrays; optionally evict older versions of the same name
    (reference obstacles.py:58-61)."""
    os.makedirs(cache_dir, exist_ok=True)
    if evict_stale:
        for old in glob.glob(os.path.join(cache_dir, f"{name}_*")):
            os.remove(old)
    path = cache_path(name, key, cache_dir)
    np.savez_compressed(path, **arrays)
    return path


def ragged_to_arrays(point_lists) -> dict:
    """Flatten a ragged list of (P_i, 2) arrays for npz storage."""
    lengths = np.asarray([len(p) for p in point_lists], np.int64)
    flat = (np.concatenate([np.asarray(p, np.float64).reshape(-1, 2)
                            for p in point_lists], axis=0)
            if point_lists else np.zeros((0, 2)))
    return {"flat_points": flat, "lengths": lengths}


def arrays_to_ragged(arrays: dict):
    """Inverse of :func:`ragged_to_arrays`."""
    flat, lengths = arrays["flat_points"], arrays["lengths"]
    out, off = [], 0
    for n in lengths:
        out.append(flat[off: off + int(n)])
        off += int(n)
    return out
