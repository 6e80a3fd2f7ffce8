"""On-demand g++ build + ctypes load of the port's native host components
(``native/*.cpp``; the JAX package's utils/nativelib.py over the port's own
copies).  The libraries go to ``native/build/``, which git ignores."""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

log = logging.getLogger(__name__)

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_LOCK = threading.Lock()
_CACHE: dict[str, ctypes.CDLL | None] = {}


def load(source_name: str) -> ctypes.CDLL | None:
    """Build ``native/<source_name>.cpp`` into a shared lib (cached) and load
    it; returns None when no toolchain is available (callers fall back to
    pure Python)."""
    with _LOCK:
        if source_name in _CACHE:
            return _CACHE[source_name]
        src = os.path.join(NATIVE_DIR, f"{source_name}.cpp")
        out = os.path.join(NATIVE_DIR, "build", f"lib{source_name}.so")
        lib = None
        if os.path.exists(src):
            try:
                os.makedirs(os.path.dirname(out), exist_ok=True)
                if (not os.path.exists(out)
                        or os.path.getmtime(out) < os.path.getmtime(src)):
                    # build beside and rename: a process that loads the
                    # library meanwhile never sees a half-written file
                    tmp = f"{out}.{os.getpid()}.tmp"
                    subprocess.run(
                        ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                         src, "-o", tmp],
                        check=True, capture_output=True, timeout=120)
                    os.replace(tmp, out)
                lib = ctypes.CDLL(out)
            except (subprocess.SubprocessError, OSError) as exc:
                log.warning("native %s unavailable (%s); using Python fallback",
                            source_name, exc)
                lib = None
        _CACHE[source_name] = lib
        return lib
