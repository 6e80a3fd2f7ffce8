"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources under ``csrc/`` compile into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), placed in the
package's ``build/`` directory and rebuilt whenever a source is newer than
it.  Nothing here runs at import: the build happens on the first call that
launches a kernel on a CUDA tensor.

There is no fallback.  A missing nvcc or a failed build raises; callers
holding CUDA tensors must not carry on with another implementation.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
LIBRARY = BUILD_DIR / "libsfm_kernels.so"
BUILD_LOG = BUILD_DIR / "nvcc.log"

#: Hopper target with the architecture-specific features (sm_90a); no
#: --use_fast_math: the kernels' exact f32 semantics are tested against the
#: plain PyTorch versions
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PTR = ctypes.c_void_p
#: C signature of each pair-force entry: x, y, vx, vy, radius, alive, prm,
#: use_radius, n, fx, fy, stream
PAIR_FORCE_ARGTYPES = [_PTR] * 7 + [ctypes.c_int, ctypes.c_int] + [_PTR] * 3
PAIR_FORCE_ENTRIES = ("sfm_pair_force_dense", "sfm_pair_force_sym")


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def sources() -> list[Path]:
    return sorted(SOURCE_DIR.glob("*.cu")) + sorted(SOURCE_DIR.glob("*.cuh"))


def build_kernels() -> Path:
    """Compile ``csrc/*.cu`` into ``build/libsfm_kernels.so`` unless the
    library is newer than every source.  nvcc's output (with ptxas's
    register and shared-memory report) is kept in ``build/nvcc.log``.
    Raises ``RuntimeError`` when nvcc is missing or fails."""
    srcs = sources()
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= max(
            s.stat().st_mtime for s in srcs):
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in srcs if s.suffix == ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, LIBRARY)  # atomic: a concurrent build never sees half
    return LIBRARY


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry's
    argument and result types declared."""
    lib = ctypes.CDLL(str(build_kernels()))
    for name in PAIR_FORCE_ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = PAIR_FORCE_ARGTYPES
        fn.restype = ctypes.c_int
    lib.sfm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sfm_cuda_error_string.restype = ctypes.c_char_p
    return lib
