"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources under ``csrc/`` compile into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), placed in the
package's ``build/`` directory and rebuilt whenever a source is newer than
it.  Each ``.cu`` compiles in its own nvcc process, all started together,
and one more nvcc links the objects.  Nothing here runs at import: the
build happens on the first call that launches a kernel on a CUDA tensor.

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
#: plain PyTorch versions; -lineinfo keeps each instruction's source line
#: (no change to the code) for tools/sass_census.py
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float
#: the pair entries' leading arguments: law, then the row planes (x, y, u,
#: v, radius, alive), n_rows, row_off, the column planes, n_cols, col_off,
#: prm, use_radius (the rectangular walks); or law, x, y, vx, vy, radius,
#: alive, prm, use_radius, n (the square symmetric walks)
_RECT = ([_INT] + [_PTR] * 6 + [_INT, _INT] + [_PTR] * 6 + [_INT, _INT]
         + [_PTR, _INT])
_SQUARE = [_INT] + [_PTR] * 7 + [_INT, _INT]
#: C signature of each entry, by name (see the extern "C" blocks in csrc/)
ARGTYPES = {
    # ..., fx, fy, stream
    "sfm_pair_dense": _RECT + [_PTR] * 3,
    "sfm_pair_sym": _SQUARE + [_PTR] * 3,
    # ..., col_bb (bb), c2, fx, fy, stream
    "sfm_pair_dense_cutoff": _RECT + [_PTR, _FLOAT] + [_PTR] * 3,
    "sfm_pair_sym_cutoff": _SQUARE + [_PTR, _FLOAT] + [_PTR] * 3,
    # ..., col_bb (bb), surv, counts, max_surv, c2, fx, fy, stream
    "sfm_pair_compact": _RECT + [_PTR] * 3 + [_INT, _FLOAT] + [_PTR] * 3,
    "sfm_pair_sym_compact": (_SQUARE + [_PTR] * 3 + [_INT, _FLOAT]
                             + [_PTR] * 3),
    # ..., [row_bb, col_bb, c2,] fx, fy, fxc, fyc, stream
    "sfm_pair_sym_dense": _RECT + [_PTR] * 5,
    "sfm_pair_sym_dense_cutoff": _RECT + [_PTR, _PTR, _FLOAT] + [_PTR] * 5,
    # law, x, y, vx, vy, rad, alive, prm, prm_stride, use_radius, n, batch,
    # fx, fy, stream
    "sfm_pair_sym_batched": [_INT] + [_PTR] * 7 + [_INT] * 4 + [_PTR] * 3,
    # law, the row planes, the column planes, prm, prm_stride, use_radius,
    # n, batch, fx, fy, stream
    "sfm_pair_dense_batched": [_INT] + [_PTR] * 13 + [_INT] * 4 + [_PTR] * 3,
    # law, n_dev, n_local, rx, ry, ru, rv, rrad, ralive, cols, comm, sync,
    # acc, prm, use_radius, cutoff, c2, fx, fy, stream
    "sfm_ring_force": ([_INT] * 3 + [_PTR] * 11 + [_INT, _INT, _FLOAT]
                       + [_PTR] * 3),
    # px, py, prad, alive, ptx, pty, k, lens, cx, cy, r2, s_count, a, b,
    # use_radius, n, fx, fy, stream
    "sfm_env_exp": ([_PTR] * 6 + [_INT] + [_PTR] * 4
                    + [_INT, _FLOAT, _FLOAT, _INT, _INT] + [_PTR] * 3),
    # px, py, pvx, pvy, prad, alive, ptx, pty, k, lens, cx, cy, r2, ov,
    # s_count, prm, use_radius, n, fx, fy, stream
    "sfm_env_moussaid": ([_PTR] * 8 + [_INT] + [_PTR] * 5 + [_INT, _PTR]
                         + [_INT, _INT] + [_PTR] * 3),
    # sfm_env_exp's arguments up to n, then surv, counts, max_surv, gs, fx,
    # fy, stream
    "sfm_env_exp_compact": ([_PTR] * 6 + [_INT] + [_PTR] * 4
                            + [_INT, _FLOAT, _FLOAT, _INT, _INT] + [_PTR] * 2
                            + [_INT, _INT] + [_PTR] * 3),
    # sfm_env_moussaid's arguments up to n, then surv, counts, max_surv, gs,
    # fx, fy, stream
    "sfm_env_moussaid_compact": ([_PTR] * 8 + [_INT] + [_PTR] * 5
                                 + [_INT, _PTR] + [_INT, _INT] + [_PTR] * 2
                                 + [_INT, _INT] + [_PTR] * 3),
    # px, py, prad, alive, ptx, pty, k, lens, cx, cy, r2, r2_stride,
    # s_count, prm, prm_stride, use_radius, n, batch, fx, fy, stream
    "sfm_env_exp_batched": ([_PTR] * 6 + [_INT] + [_PTR] * 4 + [_INT, _INT]
                            + [_PTR] + [_INT] * 4 + [_PTR] * 3),
    # px, py, pvx, pvy, prad, alive, ptx, pty, k, lens, cx, cy, r2,
    # r2_stride, ov, s_count, prm, prm_stride, use_radius, n, batch, fx, fy,
    # stream
    "sfm_env_moussaid_batched": ([_PTR] * 8 + [_INT] + [_PTR] * 4
                                 + [_INT, _PTR, _INT, _PTR] + [_INT] * 4
                                 + [_PTR] * 3),
    # px, py, prad, alive, ax, ay, ux, uy, il2, m, lens, cx, cy, r2,
    # s_count, a, b, use_radius, n, fx, fy, stream
    "sfm_env_exp_analytic": ([_PTR] * 9 + [_INT] + [_PTR] * 4
                             + [_INT, _FLOAT, _FLOAT, _INT, _INT]
                             + [_PTR] * 3),
    # sfm_env_exp_analytic's arguments up to n, then surv, counts, max_surv,
    # gs, fx, fy, stream
    "sfm_env_exp_analytic_compact": ([_PTR] * 9 + [_INT] + [_PTR] * 4
                                     + [_INT, _FLOAT, _FLOAT, _INT, _INT]
                                     + [_PTR] * 2 + [_INT, _INT]
                                     + [_PTR] * 3),
    # px, py, alive, ax, ay, ux, uy, il2, ccx, ccy, rad, f, nd, nd2, k, n,
    # d2, wx, wy, stream
    "sfm_seg_topk": ([_PTR] * 11 + [_INT, _FLOAT, _FLOAT, _INT, _INT]
                     + [_PTR] * 4),
    # px, py, alive, x, y, c, kk, lens, cx, cy, rad, nd, nd2, k, n, d2, wx,
    # wy, stream
    "sfm_chunk_topk": ([_PTR] * 5 + [_INT, _INT] + [_PTR] * 4
                       + [_FLOAT, _FLOAT, _INT, _INT] + [_PTR] * 4),
    # sfm_chunk_topk's arguments without k
    "sfm_chunk_closest": ([_PTR] * 5 + [_INT, _INT] + [_PTR] * 4
                          + [_FLOAT, _FLOAT, _INT] + [_PTR] * 4),
    # px, py, fx, fy, c, kk, n, d2, idx, stream
    "sfm_chunk_argmin": [_PTR] * 4 + [_INT, _INT, _INT] + [_PTR] * 3,
}


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
    library is newer than every source: one nvcc per source, in parallel,
    then one link.  nvcc's output (with ptxas's register and shared-memory
    report) is kept in ``build/nvcc.log``.  Raises ``RuntimeError`` when
    nvcc is missing or fails."""
    srcs = sources()
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= max(
            s.stat().st_mtime for s in srcs):
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = os.getpid()
    compiles = []
    for src in (s for s in srcs if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        compiles.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, _, proc in compiles:
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]}: exit code {proc.returncode}\n{err}")
    objs = [obj for _, obj, _ in compiles]
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{tag}.tmp")
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
               *(str(o) for o in objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link: exit code {proc.returncode}\n{proc.stderr}")
    BUILD_LOG.write_text("".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, LIBRARY)  # atomic: a concurrent build never sees half
    return LIBRARY


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry's
    argument and result types declared."""
    lib = ctypes.CDLL(str(build_kernels()))
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sfm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sfm_cuda_error_string.restype = ctypes.c_char_p
    return lib
