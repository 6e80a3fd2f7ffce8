"""The debug build of ``tools/kernel_redesign_bench.py --counters``: its
counters are patched into a copy of the port's CUDA sources at anchor
lines, so an edit of the walks that moves an anchor must show here, on
the CPU, and not first on the card.
"""
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import kernel_redesign_bench as bench  # noqa: E402

CSRC = Path("carla_social_force_model_tpu_torch") / "csrc"


@pytest.fixture
def copy(tmp_path):
    shutil.copytree(ROOT / CSRC, tmp_path / CSRC)
    return tmp_path


def body_of(src, signature):
    """The source of the function whose definition starts with
    ``signature``, to its closing brace."""
    body = src[src.index(signature):]
    return body[:body.index("\n}\n")]


def test_every_counter_lands_in_the_walks(copy):
    """Each counter is added where the walk it counts does that work: the
    dense walk's tile staging, chunk culling, overflow and blocks, the law
    calls of its inner loop and its chunks with a pair, and each of the
    batched box-skip and table walk's; the symmetric walks' tile pairs,
    chunk pairs tested and walked, law calls, chunk pairs with a pair,
    atomics, overflowing and empty blocks, in the unbatched walk
    (sym_walk, sym_tile_pair) and in the batched cutoff walk
    (sym_rows_walk); the C entries that read and reset them come before
    the last entry."""
    bench.instrument(copy)
    src = (copy / CSRC / "pair_forces.cu").read_text()
    laws = (copy / CSRC / "pair_laws.cuh").read_text()
    n = len(bench.COUNTERS)
    assert n == 10
    assert (f"static __device__ unsigned long long sfm_walk_counters[{n}];"
            in laws)
    assert laws.count("sfm_walk_counters[2]") == 1
    assert laws.count("sfm_walk_counters[7]") == 1
    for k, times in ((0, 3), (1, 4), (2, 3), (3, 3), (4, 4), (5, 4), (6, 3),
                     (7, 3), (8, 4), (9, 4)):
        assert src.count(f"sfm_walk_counters[{k}]") == times, k
    for entry in ("sfm_walk_counters_read", "sfm_walk_counters_reset",
                  "sfm_walk_attributes"):
        assert src.index(f"int {entry}(") < src.index(
            "const char* sfm_cuda_error_string")
    chunk = body_of(src, "__device__ __forceinline__ void chunk_walk(")
    for k in (1, 2, 3, 4, 5, 6, 7):
        assert f"sfm_walk_counters[{k}]" in chunk, k
    rows = body_of(src, "__device__ __forceinline__ void sym_rows_walk(")
    for k in range(n):
        assert f"sfm_walk_counters[{k}]" in rows, k
    tile_pair = body_of(src, "__device__ __forceinline__ void sym_tile_pair(")
    for k in (0, 1, 2, 3, 6, 7, 8):
        assert f"sfm_walk_counters[{k}]" in tile_pair, k
    walk = body_of(src, "__device__ __forceinline__ void sym_walk(")
    for k in (4, 5, 9):
        assert f"sfm_walk_counters[{k}]" in walk, k
    for _, kernel, _ in bench.ATTRIBUTE_KERNELS:
        assert f"(const void*){kernel};" in src


def test_instrument_is_idempotent_and_leaves_the_package_alone(copy):
    """A second patch of the same copy changes nothing, and the checkout's
    own sources carry no counter."""
    bench.instrument(copy)
    once = {p.name: p.read_text() for p in (copy / CSRC).iterdir()}
    bench.instrument(copy)
    assert once == {p.name: p.read_text() for p in (copy / CSRC).iterdir()}
    for p in (ROOT / CSRC).iterdir():
        assert "sfm_walk_counters" not in p.read_text()


def test_a_moved_anchor_of_the_dense_walk_raises(copy):
    """The dense walk's anchors are required: a source without one is not
    silently left uncounted."""
    path = copy / CSRC / "pair_forces.cu"
    path.write_text(path.read_text().replace(
        "    const int j0 = (int)(t * kColTile);\n",
        "    const int j0 = t * kColTile;\n"))
    with pytest.raises(RuntimeError, match="no anchor"):
        bench.instrument(copy)


def test_a_moved_anchor_of_the_batched_symmetric_walk_raises(copy):
    """Where the checkout has the batched symmetric cutoff walk
    (sym_rows_walk), its anchors are required too; a checkout without it
    (an older parent) is instrumented without them."""
    path = copy / CSRC / "pair_forces.cu"
    text = path.read_text()
    path.write_text(text.replace("      stage(tj == ti);\n",
                                 "      stage(ti == tj);\n"))
    with pytest.raises(RuntimeError, match="no anchor"):
        bench.instrument(copy)
    start = text.index("template <int kWalk, class Law>\n"
                       "__device__ __forceinline__ void sym_rows_walk(")
    end = text.index("\n}\n", start) + 3
    path.write_text(text[:start] + text[end:])
    bench.instrument(copy)
    assert "sfm_walk_counters[9]" in path.read_text()


def test_every_dense_phase_counter_lands_in_both_dense_bodies(copy):
    """The dense walks' phase counters (thread 0's cycles: zeroing,
    staging, barriers, walking, folding; blocks, stagings and chunks
    walked) land in the unbatched body (dense_walk, the parent's batched
    all-tiles walk) and, but for zeroing, in the batched all-tiles walk's
    own body (dense_batch_walk); each body adds its block cycles once per
    way out, and pair_forces.cu's entries read and reset them."""
    bench.instrument(copy)
    src = (copy / CSRC / "pair_forces.cu").read_text()
    n = len(bench.DENSE_COUNTERS)
    assert n == 9
    assert (f"static __device__ unsigned long long sfm_dense_counters[{n}];"
            in src)
    old = body_of(src, "__device__ __forceinline__ void dense_walk(")
    new = body_of(src, "__device__ __forceinline__ void dense_batch_walk(")
    for k in range(n):
        assert f"sfm_dense_counters[{k}]" in old, k
        if k != 2:
            assert f"sfm_dense_counters[{k}]" in new, k
    assert "sfm_dense_counters[2]" not in new
    assert old.count("sfm_dense_counters[1]") == 1
    assert new.count("sfm_dense_counters[1]") == 2  # with and without a split
    chunk = body_of(src, "__device__ __forceinline__ void chunk_walk(")
    assert "sfm_dense_counters" not in chunk
    for entry in ("sfm_dense_counters_read", "sfm_dense_counters_reset"):
        assert src.index(f"int {entry}(") < src.index(
            "const char* sfm_cuda_error_string")


def test_a_moved_anchor_of_the_batched_all_tiles_walk_raises(copy):
    """Where the checkout has the batched all-tiles walk's own body
    (dense_batch_walk), its anchors are required; a checkout without it
    (the parent, whose batched all-tiles kernel runs dense_walk) is
    instrumented without them."""
    path = copy / CSRC / "pair_forces.cu"
    text = path.read_text()
    path.write_text(text.replace(
        "  if (n_split == 1) {  // grid-uniform: no cluster\n",
        "  if (n_split < 2) {  // grid-uniform: no cluster\n"))
    with pytest.raises(RuntimeError, match="no anchor"):
        bench.instrument(copy)
    start = text.index("template <class Law>\n"
                       "__device__ __forceinline__ void dense_batch_walk(")
    end = text.index("\n}\n", start) + 3
    path.write_text(text[:start] + text[end:])
    bench.instrument(copy)
    src = path.read_text()
    assert src.count("sfm_dense_counters[1]") == 1


def lambda_body(src, start):
    """The source of the lambda whose definition starts with ``start``, to
    its closing ``};``."""
    body = src[src.index(start):]
    return body[:body.index("\n  };\n")]


def test_every_ring_counter_lands_in_both_ring_bodies(copy):
    """The batched ring's counters (polls, cycles of each phase of a step,
    chunk steps, tiles staged and visited) land in its own body's step
    (ring_batch_walk) and, but for the done polls, in ring_walk (the
    unbatched ring, and the parent's batched one, which counts its fill
    and done polls together); its step trace stamps each step of the
    body four times; ring.cu's entries read them and name the kernels of
    its own body."""
    bench.instrument(copy)
    src = (copy / CSRC / "ring.cu").read_text()
    n = len(bench.RING_COUNTERS)
    assert n == 11
    assert f"static __device__ unsigned long long sfm_ring_counters[{n}];" \
        in src
    step = lambda_body(src, "  auto step = [&](int b, int k, int rank, "
                            "int nq) {\n")
    old = body_of(src, "__device__ __forceinline__ bool ring_walk(")
    waits = body_of(src, "__device__ bool wait_at_least(")
    for k in range(n):
        assert f"sfm_ring_counters[{k}]" in step, k
        if k == 1:
            assert f"sfm_ring_counters[{k}]" in waits
        elif k != 2:
            assert f"sfm_ring_counters[{k}]" in old, k
    assert "sfm_ring_counters[2]" not in old
    # the step trace: four stamps a step, the block's SM once
    assert step.count("%%globaltimer") == 4
    assert "%%smid" in src and "sfm_ring_smid[" in src
    for entry in ("sfm_ring_counters_read", "sfm_ring_counters_reset",
                  "sfm_ring_attributes"):
        assert src.index(f"int {entry}(") > src.index('extern "C" {')
    for _, kernel, _ in bench.RING_ATTRIBUTE_KERNELS:
        assert f"(const void*){kernel};" in src
    # the inner loop's law counters are this file's own copy
    assert "sfm_walk_counters" in src


def test_a_moved_anchor_of_the_batched_ring_raises(copy):
    """Where the checkout has the batched ring's own body, its anchors are
    required; a checkout without it (the parent, whose batched kernel runs
    ring_walk) is instrumented without them and names its kernels by the
    parent's template."""
    path = copy / CSRC / "ring.cu"
    text = path.read_text()
    path.write_text(text.replace("        ok = pf >= 0 && pd >= 0;\n",
                                 "        ok = pd >= 0 && pf >= 0;\n"))
    with pytest.raises(RuntimeError, match="no anchor"):
        bench.instrument(copy)
    start = text.index("template <bool kCutoff, class Law, bool kMulti>\n"
                       "__device__ __forceinline__ bool ring_batch_walk(")
    end = text.index("\n}\n", start) + 3
    path.write_text(text[:start] + text[end:])
    for name in ("pair_laws.cuh", "pair_forces.cu"):
        (copy / CSRC / name).write_text((ROOT / CSRC / name).read_text())
    bench.instrument(copy)
    src = path.read_text()
    assert "sfm_ring_counters[2]" not in src
    for _, _, kernel in bench.RING_ATTRIBUTE_KERNELS:
        assert f"(const void*){kernel};" in src


def test_every_symmetric_warp_counter_lands_in_both_symmetric_bodies(copy):
    """The batched symmetric walks' per-warp counters (each warp's cycles
    in loads and staging, barriers, walking and the flush, its law steps
    and atomics) land in the unbatched tile pair (sym_tile_pair: the
    parent's 1b and 4-b, 4-b's box form) and in the redesign's own body
    (sym_batch_walk: the diagonal's items and the tiles off it each count
    their law steps, and the columns' and the rows' atomics are counted
    where they go out); each body stamps every phase, records its warps
    once, at its end, and its block's trace (SM, global timer at its start
    and end); pair_forces.cu's entries read and reset them."""
    bench.instrument(copy)
    src = (copy / CSRC / "pair_forces.cu").read_text()
    n = len(bench.SYM_WARP_COUNTERS)
    assert n == 7
    assert bench.SYM_WARP_SLOTS == 8  # sym_batch_walk's warps a block
    assert ("static __device__ unsigned long long sfm_sym_warps["
            f"{bench.SYM_WARP_BLOCKS * bench.SYM_WARP_SLOTS * n}];") in src
    old = body_of(src, "__device__ __forceinline__ void sym_tile_pair(")
    new = body_of(src, "__device__ __forceinline__ void sym_batch_walk(")
    for body in (old, new):
        for k in range(4):
            assert f"sfm_ph_[{k}] += sfm_c1_ - sfm_c0_" in body, k
        assert body.count("atomicAdd(&sfm_sym_warps[") == 1
        assert body.count("%%globaltimer") == 2  # the block's trace
        assert body.rstrip().endswith(
            "sfm_sym_trace[sfm_b_ * 3u + 2u] = sfm_g1_; } }")
    assert old.count("sfm_ph_[5] +=") == 1 and old.count("sfm_ph_[6] +=") == 1
    assert new.count("sfm_ph_[5] +=") == 2 and new.count("sfm_ph_[6] +=") == 2
    assert ("static __device__ unsigned long long sfm_sym_trace["
            f"{bench.SYM_WARP_BLOCKS * 3}];") in src
    for entry in ("sfm_sym_warps_read", "sfm_sym_trace_read",
                  "sfm_sym_warps_reset"):
        assert src.index(f"int {entry}(") < src.index(
            "const char* sfm_cuda_error_string")
    for label, kernel, threads in bench.ATTRIBUTE_KERNELS:
        if "sym_dense_batched" in label or "kTriangle," in label:
            block = "kSymTile" if "<true" in label else "kSymAllThreads"
            assert threads == ("kSymTile" if "<true" in label else None)
            assert (f"(const void*){kernel}; threads = {block}; break;"
                    in src)


def test_a_moved_anchor_of_the_symmetric_all_pairs_walk_raises(copy):
    """Where the checkout has the batched symmetric all-pairs walk's own
    body (sym_batch_walk), its anchors are required; a checkout without it
    (the parent, whose 1b and 4-b run sym_tile_pair) is instrumented
    without them, its tile pair counted alone."""
    path = copy / CSRC / "pair_forces.cu"
    text = path.read_text()
    path.write_text(text.replace(
        "    if (q + 1 < n_cand) stage(tj + n_split, b ^ 1);\n",
        "    if (q < n_cand - 1) stage(tj + n_split, b ^ 1);\n"))
    with pytest.raises(RuntimeError, match="no anchor"):
        bench.instrument(copy)
    start = text.index("template <bool kTri, class Law>\n"
                       "__device__ __forceinline__ void sym_batch_walk(")
    end = text.index("\n}\n", start) + 3
    path.write_text(text[:start] + text[end:])
    bench.instrument(copy)
    src = path.read_text()
    assert src.count("atomicAdd(&sfm_sym_warps[") == 1
    assert ("(const void*)pair_force_sym_batched_kernel<kTriangle, "
            "Moussaid>; threads = kSymTile; break;") in src  # the parent's
