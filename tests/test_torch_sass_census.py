"""The host side of ``tools/sass_census.py``, which ``chip_smoke.py``
phase 2 runs on the card: the layout constants it reads from the port's
CUDA sources, the demangled-name normaliser, and the loop census on a
small hand-written disassembly.  Runs on the CPU (no nvdisasm needed).
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import sass_census  # noqa: E402

#: two trips' worth of a loop: a marker pair (two MUFU.EX2), a shared load,
#: an FMUL on a special-function line, a compare and the backward branch
LISTING = """
\t.section\t.text._Z6kernelv,"ax",@progbits
        /*0000*/                   MOV R1, c[0x0][0x28] ;
.L_x_0:
\t//## File "pair_forces.cuh", line 10
        /*0010*/                   LDS R2, [R3] ;
\t//## File "pair_forces.cuh", line 12
        /*0020*/                   FMUL R4, R2, R2 ;
        /*0030*/                   MUFU.EX2 R5, R4 ;
        /*0040*/                   MUFU.EX2 R6, R4 ;
\t//## File "pair_forces.cu", line 30
        /*0050*/                   ISETP.GE.AND P0, PT, R7, R8, PT ;
        /*0060*/              @!P0 BRA `(.L_x_0) ;
        /*0070*/                   EXIT ;
"""


def test_layout_constants_are_read_from_the_sources():
    """Every layout constant the census names is found in csrc/: R rows
    per thread divides the symmetric block's four warps, L lanes per
    pedestrian divides a warp."""
    got = sass_census.layout_constants(ROOT)
    assert set(got) == {k[5] for k in sass_census.KERNELS}
    assert got["kSymRows"] in (1, 2, 4)
    assert got["kSymRowsCut"] in (1, 2, 4)
    assert 32 % got["kEnvLanes"] == 0


@pytest.mark.parametrize("label, const", [
    ("pair_force_dense<kAllTiles, Moussaid>", "kDenseRows"),
    ("pair_force_dense<kTable, Moussaid>", "kDenseRows"),
    ("pair_force_dense<kAllTiles, Helbing>", "kDenseRows"),
    ("pair_force_dense<kAllTiles, PowerLaw>", "kDenseRows"),
    ("pair_force_dense_batched<kBoxSkip, Moussaid>", "kDenseRows"),
    ("pair_force_dense_batched<kBoxSkip, PowerLaw>", "kDenseRows"),
    ("pair_force_dense_batched<kBoxSkip, Helbing>", "kDenseRows"),
    ("pair_force_dense_batched<kBoxSkipTiles, Moussaid>", "kDenseRows"),
    ("pair_force_dense_batched<kBoxSkipTiles, PowerLaw>", "kDenseRows"),
    ("pair_force_dense_batched<kBoxSkipTiles, Helbing>", "kDenseRows"),
    ("pair_force_dense_batched<kTable, Moussaid>", "kDenseRows"),
    ("pair_force_dense_batched<kTable, PowerLaw>", "kDenseRows"),
    ("pair_force_dense_batched<kTable, Helbing>", "kDenseRows"),
    ("ring_force<false, Moussaid>", "kRingRows")])
def test_dense_walk_and_ring_entries_name_their_rows_per_thread(label,
                                                                 const):
    """The dense walks' and the ring's census entries name the constant of
    their rows per thread, and csrc/ sets it to 1, 2 or 4 (a lane's rows of
    a 128-row table tile).  The ring is a template of its rows per thread
    and of whether its blocks walk several row sets; a launch takes R =
    kRingRows with one row set a block where that grid is resident (the
    main path's 10,000 agents), else with several: its entry counts the
    former."""
    entry = {k[0]: k for k in sass_census.KERNELS}[label]
    rows = sass_census.layout_constants(ROOT)[const]
    assert entry[5] == const
    assert rows in (1, 2, 4)
    if const == "kRingRows":
        assert entry[1].endswith(f", {rows}, false>")
        src = (ROOT / "carla_social_force_model_tpu_torch" / "csrc"
               / "ring.cu").read_text()
        assert "ring_force_kernel<kCutoff, Law, kRingRows, kMulti>" in src
        for multi in ("false", "true"):
            assert f"ring_try<kCutoff, Law, {multi}>" in src


@pytest.mark.parametrize("walk, law", [
    (walk, law) for walk in ("kTriangle", "kTriangleBox", "kSymTable")
    for law in ("Moussaid", "PowerLaw")])
def test_batched_sym_entries_count_their_kernels(walk, law):
    """Each batched symmetric walk (rows 1b and 1c of PERF.md) has its
    census entry: the kernel's instantiation by the walk's enum value,
    two exponentials a Moussaid pair and one a power-law pair, and the
    rows per thread of the body it runs (the triangle walk: sym_batch_walk's
    kSymAllRows, two, so that a warp holds a 64-row group of its tile; the
    cutoff walks: sym_rows_walk's one row a lane), which
    csrc/pair_forces.cu dispatches so."""
    entry = {k[0]: k for k in sass_census.KERNELS}[
        f"pair_force_sym_batched<{walk}, {law}>"]
    value = {"kTriangle": 0, "kTriangleBox": 1, "kSymTable": 2}[walk]
    assert entry[1] == f"pair_force_sym_batched_kernel<{value}, {law}"
    assert entry[2] == ("MUFU.EX2", None, None) and entry[4] == "pair"
    assert entry[3] == (2 if law == "Moussaid" else 1)
    rows = sass_census.layout_constants(ROOT)[entry[5]]
    src = (ROOT / "carla_social_force_model_tpu_torch" / "csrc"
           / "pair_forces.cu").read_text()
    kernel = src[src.index("pair_force_sym_batched_kernel(Planes pl"):]
    kernel = kernel[:kernel.index("\n}\n")]
    if walk == "kTriangle":
        assert entry[5] == "kSymAllRows" and rows == 2
        assert "sym_batch_walk<true, Law>" in kernel
    else:
        assert entry[5] == "kSymBatchRows" and rows == 1
        assert "sym_rows_walk<kWalk, Law>" in kernel


@pytest.mark.parametrize("label, prefix, const, unit", [
    ("chunk_argmin", "chunk_argmin_kernel", "kArgminRows", "pair"),
    ("chunk_topk", "chunk_topk_kernel", "kTopkLanes", "point"),
    ("seg_topk", "seg_topk_kernel<4>", "kSegLanes", "feature pair"),
    ("chunk_closest", "chunk_closest_kernel", "kClosestLanes", "point")])
def test_chunk_scan_entries_name_their_layout(label, prefix, const, unit):
    """The entries of the chunk scan, the chunk top-k, the segment top-k
    and chunk_closest count their own kernels of statics.cu (whose objects
    the census disassembles) per (point, pedestrian) pair, scanned point or
    (segment feature, pedestrian) pair, by the two products of its squared
    distance, with R pedestrians per thread or L lanes per pedestrian read
    from the source."""
    entry = {k[0]: k for k in sass_census.KERNELS}[label]
    assert entry[1] == prefix and entry[4] == unit and entry[5] == const
    assert entry[2] == ("FMUL", "pair_forces.cuh", None) and entry[3] == 2
    assert b"_statics_cu_" in sass_census.SOURCES
    value = sass_census.layout_constants(ROOT)[const]
    if const != "kArgminRows":
        assert const in sass_census.LANE_CONSTANTS and 32 % value == 0
    else:
        assert const not in sass_census.LANE_CONSTANTS
        assert value in (1, 2, 4, 8)


def test_special_lines_cover_every_law():
    """The special-function call sites of all three pair laws are found in
    the sources: Helbing's correctly rounded roots and divisions too."""
    lines = sass_census.special_lines(ROOT)["pair_forces.cuh"]
    src = (ROOT / "carla_social_force_model_tpu_torch" / "csrc"
           / "pair_forces.cuh").read_text().splitlines()
    for func in ("moussaid_pair", "powerlaw_pair", "helbing_pair"):
        start = next(i for i, ln in enumerate(src)
                     if f"{func}(" in ln and not ln.startswith("//"))
        end = next(i for i in range(start, len(src)) if src[i] == "}")
        assert any(start < ln <= end + 1 for ln in lines), func


@pytest.mark.parametrize("demangled, want", [
    ("void (anonymous namespace)::env_force_kernel<(bool)0, "
     "((anonymous namespace)::Walk)1, ((anonymous namespace)::Geom)0>"
     "(const float *)", "env_force_kernel<false, 1, 0>(const float *)"),
    ("void <unnamed>::pair_force_sym_kernel<(int)2, <unnamed>::Moussaid>"
     "(int)", "pair_force_sym_kernel<2, Moussaid>(int)"),
])
def test_normalize(demangled, want):
    assert sass_census.normalize(demangled) == want


def test_loop_census_counts_one_trip_per_marker_pair():
    funcs = sass_census.parse(LISTING)
    insts = funcs["_Z6kernelv"]
    assert insts[-2]["target"] == 0x10
    got = sass_census.loop_census(insts, ("MUFU.EX2", None, None), 2,
                                  {"pair_forces.cuh": {12}})
    assert got["loop_instructions"] == 6
    assert got["units_per_trip"] == 1
    assert got["groups_per_unit"] == {"law": 0, "special": 3, "memory": 1,
                                      "control": 2}
    assert got["mufu_per_unit"] == 2
    assert got["local_per_unit"] == 0


def test_loop_census_counts_spills_as_local_memory():
    """A loop's local-memory loads and stores (spills) are counted apart
    in ``local_per_unit``, and in the loop's instructions a unit."""
    spilled = LISTING.replace(
        "        /*0020*/                   FMUL R4, R2, R2 ;\n",
        "        /*0018*/                   STL [R1], R2 ;\n"
        "        /*0020*/                   FMUL R4, R2, R2 ;\n"
        "        /*0028*/                   LDL R2, [R1] ;\n")
    insts = sass_census.parse(spilled)["_Z6kernelv"]
    got = sass_census.loop_census(insts, ("MUFU.EX2", None, None), 2,
                                  {"pair_forces.cuh": {12}})
    assert got["loop_instructions"] == 8
    assert got["local_per_unit"] == 2
    assert sum(got["groups_per_unit"].values()) == 8


def test_ptxas_report_reads_registers_and_spills(monkeypatch):
    """``--ptxas`` reads each counted kernel's registers, stack and spill
    bytes from nvcc's ``-Xptxas -v`` log and leaves other functions out."""
    log = ("ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z1av\n"
           "    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill "
           "loads\n"
           "ptxas info    : Used 64 registers, used 1 barriers, 480 bytes "
           "cmem[0]\n"
           "ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'\n"
           "ptxas info    : Used 30 registers\n")
    names = {"_Z1av": "void (anonymous namespace)::"
             "pair_force_dense_batched_kernel<(int)0, (anonymous namespace)"
             "::Moussaid>(Planes)", "_Z1bv": "void other_kernel()"}
    monkeypatch.setattr(sass_census, "demangle",
                        lambda got: {n: names[n] for n in got})
    assert sass_census.ptxas_report(log) == {
        "pair_force_dense_batched_kernel<0, Moussaid>": {
            "stack_bytes": 8, "spill_store_bytes": 8,
            "spill_load_bytes": 12, "registers": 64}}


#: a scan loop: four FMNMX of one distance whose two products sit on
#: sq_norm_rn's line, one shared load, and a forward branch out of the loop
ARGMIN_LISTING = """
\t.section\t.text._Z6argminv,"ax",@progbits
.L_x_3:
\t//## File "statics.cu", line 40
        /*0000*/                   LDS.128 R2, [R3] ;
\t//## File "pair_forces.cuh", line 51
        /*0010*/                   FMUL R4, R2, R2 ;
        /*0020*/                   FMUL R5, R3, R3 ;
        /*0030*/                   FADD R6, R4, R5 ;
\t//## File "statics.cu", line 44
        /*0040*/                   FMNMX R7, R7, R6, PT ;
        /*0050*/                   FMNMX R8, R8, R6, PT ;
        /*0060*/                   FMNMX R9, R9, R6, PT ;
        /*0070*/                   FMNMX R10, R10, R6, PT ;
        /*0080*/                   FSETP.GEU.AND P1, PT, R7, R11, PT ;
        /*0090*/               @!P1 BRA `(.L_x_4) ;
        /*00a0*/                   ISETP.GE.AND P0, PT, R12, R13, PT ;
        /*00b0*/               @!P0 BRA `(.L_x_3) ;
.L_x_4:
        /*00c0*/                   EXIT ;
"""


@pytest.mark.parametrize("marker, per_unit, units, memory", [
    (("FMNMX", None, None), 1, 4, 0.25),
    (("FMUL", "pair_forces.cuh", None), 2, 1, 1.0)])
def test_loop_census_counts_chunk_scan_pairs(marker, per_unit, units,
                                             memory):
    """A marker of one instruction a unit (FMNMX) and one of two (the
    FMULs of sq_norm_rn, on their source file only) count the same loop,
    whose forward branch is not a loop of its own."""
    insts = sass_census.parse(ARGMIN_LISTING)["_Z6argminv"]
    got = sass_census.loop_census(insts, marker, per_unit, {})
    assert got["loop_instructions"] == 12
    assert got["units_per_trip"] == units
    assert got["per_unit"] == 12 / units
    assert got["groups_per_unit"]["memory"] == memory


def test_floor_ms():
    """One unit of one instruction per lane of every scheduler for one
    clock is the issue rate."""
    assert sass_census.floor_ms(1.0, sass_census.ISSUE_RATE) == 1e3


def test_compare_ignores_label_numbers_and_source_lines(tmp_path):
    """Two dumps of the same kernels (``--out``) whose label numbers,
    source lines, anonymous-namespace hashes and helper numbers moved
    compare identical; a changed instruction and a kernel only one dump
    holds are reported."""
    listing = LISTING.replace(
        "MOV R1, c[0x0][0x28] ;",
        "MOV R1, 32@lo(_ZN47_GLOBAL__N__f83b1a7e_14_pair_forces_cu_"
        "5b0bf1653smE) ;\n        /*0008*/          BSSY B0, `(.L_x_0) ;"
        "\n        /*000c*/          CALL.REL.NOINC `($__internal_1_$__"
        "cuda_sm20_div_u16) ;")
    other = listing.replace(".L_x_0", ".L_x_7").replace(
        "internal_1_", "internal_2_").replace(
        "line 30", "line 95").replace("f83b1a7e", "0c9d2e11").replace(
        "5b0bf165", "77aa0f13")
    changed = ARGMIN_LISTING.replace("FMNMX R10", "FMNMX R11")
    for name, text in (("a", listing + ARGMIN_LISTING),
                       ("b", other + changed)):
        d = tmp_path / name
        d.mkdir()
        (d / "all_0.sass").write_text(text)
        (d / "names.txt").write_text("_Z6kernelv\tvoid kernel()\n"
                                     "_Z6argminv\tvoid argmin()\n")
    (tmp_path / "b" / "all_1.sass").write_text(
        LISTING.replace("_Z6kernelv", "_Z5extrav"))
    got = sass_census.compare(tmp_path / "a", tmp_path / "b")
    assert got["common"] == 2 and got["identical"] == 1
    assert got["different"] == ["argmin()"]
    assert got["first_difference"]["argmin()"][0] == 7
    assert got["only_b"] == ["_Z5extrav"] and got["only_a"] == []


@pytest.mark.parametrize("law", ["Moussaid", "PowerLaw", "Helbing"])
@pytest.mark.parametrize("cut", ["false", "true"])
@pytest.mark.parametrize("form", ["change", "parent"])
def test_batched_ring_entries_count_their_kernels(law, cut, form):
    """The batched ring (row 6-b of PERF.md) has a census entry under each
    law, with and without the cutoff, for its own body (ring_batch_walk:
    ring_force_batched_kernel<kCutoff, Law, kMulti>, one row a lane,
    kRingBatchRows) and for the parent's (ring_walk:
    ring_force_batched_kernel<kCutoff, Law, R, kMulti>, kRingRows): the
    crowd-by-crowd form a launch takes on the main path, two exponentials a
    Moussaid pair and one a power-law or Helbing pair.  The two prefixes
    never match each other's kernels, so each checkout's census finds its
    own form only."""
    entries = {k[0]: k for k in sass_census.KERNELS}
    label = f"ring_force_batched<{cut}, {law}>"
    entry = entries[label if form == "change" else label + " (parent)"]
    other = entries[label + " (parent)" if form == "change" else label]
    assert entry[2] == ("MUFU.EX2", None, None) and entry[4] == "pair"
    assert entry[3] == (2 if law == "Moussaid" else 1)
    if form == "change":
        assert entry[1] == f"ring_force_batched_kernel<{cut}, {law}, false"
        assert entry[5] == "kRingBatchRows"
    else:
        assert entry[1] == f"ring_force_batched_kernel<{cut}, {law}, 1, false"
        assert entry[5] == "kRingRows"
    for name in (f"ring_force_batched_kernel<{cut}, {law}, false>",
                 f"ring_force_batched_kernel<{cut}, {law}, 1, false>"):
        assert name.startswith(entry[1]) != name.startswith(other[1])
    assert sass_census.layout_constants(ROOT)[entry[5]] == 1
    src = (ROOT / "carla_social_force_model_tpu_torch" / "csrc"
           / "ring.cu").read_text()
    kernel = src[src.index("ring_force_batched_kernel(RingBatchArgs ab)"):]
    assert "ring_batch_walk<kCutoff, Law, kMulti>" in kernel[:200]
    assert "RowSet<kRingBatchRows> rw;" in src


@pytest.mark.parametrize("law", ["Moussaid", "PowerLaw", "Helbing"])
def test_batched_all_tiles_entries(law):
    """2b and 2r-b, the batched all-tiles walk (the ring's pairs without a
    ring, and the walk that kernel_redesign_bench times beside the batched
    ring), has its census entry under each law: the kAllTiles instantiation
    (0) of pair_force_dense_batched_kernel, which runs its own body
    (dense_batch_walk), one row a lane (kDenseBatchRows)."""
    entry = {k[0]: k for k in sass_census.KERNELS}[
        f"pair_force_dense_batched<kAllTiles, {law}>"]
    assert entry[1] == f"pair_force_dense_batched_kernel<0, {law}"
    assert entry[3] == (2 if law == "Moussaid" else 1)
    assert entry[5] == "kDenseBatchRows"
    assert sass_census.layout_constants(ROOT)[entry[5]] == 1
    src = (ROOT / "carla_social_force_model_tpu_torch" / "csrc"
           / "pair_forces.cu").read_text()
    kernel = src[src.index("pair_force_dense_batched_kernel(Planes rows"):]
    kernel = kernel[:kernel.index("\n}\n")]
    assert "dense_batch_walk<Law>(" in kernel
    assert "RowSet<kDenseBatchRows> rw;" in src


def test_census_leaves_out_an_older_form_it_does_not_find(tmp_path,
                                                          monkeypatch):
    """``census`` on a library that holds the batched ring's own body only
    (a stubbed cuobjdump, nvdisasm and demangler over LISTING): that
    entry gets its loop, the parent's form (an OLDER_FORM entry) is left
    out, and an entry of the current checkout whose kernel is missing
    reads None, which chip_smoke.py's phase 2 refuses."""
    import subprocess

    lib = tmp_path / "libsfm_kernels.so"
    lib.write_bytes(b"")
    kernel = ("void (anonymous namespace)::ring_force_batched_kernel<(bool)0, "
              "(anonymous namespace)::Moussaid, (bool)0>(RingBatchArgs)")

    def run(cmd, cwd=None, **kw):  # cuobjdump -xelf: one cubin of ring.cu
        (Path(cwd) / "ring.cubin").write_bytes(b"x_ring_cu_x")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    class Disasm:
        returncode = 0

        def __init__(self, *a, **kw):
            pass

        def communicate(self):
            return LISTING, ""

    monkeypatch.setattr(sass_census, "tool", lambda name: name)
    monkeypatch.setattr(sass_census.subprocess, "run", run)
    monkeypatch.setattr(sass_census.subprocess, "Popen", Disasm)
    monkeypatch.setattr(sass_census, "demangle",
                        lambda names: {n: kernel for n in names})
    got = sass_census.census(lib, root=ROOT)
    mine = got["ring_force_batched<false, Moussaid>"]
    assert mine is not None and mine["per_unit"] == 6
    older = [k[0] for k in sass_census.KERNELS
             if k[0].endswith(sass_census.OLDER_FORM)]
    assert len(older) == 6 and not any(k in got for k in older)
    assert got["pair_force_sym<kTriangle, Moussaid>"] is None


@pytest.mark.parametrize("law", ["Moussaid", "PowerLaw"])
@pytest.mark.parametrize("box", ["false", "true"])
def test_batched_full_block_entries(law, box):
    """4-b, the batched full-block walk of the half-ring, has its census
    entry under each antisymmetric law and form: the kernel's
    instantiation by its box flag, two exponentials a Moussaid pair and
    one a power-law pair, and the rows a lane of the body it runs (without
    the box test sym_batch_walk's kSymAllRows; with it the unbatched tile
    pair's kSymRowsCut), which csrc/pair_forces.cu dispatches so."""
    entry = {k[0]: k for k in sass_census.KERNELS}[
        f"pair_force_sym_dense_batched<{box}, {law}>"]
    assert entry[1] == f"pair_force_sym_dense_batched_kernel<{box}, {law}"
    assert entry[2] == ("MUFU.EX2", None, None) and entry[4] == "pair"
    assert entry[3] == (2 if law == "Moussaid" else 1)
    src = (ROOT / "carla_social_force_model_tpu_torch" / "csrc"
           / "pair_forces.cu").read_text()
    kernel = src[src.index("pair_force_sym_dense_batched_kernel(Planes rows"):]
    kernel = kernel[:kernel.index("\n}\n")]
    rows = sass_census.layout_constants(ROOT)[entry[5]]
    if box == "true":
        assert entry[5] == "kSymRowsCut" and rows in (1, 2, 4)
        assert "sym_tile_pair<kSymRowsCut, false, true, Law>" in kernel
    else:
        assert entry[5] == "kSymAllRows" and rows == 2
        assert "sym_batch_walk<false, Law>" in kernel
