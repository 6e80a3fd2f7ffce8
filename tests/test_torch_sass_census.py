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
    ("ring_force<false, Moussaid>", "kRingRows")])
def test_dense_walk_and_ring_entries_name_their_rows_per_thread(label,
                                                                 const):
    """The dense walks' and the ring's census entries name the constant of
    their rows per thread, and csrc/ sets it to 1, 2 or 4 (a lane's rows of
    a 128-row table tile).  The ring is a template of its rows per thread
    (a launch takes R = kRingRows, 2 kRingRows or 4 kRingRows, the least
    that fits): its entry counts the R = kRingRows instantiation, the one
    the main path's 10,000 agents take."""
    entry = {k[0]: k for k in sass_census.KERNELS}[label]
    rows = sass_census.layout_constants(ROOT)[const]
    assert entry[5] == const
    assert rows in (1, 2, 4)
    if const == "kRingRows":
        assert entry[1].endswith(f", {rows}>")
        src = (ROOT / "carla_social_force_model_tpu_torch" / "csrc"
               / "ring.cu").read_text()
        for r in ("kRingRows", "2 * kRingRows", "4 * kRingRows"):
            assert f"ring_try<kCutoff, Law, {r}>" in src


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


def test_floor_ms():
    """One unit of one instruction per lane of every scheduler for one
    clock is the issue rate."""
    assert sass_census.floor_ms(1.0, sass_census.ISSUE_RATE) == 1e3
