#!/usr/bin/env python3
"""SASS census of the inner loops of the port's pair, ring, environment and
chunk-scan kernels, and the issue-rate floor it gives.

Builds the kernel library (``utils/cuda_build.py``, compiled with
``-lineinfo``), extracts its cubin with ``cuobjdump -xelf``, disassembles
it with ``nvdisasm -g`` (each instruction with its source line) and, for
each kernel of ``KERNELS``, finds the innermost loop (a backward branch)
that holds the kernel's per-unit marker: the two ``expf`` of a Moussaid
pair (``MUFU.EX2``), the one ``expf`` of a power-law or Helbing pair, the two
products of the squared distance of a scanned point, of a (point,
pedestrian) pair of the chunk scan or of a (segment feature, pedestrian)
pair of the segment top-k (``sq_norm_rn``).  The
loop's instructions over the units one trip covers give the instructions
per pair (or per scanned point), split into four groups:

* ``law``: the law's f32 arithmetic;
* ``special``: every ``MUFU`` and every instruction whose source line is a
  special-function call site (``atan2f``, the division, ``expf``,
  ``rsqrtf``, ``__expf``; ``SPECIAL_LINES``);
* ``memory``: shared and global loads and stores, shuffles, votes and
  warp or block barriers;
* ``control``: compares, selects, predicates, integer index and loop
  arithmetic, branches.

The issue-rate floor is instructions x units / (132 SMs x 4 schedulers x
32 lanes x clock): one warp instruction per scheduler per clock, at the
1,980 MHz SM clock of an H100 SXM.

Run on a machine with the CUDA toolkit (nvcc, cuobjdump, nvdisasm,
cu++filt under /usr/local/cuda/bin):

    python3 tools/sass_census.py [--out DIR] [--ptxas]

It prints one JSON object per kernel (with ``local_per_unit``, the loop's
local-memory loads and stores a unit: its spills); with ``--out`` it also
writes each loop's disassembly there, and with ``--ptxas`` it prints
ptxas's registers and spill bytes of each counted kernel from the build's
log.  ``chip_smoke.py`` phase 2 imports
:func:`census` for the same numbers.

    python3 tools/sass_census.py --compare DIR_A DIR_B

compares two such dumps (say a parent checkout's and a change's, each
written with ``--out``) kernel by kernel and prints one JSON object: the
kernels both hold, how many of them have the same instructions (branch
targets as addresses, source lines ignored) and which do not.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SMS, SCHEDULERS, LANES, CLOCK_HZ = 132, 4, 32, 1.98e9
#: thread instructions the card issues per second at most
ISSUE_RATE = SMS * SCHEDULERS * LANES * CLOCK_HZ

#: (label, demangled-name prefix after normalize(), marker, markers per
#: unit, unit, layout constant): the marker is (opcode prefix, source file
#: suffix or None, source line or None); a trip of the loop covers (marker
#: count / markers per unit) units; the layout constant of csrc/ is the
#: kernel's rows per thread (R) or lanes per pedestrian (L)
KERNELS = (
    ("pair_force_sym<kTriangle, Moussaid>",
     "pair_force_sym_kernel<0, Moussaid", ("MUFU.EX2", None, None), 2,
     "pair", "kSymRows"),
    ("pair_force_sym<kTriangleBox, Moussaid>",
     "pair_force_sym_kernel<1, Moussaid", ("MUFU.EX2", None, None), 2,
     "pair", "kSymRowsCut"),
    ("pair_force_sym<kSymTable, Moussaid>",
     "pair_force_sym_kernel<2, Moussaid", ("MUFU.EX2", None, None), 2,
     "pair", "kSymRowsCut"),
    ("pair_force_sym<kTriangle, PowerLaw>",
     "pair_force_sym_kernel<0, PowerLaw", ("MUFU.EX2", None, None), 1,
     "pair", "kSymRows"),
    ("pair_force_sym<kTriangleBox, PowerLaw>",
     "pair_force_sym_kernel<1, PowerLaw", ("MUFU.EX2", None, None), 1,
     "pair", "kSymRowsCut"),
    ("pair_force_sym<kSymTable, PowerLaw>",
     "pair_force_sym_kernel<2, PowerLaw", ("MUFU.EX2", None, None), 1,
     "pair", "kSymRowsCut"),
    ("pair_force_sym_dense<false, Moussaid>",
     "pair_force_sym_dense_kernel<false, Moussaid", ("MUFU.EX2", None, None),
     2, "pair", "kSymRows"),
    ("pair_force_sym_dense<true, Moussaid>",
     "pair_force_sym_dense_kernel<true, Moussaid", ("MUFU.EX2", None, None),
     2, "pair", "kSymRowsCut"),
    ("pair_force_dense<kAllTiles, Moussaid>",
     "pair_force_dense_kernel<0, Moussaid", ("MUFU.EX2", None, None), 2,
     "pair", "kDenseRows"),
    ("pair_force_dense<kTable, Moussaid>",
     "pair_force_dense_kernel<2, Moussaid", ("MUFU.EX2", None, None), 2,
     "pair", "kDenseRows"),
    ("pair_force_dense<kAllTiles, Helbing>",
     "pair_force_dense_kernel<0, Helbing", ("MUFU.EX2", None, None), 1,
     "pair", "kDenseRows"),
    ("pair_force_dense<kAllTiles, PowerLaw>",
     "pair_force_dense_kernel<0, PowerLaw", ("MUFU.EX2", None, None), 1,
     "pair", "kDenseRows"),
    # the batched walks of the ensembles and the 2-D mesh (rows 2c, 2r-b,
    # 3b and 3r-b of PERF.md): the box-skip and table walks (chunk_walk)
    # and the box-skip walk by tile (dense_walk, few columns:
    # box_skip_walk) under each law
    ("pair_force_dense_batched<kBoxSkip, Moussaid>",
     "pair_force_dense_batched_kernel<1, Moussaid", ("MUFU.EX2", None, None),
     2, "pair", "kDenseRows"),
    ("pair_force_dense_batched<kBoxSkip, PowerLaw>",
     "pair_force_dense_batched_kernel<1, PowerLaw", ("MUFU.EX2", None, None),
     1, "pair", "kDenseRows"),
    ("pair_force_dense_batched<kBoxSkip, Helbing>",
     "pair_force_dense_batched_kernel<1, Helbing", ("MUFU.EX2", None, None),
     1, "pair", "kDenseRows"),
    ("pair_force_dense_batched<kBoxSkipTiles, Moussaid>",
     "pair_force_dense_batched_kernel<3, Moussaid", ("MUFU.EX2", None, None),
     2, "pair", "kDenseRows"),
    ("pair_force_dense_batched<kBoxSkipTiles, PowerLaw>",
     "pair_force_dense_batched_kernel<3, PowerLaw", ("MUFU.EX2", None, None),
     1, "pair", "kDenseRows"),
    ("pair_force_dense_batched<kBoxSkipTiles, Helbing>",
     "pair_force_dense_batched_kernel<3, Helbing", ("MUFU.EX2", None, None),
     1, "pair", "kDenseRows"),
    ("pair_force_dense_batched<kTable, Moussaid>",
     "pair_force_dense_batched_kernel<2, Moussaid", ("MUFU.EX2", None, None),
     2, "pair", "kDenseRows"),
    ("pair_force_dense_batched<kTable, PowerLaw>",
     "pair_force_dense_batched_kernel<2, PowerLaw", ("MUFU.EX2", None, None),
     1, "pair", "kDenseRows"),
    ("pair_force_dense_batched<kTable, Helbing>",
     "pair_force_dense_batched_kernel<2, Helbing", ("MUFU.EX2", None, None),
     1, "pair", "kDenseRows"),
    # the batched symmetric walks (rows 1b and 1c of PERF.md): the
    # triangle walk (sym_batch_walk, R = 2 rows a lane; its loop off the
    # diagonal, R pairs a step) and the triangle-box and table walks
    # (sym_rows_walk) under each antisymmetric law
    ("pair_force_sym_batched<kTriangle, Moussaid>",
     "pair_force_sym_batched_kernel<0, Moussaid", ("MUFU.EX2", None, None),
     2, "pair", "kSymAllRows"),
    ("pair_force_sym_batched<kTriangleBox, Moussaid>",
     "pair_force_sym_batched_kernel<1, Moussaid", ("MUFU.EX2", None, None),
     2, "pair", "kSymBatchRows"),
    ("pair_force_sym_batched<kSymTable, Moussaid>",
     "pair_force_sym_batched_kernel<2, Moussaid", ("MUFU.EX2", None, None),
     2, "pair", "kSymBatchRows"),
    ("pair_force_sym_batched<kTriangle, PowerLaw>",
     "pair_force_sym_batched_kernel<0, PowerLaw", ("MUFU.EX2", None, None),
     1, "pair", "kSymAllRows"),
    ("pair_force_sym_batched<kTriangleBox, PowerLaw>",
     "pair_force_sym_batched_kernel<1, PowerLaw", ("MUFU.EX2", None, None),
     1, "pair", "kSymBatchRows"),
    ("pair_force_sym_batched<kSymTable, PowerLaw>",
     "pair_force_sym_batched_kernel<2, PowerLaw", ("MUFU.EX2", None, None),
     1, "pair", "kSymBatchRows"),
    # the batched full-block walk (row 4-b of PERF.md: the half-ring's
    # blocks on the 2-D mesh) under each antisymmetric law: without the
    # box test sym_batch_walk, with it the unbatched tile pair
    # (sym_tile_pair, kSymRowsCut rows a lane)
    *((f"pair_force_sym_dense_batched<{box}, {law}>",
       f"pair_force_sym_dense_batched_kernel<{box}, {law}",
       ("MUFU.EX2", None, None), 2 if law == "Moussaid" else 1, "pair",
       "kSymRowsCut" if box == "true" else "kSymAllRows")
      for law in ("Moussaid", "PowerLaw") for box in ("false", "true")),
    ("ring_force<false, Moussaid>",
     "ring_force_kernel<false, Moussaid, 1, false>", ("MUFU.EX2", None, None),
     2,
     "pair", "kRingRows"),
    # the batched ring (row 6-b of PERF.md) under each law, with and without
    # the cutoff: its own body (ring_batch_walk, one crowd's group a block:
    # the main path's form) and the parent's (ring_walk, R = 1, a checkout
    # from before it); each checkout holds one of the two, and an older
    # form's entry (OLDER_FORM) is left out where its kernel is absent
    *((f"ring_force_batched<{cut}, {law}>",
       f"ring_force_batched_kernel<{cut}, {law}, false",
       ("MUFU.EX2", None, None), 2 if law == "Moussaid" else 1, "pair",
       "kRingBatchRows")
      for law in ("Moussaid", "PowerLaw", "Helbing")
      for cut in ("false", "true")),
    *((f"ring_force_batched<{cut}, {law}> (parent)",
       f"ring_force_batched_kernel<{cut}, {law}, 1, false",
       ("MUFU.EX2", None, None), 2 if law == "Moussaid" else 1, "pair",
       "kRingRows")
      for law in ("Moussaid", "PowerLaw", "Helbing")
      for cut in ("false", "true")),
    # the batched all-tiles walk (rows 2b and 2r-b: its own body,
    # dense_batch_walk, one row a lane; a checkout from before it runs
    # dense_walk there)
    *((f"pair_force_dense_batched<kAllTiles, {law}>",
       f"pair_force_dense_batched_kernel<0, {law}",
       ("MUFU.EX2", None, None), 2 if law == "Moussaid" else 1, "pair",
       "kDenseBatchRows")
      for law in ("Moussaid", "PowerLaw", "Helbing")),
    ("env_force<exp, kAllSections, kSampled>",
     "env_force_kernel<false, 0, 0", ("FMUL", "pair_forces.cuh", None), 2,
     "point", "kEnvLanes"),
    ("env_force<moussaid, kAllSections, kSampled>",
     "env_force_kernel<true, 0, 0", ("FMUL", "pair_forces.cuh", None), 2,
     "point", "kEnvLanes"),
    ("env_force<exp, kAllSections, kAnalytic>",
     "env_force_kernel<false, 0, 1", ("FMUL", "pair_forces.cuh", None), 2,
     "segment", "kEnvLanes"),
    ("env_force<exp, kTable, kSampled>",
     "env_force_kernel<false, 1, 0", ("FMUL", "pair_forces.cuh", None), 2,
     "point", "kEnvLanes"),
    ("env_force<moussaid, kTable, kSampled>",
     "env_force_kernel<true, 1, 0", ("FMUL", "pair_forces.cuh", None), 2,
     "point", "kEnvLanes"),
    ("env_force<exp, kTable, kAnalytic>",
     "env_force_kernel<false, 1, 1", ("FMUL", "pair_forces.cuh", None), 2,
     "segment", "kEnvLanes"),
    ("chunk_argmin", "chunk_argmin_kernel", ("FMUL", "pair_forces.cuh", None),
     2, "pair", "kArgminRows"),
    ("chunk_topk", "chunk_topk_kernel", ("FMUL", "pair_forces.cuh", None), 2,
     "point", "kTopkLanes"),
    ("seg_topk", "seg_topk_kernel<4>", ("FMUL", "pair_forces.cuh", None), 2,
     "feature pair", "kSegLanes"),
    ("chunk_closest", "chunk_closest_kernel",
     ("FMUL", "pair_forces.cuh", None), 2, "point", "kClosestLanes"),
)

#: the label suffix of an entry that counts a form only checkouts from
#: before a redesign hold: :func:`census` leaves it out where no kernel
#: matches (an entry without it reads None then)
OLDER_FORM = " (parent)"

#: the layout constants that count lanes per pedestrian (the rest count
#: rows, or pedestrians, per thread)
LANE_CONSTANTS = ("kEnvLanes", "kTopkLanes", "kSegLanes", "kClosestLanes")

#: the special-function call sites: (file suffix, function whose body
#: holds them).  Their lines are looked up in the source, so that they
#: follow edits: every line of that function which calls one of
#: SPECIAL_CALLS counts.
SPECIAL_SOURCES = (("pair_forces.cuh", "sfm_exp"),
                   ("pair_forces.cuh", "moussaid_pair"),
                   ("pair_forces.cuh", "powerlaw_pair"),
                   ("pair_forces.cuh", "helbing_pair"),
                   ("env_forces.cuh", "exp_term"))
SPECIAL_CALLS = re.compile(
    r"atan2f|expf|__expf|sfm_exp|SFM_RSQRT|rsqrtf|SFM_DIV_RN|__fdividef|"
    r"(?<![A-Za-z_])-?\s*d\s*/|/\s*\(|SFM_SQRT_RN")

#: the mangled-name tags of the sources whose kernels KERNELS lists
SOURCES = (b"_pair_forces_cu_", b"_env_forces_cu_", b"_ring_cu_",
           b"_statics_cu_")

#: local-memory loads and stores: the spills of a loop
LOCAL_OPS = ("LDL", "STL")
MEMORY_OPS = (*LOCAL_OPS, "LDS", "STS", "LDG", "STG", "LD.", "ST.", "LDC",
              "ATOM",
              "RED", "SHFL", "VOTE", "WARPSYNC", "BAR", "MEMBAR",
              "SYNCS", "ULDC", "LDSM")
CONTROL_OPS = ("ISETP", "FSETP", "DSETP", "PLOP3", "PSETP", "SEL", "FSEL",
               "BRA", "BRX", "JMP", "CALL", "RET", "EXIT", "BSSY", "BSYNC",
               "IADD", "IMAD", "IMUL", "LEA", "LOP", "SHF", "SHL", "SHR",
               "MOV", "UMOV", "UIADD", "ULOP", "USHF", "ULEA", "UISETP",
               "USEL", "S2R", "S2UR", "CS2R", "P2R", "R2P", "I2F", "F2I",
               "IABS", "IMNMX", "POPC", "FLO", "BREV", "PRMT", "NOP",
               "YIELD", "ISCADD", "VIMNMX", "R2UR", "UPRMT", "FCHK",
               "PLOP", "ULDC", "BMSK", "SGXT", "WARPGROUP")


def normalize(name: str) -> str:
    """A demangled kernel name without its return type, namespaces or
    casts: ``env_force_kernel<false, 0, 0>(...)``."""
    name = re.sub(r"^void\s+", "", name)
    name = name.replace("(anonymous namespace)::", "").replace(
        "<unnamed>::", "")
    name = name.replace("(bool)0", "false").replace("(bool)1", "true")
    name = re.sub(r"\((?:[A-Za-z_]\w*::)*[A-Za-z_]\w*\)(?=-?\d)", "", name)
    return name


def special_lines(root: Path = ROOT) -> dict[str, set[int]]:
    """{file name: source lines that call a special function} from
    SPECIAL_SOURCES, in the checkout at ``root``."""
    out: dict[str, set[int]] = {}
    csrc = root / "carla_social_force_model_tpu_torch" / "csrc"
    for fname, func in SPECIAL_SOURCES:
        lines = (csrc / fname).read_text().splitlines()
        start = next((i for i, ln in enumerate(lines)
                      if re.search(rf"\b{func}\s*\(", ln)
                      and not ln.strip().startswith("//")), None)
        if start is None:   # an older checkout without this function
            continue
        depth, seen = 0, False
        for i in range(start, len(lines)):
            code = lines[i].split("//")[0]
            if seen and SPECIAL_CALLS.search(code):
                out.setdefault(fname, set()).add(i + 1)
            depth += code.count("{") - code.count("}")
            seen = seen or "{" in code
            if seen and depth == 0:
                break
    return out


def layout_constants(root: Path = ROOT) -> dict[str, int]:
    """{name: value} of the layout constants KERNELS names, read from the
    ``constexpr int`` lines of csrc/ in the checkout at ``root``."""
    wanted = {k[5] for k in KERNELS}
    out: dict[str, int] = {}
    for src in sorted((root / "carla_social_force_model_tpu_torch"
                       / "csrc").glob("*.cu")):
        for name, value in re.findall(r"constexpr int (\w+) = (\d+);",
                                      src.read_text()):
            if name in wanted:
                out[name] = int(value)
    return out


def box_skip_walk(n_cols: int, root: Path = ROOT) -> str:
    """The walk of a batched box-skip launch over ``n_cols`` columns in the
    checkout at ``root`` (``box_skip_batched_launch`` of
    csrc/pair_forces.cu), as its census labels name it: ``kBoxSkipTiles``
    (``dense_walk``) up to ``kBoxSkipTileWalk`` 256-column tiles,
    ``kBoxSkip`` above, and where the checkout has no such constant (its
    box-skip kernel is its one walk)."""
    src = (root / "carla_social_force_model_tpu_torch" / "csrc"
           / "pair_forces.cu").read_text()
    m = re.search(r"constexpr int kBoxSkipTileWalk = (\d+);", src)
    return ("kBoxSkipTiles" if m and -(-n_cols // 256) <= int(m.group(1))
            else "kBoxSkip")


def tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / name).is_file():
            return str(Path(root) / "bin" / name)
    raise RuntimeError(f"{name} not found (PATH, $CUDA_HOME, /usr/local/cuda)")


def demangle(names: list[str]) -> dict[str, str]:
    for prog in ("cu++filt", "c++filt"):
        try:
            path = tool(prog)
        except RuntimeError:
            continue
        out = subprocess.run([path], input="\n".join(names),
                             capture_output=True, text=True, check=True)
        return dict(zip(names, out.stdout.splitlines()))
    raise RuntimeError("no demangler (cu++filt, c++filt)")


INST = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
LINE = re.compile(r'//## File "([^"]*)", line (\d+)')
FUNC = re.compile(r"^\s*\.section\s+\.text\.([^,\s]+)")
TARGET = re.compile(r"\b(?:BRA|BRX)\b[^;]*?(?:0x|`\(\.L_x_)([0-9a-fA-F]+)")
LABEL = re.compile(r"^\s*\.L_x_(\d+):")
ANON = re.compile(r"\d*_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+")
INTERNAL = re.compile(r"\$__internal_\d+_\$")


def parse(text: str) -> dict[str, list[dict]]:
    """{mangled kernel name: [instruction dicts (addr, text, op, file,
    line)]} from the output of ``nvdisasm -g``; branch targets resolved to
    addresses."""
    funcs: dict[str, list[dict]] = {}
    labels: dict[str, dict[str, int]] = {}
    cur, where, pending = None, (None, None), []
    for raw in text.splitlines():
        m = FUNC.match(raw)
        if m:
            cur = m.group(1)
            funcs.setdefault(cur, [])
            labels.setdefault(cur, {})
            where = (None, None)
            continue
        if cur is None:
            continue
        m = LINE.search(raw)
        if m:
            where = (os.path.basename(m.group(1)), int(m.group(2)))
            continue
        m = LABEL.match(raw)
        if m:
            pending.append(m.group(1))
            continue
        m = INST.search(raw)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[cur][lab] = addr
            pending = []
            body = m.group(2).strip()
            op = re.sub(r"^@!?U?P[T0-9]+\s+", "", body).split()[0]
            funcs[cur].append(dict(addr=addr, text=body, op=op,
                                   file=where[0], line=where[1]))
    for name, insts in funcs.items():
        for ins in insts:
            # the text another build of the same code gives: labels (numbered
            # over the whole file) as addresses, anonymous namespaces
            # (named after the source's path) and the compiler's numbered
            # helper functions each as one name
            ins["norm"] = INTERNAL.sub("$__internal_$", ANON.sub(
                "_GLOBAL__N_", re.sub(
                r"`\(\.L_x_(\d+)\)",
                lambda m, lab=labels[name]: (f"0x{lab[m.group(1)]:x}"
                                             if m.group(1) in lab
                                             else m.group(0)),
                ins["text"])))
            if not ins["op"].startswith(("BRA", "BRX")):
                continue
            m = re.search(r"`\(\.L_x_(\d+)\)", ins["text"])
            if m and m.group(1) in labels[name]:
                ins["target"] = labels[name][m.group(1)]
                continue
            m = re.search(r"\b0x([0-9a-f]+)\b", ins["text"])
            if m:
                ins["target"] = int(m.group(1), 16)
    return funcs


def group_of(ins: dict, special: dict[str, set[int]]) -> str:
    op = ins["op"]
    if op.startswith("MUFU") or ins["line"] in special.get(ins["file"], ()):
        return "special"
    if op.startswith(MEMORY_OPS):
        return "memory"
    if op.startswith(CONTROL_OPS):
        return "control"
    return "law"


def loop_census(insts: list[dict], marker, per_unit: int,
                special: dict[str, set[int]]) -> dict | None:
    """The innermost loop holding the marker: its instructions per unit,
    by group."""
    m_op, m_file, m_line = marker

    def is_marker(ins):
        return (ins["op"].startswith(m_op)
                and (m_file is None or ins["file"] == m_file)
                and (m_line is None or ins["line"] == m_line))

    loops = []
    for i, ins in enumerate(insts):
        tgt = ins.get("target")
        if tgt is None or tgt > ins["addr"]:
            continue
        lo = next((j for j, x in enumerate(insts) if x["addr"] >= tgt), None)
        if lo is None:
            continue
        marks = sum(is_marker(x) for x in insts[lo:i + 1])
        if marks >= per_unit:
            loops.append((lo, i, marks))
    # innermost loops (no other marked loop inside), then the one whose
    # trip covers the most units: the unrolled body, not its remainder
    inner = [a for a in loops
             if not any(b != a and b[0] >= a[0] and b[1] <= a[1]
                        for b in loops)]
    if not inner:
        return None
    lo, hi, marks = max(inner, key=lambda a: (a[2], a[0] - a[1]))
    body = insts[lo:hi + 1]
    size = len(body)
    units = marks / per_unit
    groups = {"law": 0, "special": 0, "memory": 0, "control": 0}
    for ins in body:
        groups[group_of(ins, special)] += 1
    return {"loop_instructions": size, "units_per_trip": units,
            "per_unit": size / units,
            "groups_per_unit": {k: v / units for k, v in groups.items()},
            "mufu_per_unit": sum(x["op"].startswith("MUFU")
                                 for x in body) / units,
            "local_per_unit": sum(x["op"].startswith(LOCAL_OPS)
                                  for x in body) / units,
            "body": [f"{x['addr']:05x} {x['text']}  // {x['file']}:"
                     f"{x['line']}" for x in body]}


def census(library: Path, out_dir: Path | None = None,
           root: Path = ROOT) -> dict[str, dict]:
    """{label: loop census} of every kernel of KERNELS found in the
    built ``library`` of the checkout at ``root`` (``None`` where a kernel
    or its loop is missing; an :data:`OLDER_FORM` entry whose kernel is
    missing is left out).  ``out_dir``: where each loop's disassembly, the
    whole disassembly and the kernel names go."""
    work = Path(tempfile.mkdtemp(prefix="sass_", dir=library.parent))
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    try:
        subprocess.run([tool("cuobjdump"), "-xelf", "all", str(library)],
                       cwd=work, capture_output=True, text=True, check=True)
        cubins = sorted(work.glob("*.cubin"))
        if not cubins:
            raise RuntimeError(f"cuobjdump found no cubin in {library}")
        # only the objects of SOURCES, disassembled in parallel
        cubins = [c for c in cubins
                  if any(tag in c.read_bytes() for tag in SOURCES)]
        procs = [subprocess.Popen([tool("nvdisasm"), "-g", str(c)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cubins]
        funcs = {}
        for n, proc in enumerate(procs):
            text, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvdisasm failed on {cubins[n].name}: "
                                   f"{err}")
            if out_dir is not None:
                (out_dir / f"all_{n}.sass").write_text(text)
            funcs.update(parse(text))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    names = demangle(list(funcs))
    if out_dir is not None:
        (out_dir / "names.txt").write_text(
            "".join(f"{m}\t{d}\n" for m, d in names.items()))
    special = special_lines(root)
    layout = layout_constants(root)
    result = {}
    for label, prefix, marker, per_unit, unit, const in KERNELS:
        hits = [m for m, d in names.items()
                if normalize(d).startswith(prefix)]
        if not hits:
            if not label.endswith(OLDER_FORM):
                result[label] = None
            continue
        got = loop_census(funcs[hits[0]], marker, per_unit, special)
        if got is not None:
            got["unit"] = unit
            got["layout"] = (f"{'L' if const in LANE_CONSTANTS else 'R'} = "
                             f"{layout.get(const, 'not set')}")
            got["kernel"] = normalize(names[hits[0]]).split("(")[0]
            if out_dir is not None:
                out_dir.mkdir(parents=True, exist_ok=True)
                safe = re.sub(r"[^A-Za-z0-9]+", "_", label).strip("_")
                (out_dir / f"{safe}.sass").write_text("\n".join(got["body"]))
            got.pop("body")
        result[label] = got
    return result


def dump_kernels(out_dir: Path) -> dict[str, list[str]]:
    """{normalized kernel name: its instructions} of a dump written by
    :func:`census` with ``out_dir``, as :func:`parse` normalizes them
    (labels as addresses, anonymous namespaces as one name)."""
    names = dict(ln.split("\t", 1) for ln in
                 (out_dir / "names.txt").read_text().splitlines() if ln)
    funcs: dict[str, list[dict]] = {}
    for path in sorted(out_dir.glob("all_*.sass")):
        funcs.update(parse(path.read_text()))
    return {normalize(names.get(m, m)): [ins["norm"] for ins in insts]
            for m, insts in funcs.items()}


def compare(dir_a: Path, dir_b: Path) -> dict:
    """Kernel-by-kernel comparison of two census dumps."""
    a, b = dump_kernels(dir_a), dump_kernels(dir_b)
    common = sorted(set(a) & set(b))
    differ = [k for k in common if a[k] != b[k]]
    first = {}
    for k in differ:
        i = next((i for i, (x, y) in enumerate(zip(a[k], b[k])) if x != y),
                 min(len(a[k]), len(b[k])))
        first[k] = [i, *(v[i] if i < len(v) else None for v in (a[k], b[k]))]
    return {"common": len(common), "identical": len(common) - len(differ),
            "different": differ, "first_difference": first,
            "only_a": sorted(set(a) - set(b)),
            "only_b": sorted(set(b) - set(a))}


PTXAS_ENTRY = re.compile(r"(?:Compiling entry function|Function properties "
                         r"for) '?([A-Za-z_$][\w$]*)'?")
PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                         r"(\d+) bytes spill loads")
PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(log: str) -> dict[str, dict]:
    """{normalized kernel name: registers, stack and spill bytes} of every
    entry function of ``KERNELS``'s prefixes in nvcc's output with ``-Xptxas
    -v`` (``build/nvcc.log`` of ``utils/cuda_build.py``)."""
    funcs: dict[str, dict] = {}
    cur = None
    for ln in log.splitlines():
        m = PTXAS_ENTRY.search(ln)
        if m:
            cur = m.group(1)
            funcs.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = PTXAS_SPILL.search(ln)
        if m:
            funcs[cur].update(stack_bytes=int(m.group(1)),
                              spill_store_bytes=int(m.group(2)),
                              spill_load_bytes=int(m.group(3)))
        m = PTXAS_REGS.search(ln)
        if m:
            funcs[cur]["registers"] = int(m.group(1))
    if not funcs:
        return {}
    names = demangle(list(funcs))
    prefixes = tuple(k[1] for k in KERNELS)
    return {normalize(names[m]).split("(")[0]: v for m, v in funcs.items()
            if normalize(names[m]).startswith(prefixes)}


def floor_ms(per_unit: float, units: float) -> float:
    """Issue-rate floor in ms of ``units`` units at ``per_unit`` thread
    instructions each."""
    return 1e3 * per_unit * units / ISSUE_RATE


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for each loop's disassembly")
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="the checkout whose kernels to build and count")
    ap.add_argument("--compare", type=Path, nargs=2, default=None,
                    metavar=("DIR_A", "DIR_B"),
                    help="compare two dumps written with --out instead")
    ap.add_argument("--ptxas", action="store_true",
                    help="also print ptxas's registers and spill bytes of "
                    "each counted kernel (from the build's nvcc.log)")
    args = ap.parse_args()
    if args.compare is not None:
        print(json.dumps(compare(*args.compare)), flush=True)
        return 0
    sys.path.insert(0, str(args.root.resolve()))
    from carla_social_force_model_tpu_torch.utils import cuda_build
    lib = cuda_build.build_kernels()
    for label, got in census(lib, args.out, args.root.resolve()).items():
        print(json.dumps({"kernel": label, "census": got}), flush=True)
    if args.ptxas:
        for kernel, got in sorted(ptxas_report(
                cuda_build.BUILD_LOG.read_text()).items()):
            print(json.dumps({"kernel": kernel, "ptxas": got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
