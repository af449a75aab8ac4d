"""Instruction mix of the port's compiled CUDA kernels.

    python3 scripts/torch_sass_mix.py [--against CHECKOUT] [SOURCE ...]

Builds ``versalignlib_tpu_torch/csrc/*.cu`` (as the package does at first
use), disassembles each library with ``cuobjdump -sass`` and prints, per
kernel instantiation, one JSON line with its instruction count, the count of
each opcode (modifiers dropped: ``IMNMX.S32`` counts as ``IMNMX``), and its
hot loop: the longest loop with no loop inside it (a backward branch and
its target). In the fills it is a stripe's step loop (``fill.cuh``), one
row of a lane's 16 columns per iteration, whose body also holds the rarely
taken SW argmax search and NW row-mrp code, so its count per cell is an
upper bound; in ``search.cu`` and ``score.cu`` it is a stripe's step loop
(``stripe.cuh``, ``group_best``), one row of a lane's kCols columns (the
instantiation's last integer template argument) per iteration. A stripe
whose last lane is partial runs a second copy of that loop with a select a
cell;
in the banded kernels (``banded_score.cu``, ``banded_align.cu``) it is the
row loop of the register path (band <= 1024, the last template argument
0; ``banded.cuh``): both passes over a lane's 32 columns, unrolled, and the
scan between them, so its count a cell also carries the row's scan and
bookkeeping, and where the band is 512 half the unrolled columns run (the
wide path, argument 1, loops over chunks of 32 columns);
``inner_loops`` lists the instructions of every innermost loop. For that loop it gives the opcodes, the instructions
per cell (loop instructions / rows / columns) and their split by the pipe
that issues them, as the Nsight Compute profiling guide
describes the pipes: ``fma`` takes IMAD and IMUL (and FP32), ``alu`` the
other integer, logic and compare instructions, ``lsu`` loads and stores,
``other`` the rest (branches, constant loads, conversions).
With ``--against CHECKOUT`` each source of that checkout is built the same
way and every line also says whether the instantiation's SASS (every
instruction with its operands, in order) is the same in both
(``same_sass_as_against``; null where the other build lacks it), and the
other build's instruction count and hot-loop instructions per cell.
Needs the CUDA toolkit; runs where the kernels are built.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import re
import shutil
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from versalignlib_tpu_torch.ops import _build  # noqa: E402

#: DP columns per hot-loop iteration of each source: a lane's 16 columns in
#: the fills (fill.cuh, kCols), a chunk of 32 band columns in the banded
#: kernels (banded.cuh, kChunk); the step loops of stripe.cuh take kCols
#: from the instantiation. Every hot loop covers one read row an iteration.
COLUMNS = {"align.cu": 16, "align_affine.cu": 16, "banded_score.cu": 32,
           "banded_align.cu": 32}
STEP_LOOPS = ("search.cu", "score.cu")


def columns(source: str, func: str) -> int:
    """DP columns per hot-loop iteration of ``func``: the step loop's kCols
    is the last integer template argument of its mangled name."""
    if source in STEP_LOOPS:
        return int(re.findall(r"Li(\d+)E", func)[-1])
    return COLUMNS.get(source, 1)

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(
    r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\S*)\s*([^;]*)")
_TARGET = re.compile(r"0x([0-9a-f]+)")

_FMA = {"IMAD", "IMUL", "IDP", "FFMA", "FADD", "FMUL"}
_ALU = {"IADD3", "IADD", "VIADD", "IMNMX", "VIMNMX", "VIMNMX3", "VIADDMNMX", "ISETP",
        "SEL", "LOP3", "PLOP3", "SHF", "SHL", "SHR", "LEA", "PRMT", "IABS", "MOV",
        "FSEL", "FSETP", "FMNMX", "P2R", "R2P", "BMSK", "FLO", "POPC", "BREV"}
_LSU = {"LD", "LDG", "LDS", "LDL", "ST", "STG", "STS", "STL", "ATOM", "ATOMS", "RED"}


def pipe(opcode: str) -> str:
    if opcode in _FMA:
        return "fma"
    if opcode in _ALU:
        return "alu"
    if opcode in _LSU:
        return "lsu"
    return "other"


def hot_loop(insns: list[tuple[int, str, str]], rows: int, cols: int = 1) -> dict | None:
    """The longest innermost loop of one function's (address, opcode,
    operands) list, covering ``rows`` x ``cols`` cells per iteration, or
    None where it has no loop."""
    loops = []
    for addr, op, operands in insns:
        found = _TARGET.search(operands) if op == "BRA" else None
        if found and int(found.group(1), 16) <= addr:
            loops.append((int(found.group(1), 16), addr))
    inner = [(lo, hi) for lo, hi in loops
             if not any(lo <= a and b < hi and (a, b) != (lo, hi) for a, b in loops)]
    if not inner:
        return None
    sizes = sorted((sum(lo <= a <= hi for a, _, _ in insns) for lo, hi in inner),
                   reverse=True)
    lo, hi = max(inner, key=lambda span: span[1] - span[0])
    body = [op for addr, op, _ in insns if lo <= addr <= hi]
    mix = collections.Counter(body)
    pipes = collections.Counter(pipe(op) for op in body)
    cells = rows * cols
    return {"instructions": len(body), "cells": cells,
            "per_cell": len(body) / cells,
            "per_cell_by_pipe": {k: v / cells for k, v in pipes.most_common()},
            "shared_per_cell": {op: mix[op] / cells for op in ("LDS", "STS")},
            "inner_loops": sizes,
            "opcodes": dict(mix.most_common())}


def _without_anonymous_namespace(func: str) -> str:
    """A mangled name with its anonymous namespace taken out: the namespace's
    name carries a hash of the source, so the same kernel of two checkouts
    would differ by it."""
    m = re.match(r"_ZN(\d+)_GLOBAL__N_", func)
    return "_ZN" + func[m.end(1) + int(m.group(1)):] if m else func


def functions(cuobjdump: str, library: pathlib.Path) -> dict[str, tuple[list, list]]:
    """Each function of ``library`` by its mangled name (without its
    anonymous namespace): its (address,
    opcode, operands) list, modifiers dropped from the opcode, and its
    lines as ``cuobjdump -sass`` prints them (predicates, modifiers and both
    encoding words, control bits included)."""
    sass = subprocess.run([cuobjdump, "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    out, func = {}, None
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            func = _without_anonymous_namespace(m.group(1))
            out[func] = ([], [])
            continue
        if func is None or not line.strip().startswith("/*"):
            continue
        out[func][1].append(line.strip())
        m = _INSN.match(line)
        if m:
            out[func][0].append((int(m.group(1), 16), m.group(2), m.group(4)))
    return out


def build_against(checkout: pathlib.Path, source: str) -> pathlib.Path:
    """nvcc of ``checkout``'s csrc/``source`` with the package's flags into
    ``build/against/``."""
    out_dir = _build.BUILD_DIR / "against"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / source.replace(".cu", ".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(checkout / "versalignlib_tpu_torch" / "csrc" / source)],
                   check=True, capture_output=True, text=True)
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=pathlib.Path,
                    help="a checkout whose builds' SASS each function is compared with")
    ap.add_argument("sources", nargs="*", help="csrc sources (default: all)")
    args = ap.parse_args()
    cuobjdump = shutil.which("cuobjdump") or str(_build.DEFAULT_NVCC.with_name("cuobjdump"))
    sources = args.sources or sorted(p.name for p in _build.CSRC.glob("*.cu"))
    _build.build(sources)
    for source in sources:
        funcs = functions(cuobjdump, _build.library_path(source))
        other = (functions(cuobjdump, build_against(args.against.resolve(), source))
                 if args.against else None)
        for func, (insns, text) in funcs.items():
            mix = collections.Counter(op for _, op, _ in insns)
            line = {"source": source, "function": func, "instructions": len(insns),
                    "opcodes": dict(mix.most_common()),
                    "hot_loop": hot_loop(insns, 1, columns(source, func))}
            if other is not None:
                line["same_sass_as_against"] = other[func][1] == text if func in other else None
                if func in other:
                    theirs = other[func][0]
                    hot = hot_loop(theirs, 1, columns(source, func)) or {}
                    line["against_instructions"] = len(theirs)
                    line["against_hot_loop_per_cell"] = hot.get("per_cell")
            print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
