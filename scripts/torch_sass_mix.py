"""Instruction mix of the port's compiled CUDA kernels.

    python3 scripts/torch_sass_mix.py

Builds ``versalignlib_tpu_torch/csrc/*.cu`` (as the package does at first
use), disassembles each library with ``cuobjdump -sass`` and prints, per
kernel instantiation, one JSON line with its instruction count and the
count of each opcode (modifiers dropped: ``IMNMX.S32`` counts as ``IMNMX``).
Needs the CUDA toolkit; runs where the kernels are built.
"""

from __future__ import annotations

import collections
import json
import pathlib
import re
import shutil
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from versalignlib_tpu_torch.ops import _build  # noqa: E402

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


def main() -> int:
    cuobjdump = shutil.which("cuobjdump") or str(_build.DEFAULT_NVCC.with_name("cuobjdump"))
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    _build.build(sources)
    for source in sources:
        sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path(source))],
                              capture_output=True, text=True, check=True).stdout
        func, mix = None, collections.Counter()
        for line in sass.splitlines() + ["Function : <end>"]:
            m = _FUNC.match(line)
            if m:
                if func is not None:
                    print(json.dumps({"source": source, "function": func,
                                      "instructions": sum(mix.values()),
                                      "opcodes": dict(mix.most_common())}))
                func, mix = m.group(1), collections.Counter()
                continue
            m = _INSN.match(line)
            if m and func is not None:
                mix[m.group(1)] += 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
