"""Whole-reference mapping on the card: exhaustive window tiling.

Map short reads against a long reference (contig/chromosome scale) with no
seeding heuristics: every window is scored, so the best locus is exact by
construction. Results come back in global reference coordinates. The
port's twin of examples/03_reference_mapping.py.

    python examples/torch/03_reference_mapping.py [--device cuda|cpu]
"""

import argparse

import numpy as np

from versalignlib_tpu_torch import map_to_reference
from versalignlib_tpu_torch.alphabet import reverse_complement

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
device = ap.parse_args().device

rng = np.random.default_rng(7)
bases = np.array(list("ACGT"))
chromosome = "".join(rng.choice(bases, size=20_000))

positions = [1234, 9_000, 19_000]
reads = [chromosome[p : p + 64] for p in positions]
reads[1] = reverse_complement(reads[1])  # simulate a reverse-strand read

hits = map_to_reference(reads, [chromosome], device=device)
for i, p in enumerate(positions):
    a = hits.alignments[i]
    print(f"read{i}: mapped to ref{int(hits.ref_id[i])}:"
          f"{a.ref_start}-{a.ref_end} "
          f"strand={'-' if hits.strand[i] else '+'} mapq={int(hits.mapq[i])}"
          f"  (planted at {p}: {'OK' if a.ref_start == p else 'MISS'})")
