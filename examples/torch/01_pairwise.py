"""Pairwise alignment basics, the reference's core workflow, on the card.

Score and traceback a batch of read/ref pairs, exactly like versalignLib's
`score_alignments` / `compute_alignments` (same defaults 2/-1/-3/-3, same
semantics bit for bit). The port's twin of examples/01_pairwise.py.

    python examples/torch/01_pairwise.py [--device cuda|cpu]
"""

import argparse

from versalignlib_tpu_torch import Algorithm, AlignmentEngine, AlignmentParameters

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
device = ap.parse_args().device

reads = ["ACGTACGTAC", "TTTTGGGGCC", "ACGT"]
refs = ["TTACGTACGTACTT", "AAAATTTTGGGGCCAAAA", "TTTT"]

engine = AlignmentEngine(device=device)  # DEFAULT_PARAMETERS, backend="auto"
scores = engine.score_alignments(Algorithm.SMITH_WATERMAN, reads, refs)
print("SW scores:", list(scores))

for aln in engine.compute_alignments(Algorithm.SMITH_WATERMAN, reads, refs):
    print(f"score={aln.score:3d} cigar={aln.cigar:8s} "
          f"read[{aln.read_start}:{aln.read_end}] "
          f"ref[{aln.ref_start}:{aln.ref_end}]  {aln.read} / {aln.ref}")

# Affine (Gotoh) gaps and the semi-global "NW": additive over the reference.
affine = AlignmentEngine(params=AlignmentParameters(
    gap_open_read=-4, gap_open_ref=-4), device=device)
print("NW affine scores:",
      list(affine.score_alignments(Algorithm.NEEDLEMAN_WUNSCH, reads, refs)))
