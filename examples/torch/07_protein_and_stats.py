"""Protein alignment (BLOSUM62) and hit significance (E-values) on the card.

Generic S x S substitution matrices are additive over the reference
(DNA-only 6x6): encode with a custom alphabet, score with BLOSUM62, and
judge hit significance with Karlin-Altschul statistics. The port's twin of
examples/07_protein_and_stats.py.

    python examples/torch/07_protein_and_stats.py [--device cuda|cpu]
"""

import argparse

from versalignlib_tpu_torch import (AlignmentEngine, Algorithm,
                                    AlignmentParameters, calibrate, karlin_lambda)
from versalignlib_tpu_torch.alphabet import PROTEIN_ALPHABET, blosum62, encode_custom

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
device = ap.parse_args().device

params = AlignmentParameters(score_gap_read=-4, score_gap_ref=-4,
                             matrix=blosum62())

queries = ["MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ", "GAVLIMFWPSTCYNQDEKRH"]
targets = ["MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQAPILSRVGDGTQDNLSGAEKAVQ",
           "HRKEDQNYCTSPWFMILVAG"]

q = encode_custom(queries, PROTEIN_ALPHABET)
t = encode_custom(targets, PROTEIN_ALPHABET)
engine = AlignmentEngine(params, device=device)
for aln, name in zip(
        engine.compute_alignments(Algorithm.SMITH_WATERMAN, q, t),
        ("exact-prefix hit", "reversed decoy")):
    print(f"{name}: score={aln.score} cigar={aln.cigar}")

# Significance: exact ungapped lambda + an empirically calibrated Gumbel
# law (small sample here; production caches a larger calibration).
lam = karlin_lambda(params)
cal = calibrate(params, m=32, n=56, samples=128, seed=1, device=device)
scores = engine.score_alignments(Algorithm.SMITH_WATERMAN, q, t)
for name, s, m in zip(("hit", "decoy"), scores, (33, 20)):
    print(f"{name}: raw={int(s)} bits={float(cal.bit_score(s)):.1f} "
          f"E={float(cal.evalue(s, m, sum(len(x) for x in targets))):.2g}")
print(f"theory lambda={lam:.3f}, fitted lambda={cal.lam:.3f}")
