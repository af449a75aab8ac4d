"""Translated search (blastx-style) on the card: DNA reads vs a protein panel.

Each read is translated in all six reading frames (standard genetic code,
stops '*', ambiguous codons 'X') and every translation is scored against
the protein panel with BLOSUM62 + affine gaps in one matrix-mode sweep.
The port's twin of examples/09_translated_search.py.

    python examples/torch/09_translated_search.py [--device cuda|cpu]
"""

import argparse

from versalignlib_tpu_torch import (calibrate_translated, translate_six_frames,
                                    translated_search)

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
device = ap.parse_args().device

# A short coding sequence for the peptide MKWHHE, with a junk base in
# front so it sits in reading frame +2, and its reverse complement.
coding = "ATGAAATGGCATCATGAA"
reads = ["C" + coding + "GT",
         (coding[::-1].translate(str.maketrans("ACGT", "TGCA")))]
panel = ["MKWHHE", "WWYYFFPP"]

for frame, prot in translate_six_frames(reads[0]):
    print(f"frame {frame:+d}: {prot}")

hits = translated_search(reads, panel, device=device)
for i in range(len(hits)):
    print(f"read {i}: best panel entry {int(hits.index[i])} "
          f"({panel[int(hits.index[i])]}) in frame {int(hits.frame[i]):+d}, "
          f"score {int(hits.score[i])}")
assert int(hits.index[0]) == 0 and int(hits.frame[0]) == 2
assert int(hits.index[1]) == 0 and int(hits.frame[1]) < 0

# Full blastx-style output: the winning frame's protein alignment mapped
# back to DNA READ coordinates (forward strand, '-' for reverse frames),
# with a codon-scaled CIGAR and optional E-values.
cal = calibrate_translated(panel, read_len=24, samples=48, device=device)
hits = translated_search(reads, panel, alignments=True, calibration=cal, device=device)
for i in range(len(hits)):
    a = hits.alignments[i]
    print(f"read {i}: dna[{int(hits.dna_start[i])}:{int(hits.dna_end[i])}] "
          f"strand {hits.strand[i]} cigar {hits.dna_cigar[i]} "
          f"protein {a.read} E={float(hits.evalue[i]):.2g}")
assert hits.strand[0] == "+" and hits.strand[1] == "-"
assert (int(hits.dna_end[0]) - int(hits.dna_start[0]) + 1) % 3 == 0
