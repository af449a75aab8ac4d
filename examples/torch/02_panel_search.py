"""Database search on the card: map reads against a reference panel, emit SAM.

One-vs-many search (filter-then-align): every read is scored against every
panel entry on the card, and only each read's winning pair is aligned.
Strand-aware with a best-vs-second-best MAPQ. The port's twin of
examples/02_panel_search.py.

    python examples/torch/02_panel_search.py [--device cuda|cpu]
"""

import argparse
import io
import sys

from versalignlib_tpu_torch import map_reads
from versalignlib_tpu_torch.alphabet import reverse_complement
from versalignlib_tpu_torch.io.sam import write_sam

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
device = ap.parse_args().device

panel = {
    "geneA": "ACGTACGTACGTACGTACGTACGTACGTACGT",
    "geneB": "TTGGCCAATTGGCCAATTGGCCAATTGGCCAA",
    "geneC": "ACACACACGTGTGTGTACACACACGTGTGTGT",
}
names = list(panel)
seqs = list(panel.values())

reads = [
    seqs[0][4:24],                        # forward hit on geneA
    reverse_complement(seqs[1][8:28]),    # reverse-strand hit on geneB
]

hits = map_reads(reads, seqs, device=device)
for i in range(len(hits)):
    print(f"read{i} -> {names[hits.index[i]]} "
          f"strand={'-' if hits.strand[i] else '+'} "
          f"score={int(hits.score[i])} mapq={int(hits.mapq[i])} "
          f"cigar={hits.alignments[i].cigar}")

# SAM output (FLAG 16 on reverse-strand records, NM/MD/AS tags).
buf = io.StringIO()
oriented = [reverse_complement(r) if s else r
            for r, s in zip(reads, hits.strand)]
write_sam(buf, hits.alignments, oriented, [seqs[j] for j in hits.index],
          ref_names=[names[j] for j in hits.index], strands=hits.strand,
          mapqs=hits.mapq)
sys.stdout.write(buf.getvalue())
