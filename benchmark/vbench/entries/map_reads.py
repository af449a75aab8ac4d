"""``search.map_reads`` of each pool batch of reads, both strands, against a
panel of entries drawn once in set-up; every read's winner is aligned.
All other arguments stay at their defaults (``max_pairs`` 2**20, so the
panel streams through in chunks of ``2**20 // reads_per_call`` entries).

The configuration's ``panel`` block describes the panel and its ``reads``
block the reads (:mod:`vbench.panel`); the traffic names
``reads_per_call``, the ``pool`` of distinct batches cycled through, and
``check_reads``, the reads whose whole answer the reference works out
again. The comparison is the genome entry's, with the panel's entries in
place of its windows.
"""

from __future__ import annotations

import numpy as np

from vbench import gen, panel, reference, roofline
from vbench.entries import map_to_reference
from vbench.entry import Record

#: ``map_reads``' default bound on the pairs of one launch.
MAX_PAIRS = 1 << 20


class Entry(map_to_reference.Entry):
    FIELDS = ("index", "score", "strand", "mapq")

    def setup(self):
        from versalignlib_tpu_torch import AlignmentParameters

        self.scoring = reference.Scoring.from_config(self.cfg["scoring"])
        if self.cfg["algorithm"] != "smith_waterman":
            raise ValueError("the reference maps with Smith-Waterman alone")
        self.params = AlignmentParameters(**self.cfg["scoring"])
        self.entries = panel.make_panel(gen.rng_for(self.seed, gen.REFERENCE, panel.STREAM),
                                        self.cfg["panel"], self.cfg["reads"]["v4"])
        self.batches = [panel.make_reads(gen.rng_for(self.seed, gen.READS, k), self.cfg["reads"],
                                         self.entries, self.traffic["reads_per_call"])["reads"]
                        for k in range(self.traffic["pool"])]
        self.call(0)

    def call(self, k):
        from versalignlib_tpu_torch.search import map_reads

        return map_reads(self.batches[k % len(self.batches)], self.entries, self.params,
                         device=self.device)

    def release(self):
        """``map_reads`` keeps no state between calls: nothing to drop."""

    def pool_codes(self) -> np.ndarray:
        return self.entries

    def units(self, records: list[Record]) -> dict:
        entries = self.entries
        per_read = int(roofline.lengths(entries).sum())
        reads = cells = nbytes = 0
        for r in records:
            batch = self.batches[r.k % len(self.batches)]
            b, rows = batch.shape[0], entries.shape[0]
            launches = -(-rows // max(1, min(rows, MAX_PAIRS // max(b, 1))))
            reads += b
            cells += 2 * int(roofline.lengths(batch).sum()) * per_read
            # Bytes a strand: the reads (B4's pool) read once a chunk's
            # launch, the panel's entries (its queries) once, and the
            # (entries, reads) int32 scores written.
            nbytes += 2 * (launches * batch.nbytes + entries.nbytes + 4 * rows * b)
        return {"calls": len(records), "reads": reads, "b4_cells": cells, "b4_bytes": nbytes}

    def expected(self, reads: np.ndarray, cell_bits: int = 32) -> dict:
        return panel.map_panel(reads, self.entries, self.scoring, self.device, cell_bits)

    def located(self, fields: dict, rows: int) -> np.ndarray:
        """The entry that each hit names; -1 where it names none."""
        index = fields["index"].astype(np.int64)
        return np.where((index >= 0) & (index < rows), index, -1)
