"""``refmap.map_to_reference`` of each pool batch of reads, both strands,
against a ``WindowIndex`` of one reference that set-up tiles once (as a
user does with ``WindowIndex.save`` / ``load``); every read's winner is
aligned and shifted to reference coordinates.

The configuration's ``references`` block describes the reference
(``{"length", "window", "stride"}``) and its ``reads`` block the reads;
the traffic names the reference, ``reads_per_call``, the ``pool`` of
distinct batches cycled through, and ``check_reads``, the reads whose
whole answer the reference works out again.
"""

from __future__ import annotations

import zlib

import numpy as np

from vbench import gen, reference, roofline
from vbench.entry import Check, Entry as Base, Record, failed_check

#: The alignment fields that are compared.
ALIGNMENT_FIELDS = ("read", "ref", "score", "cigar", "read_start", "read_end", "ref_start",
                    "ref_end", "buffer_start", "buffer_end")


class Entry(Base):
    #: Hit fields compared (beside the alignments), in the answer's names.
    FIELDS = ("ref_id", "pos", "score", "strand", "mapq")

    def setup(self):
        from versalignlib_tpu_torch import AlignmentParameters
        from versalignlib_tpu_torch.refmap import tile_references

        self.scoring = reference.Scoring.from_config(self.cfg["scoring"])
        if self.cfg["algorithm"] != "smith_waterman":
            raise ValueError("the reference maps with Smith-Waterman alone")
        self.params = AlignmentParameters(**self.cfg["scoring"])
        name = self.traffic["reference"]
        self.ref_spec = self.cfg["references"][name]
        self.reference = gen.make_reference(
            gen.rng_for(self.seed, gen.REFERENCE, zlib.crc32(name.encode())), self.ref_spec)
        self.batches = [gen.make_reads(gen.rng_for(self.seed, gen.READS, k), self.cfg["reads"],
                                       self.reference, self.traffic["reads_per_call"])["reads"]
                        for k in range(self.traffic["pool"])]
        # The program's state that a user builds once (and keeps with
        # WindowIndex.save / load).
        self.index = tile_references(self.reference, self.ref_spec["window"],
                                     self.ref_spec["stride"])
        self.call(0)

    def call(self, k):
        from versalignlib_tpu_torch.refmap import map_to_reference

        return map_to_reference(self.batches[k % len(self.batches)], self.index, self.params,
                                device=self.device)

    def release(self):
        self.index = None

    def pool_codes(self) -> np.ndarray:
        """The windows the one-vs-many kernel scores the reads against, as
        the reference tiles them."""
        return reference.tile(self.reference, self.ref_spec["window"], self.ref_spec["stride"])[0]

    def units(self, records: list[Record]) -> dict:
        pool = self.pool_codes()
        per_read = int(roofline.lengths(pool).sum())
        reads = rows = 0
        cells = 0
        for r in records:
            batch = self.batches[r.k % len(self.batches)]
            reads += batch.shape[0]
            cells += 2 * int(roofline.lengths(batch).sum()) * per_read
            rows += 2 * batch.shape[0]
        # Bytes: the pool read once for each strand's queries, the queries,
        # and the (queries, pool) int32 scores written.
        nbytes = len(records) * 2 * pool.nbytes + rows * (self.batches[0].shape[1]
                                                         + 4 * pool.shape[0])
        return {"calls": len(records), "reads": reads, "b4_cells": cells, "b4_bytes": nbytes}

    def sample(self, used: list[int]) -> list[tuple[int, int]]:
        """``check_reads`` (batch, row) pairs drawn from the seed among the
        batches the window used."""
        rows = [(k, i) for k in used for i in range(self.batches[k].shape[0])]
        rng = gen.rng_for(self.seed, gen.SAMPLE)
        pick = rng.choice(len(rows), size=min(self.traffic["check_reads"], len(rows)),
                          replace=False)
        return [rows[j] for j in sorted(pick)]

    def expected(self, reads: np.ndarray, cell_bits: int = 32) -> dict:
        """The reference's answers for ``reads``."""
        return reference.map_genome(reads, self.reference, self.ref_spec["window"],
                                    self.ref_spec["stride"], self.scoring, self.device, cell_bits)

    def normal(self, answer) -> dict:
        """An answer as the reference gives it: the hit fields as arrays and
        the alignments as tuples of :data:`ALIGNMENT_FIELDS`."""
        if isinstance(answer, dict):
            fields = {f: np.asarray(answer[f]) for f in self.FIELDS}
            alns = [tuple(getattr(a, f) for f in ALIGNMENT_FIELDS) for a in answer["alignments"]]
        else:
            fields = {f: np.asarray(getattr(answer, f)) for f in self.FIELDS}
            alns = [tuple(getattr(a, f) for f in ALIGNMENT_FIELDS) for a in answer.alignments]
        return {"fields": fields, "alignments": alns}

    def control(self, k):
        return self.expected(self.batches[k % len(self.batches)],
                             cell_bits=self.cfg["control_cell_bits"])

    def located(self, fields: dict, rows: int) -> np.ndarray:
        """The window (of ``rows``) that each hit names, pos / stride of
        reference 0; -1 where it names none."""
        stride = self.ref_spec["stride"]
        pos = fields["pos"].astype(np.int64)
        ok = (fields["ref_id"] == 0) & (pos % stride == 0) & (pos >= 0) & (pos < rows * stride)
        return np.where(ok, pos // stride, -1)

    def check(self, records: list[Record]) -> list[Check]:
        """Two comparisons. Every read of every call: its score against the
        reference's score of the read, on the strand returned, in the pool
        row returned, and its alignment's score against it
        (``hit_scores_wrong``). The sampled reads: every call's whole answer
        against the reference's, which searches the whole pool (a hit
        differs where any field does)."""
        answered = [(r.k % len(self.batches), self.normal(r.answer))
                    for r in records if r.error is None]
        picks = self.sample(sorted({k for k, _ in answered}))
        want = self.normal(self.expected(np.stack([self.batches[k][i] for k, i in picks])))
        where = {pick: j for j, pick in enumerate(picks)}
        hits_wrong = alns_wrong = compared = 0
        for k, got in answered:
            for (kk, i), j in where.items():
                if kk != k:
                    continue
                compared += 1
                hits_wrong += any(int(got["fields"][f][i]) != int(want["fields"][f][j])
                                  for f in self.FIELDS)
                alns_wrong += got["alignments"][i] != want["alignments"][j]
        return [Check("hit_scores_wrong", self._hit_scores_wrong(answered), 0),
                Check("hits_wrong", hits_wrong, 0), Check("alignments_wrong", alns_wrong, 0),
                Check("reads_unchecked", int(compared == 0), 0), failed_check(records)]

    def _hit_scores_wrong(self, answered: list[tuple[int, dict]]) -> int:
        """Answers, over every read of every call, whose hit names no pool
        row, or whose score or alignment score is not the reference's score
        of the read, on the strand returned, against that row."""
        pool = self.pool_codes()
        score_at = ALIGNMENT_FIELDS.index("score")
        wrong = 0
        scores: dict[tuple, list[int]] = {}
        for k, got in answered:
            fields = got["fields"]
            for i, row in enumerate(self.located(fields, len(pool))):
                score = int(fields["score"][i])
                if row < 0 or got["alignments"][i][score_at] != score:
                    wrong += 1
                    continue
                scores.setdefault((k, i, int(fields["strand"][i]), int(row)), []).append(score)
        if not scores:
            return wrong
        keys = list(scores)
        reads = np.stack([self.batches[k][i] for k, i, _, _ in keys])
        reverse = np.array([strand == 1 for _, _, strand, _ in keys])
        reads[reverse] = gen.reverse_complement(reads[reverse])
        ref = reference.pair_scores(reads, pool[[row for *_, row in keys]], self.scoring,
                                    self.device)
        for key, want in zip(keys, ref):
            wrong += sum(score != int(want) for score in scores[key])
        return wrong
