"""``AlignmentEngine(backend="cuda").score_alignments`` on numpy code
batches: each call scores one batch of the pool, cycling through it.

Traffic keys: ``pairs_per_call``, ``pool`` (distinct batches made in
set-up). The configuration's ``pairs`` block draws the pairs, its
``scoring`` and ``algorithm`` score them.
"""

from __future__ import annotations

import numpy as np

from vbench import gen, reference, roofline
from vbench.entry import Check, Entry as Base, Record, failed_check


def draw_pool(cfg: dict, traffic: dict, seed: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """The traffic's ``pool`` batches of ``pairs_per_call`` pairs, batch k
    from its own stream of the seed."""
    return [gen.make_pairs(gen.rng_for(seed, gen.PAIRS, k), cfg["pairs"],
                           traffic["pairs_per_call"]) for k in range(traffic["pool"])]


def pair_units(batches, used: list[int]) -> dict:
    """The work of the calls that scored ``batches[k]`` for k in ``used``:
    pairs, padded cells (B x m x n, as the reference harness counts), the
    cells the inputs need and the score kernel's bytes (codes in, scores
    out)."""
    cells = [roofline.pair_cells(r, f) for r, f in batches]
    out = {"calls": len(used), "pairs": 0, "padded_cells": 0, "b1_cells": 0, "b1_bytes": 0}
    for k in used:
        reads, refs = batches[k]
        out["pairs"] += reads.shape[0]
        out["padded_cells"] += reads.shape[0] * reads.shape[1] * refs.shape[1]
        out["b1_cells"] += cells[k]
        out["b1_bytes"] += reads.nbytes + refs.nbytes + 4 * reads.shape[0]
    return out


def score_checks(batches, answered: list[tuple[int, np.ndarray]], scoring, device) -> list[Check]:
    """Every answer of the window against the reference's scores of its
    batch."""
    used = sorted({k for k, _ in answered})
    want = {k: reference.pair_scores(*batches[k], scoring, device) for k in used}
    wrong = 0
    for k, got in answered:
        got = np.asarray(got).reshape(-1)
        wrong += want[k].size if got.size != want[k].size else int((got != want[k]).sum())
    return [Check("scores_wrong", wrong, 0)]


class Entry(Base):
    def setup(self):
        from versalignlib_tpu_torch import AlignmentEngine, AlignmentParameters, Algorithm

        self.scoring = reference.Scoring.from_config(self.cfg["scoring"])
        if self.cfg["algorithm"] != "smith_waterman":
            raise ValueError("the reference scores Smith-Waterman alone")
        self.algorithm = Algorithm.SMITH_WATERMAN
        self.batches = draw_pool(self.cfg, self.traffic, self.seed)
        self.engine = AlignmentEngine(AlignmentParameters(**self.cfg["scoring"]),
                                      backend="cuda", device=self.device)
        self.engine.score_alignments(self.algorithm, *self.batches[0])

    def call(self, k):
        return self.engine.score_alignments(self.algorithm, *self.batches[k % len(self.batches)])

    def control(self, k):
        return reference.pair_scores(*self.batches[k % len(self.batches)], self.scoring,
                                     self.device, cell_bits=self.cfg["control_cell_bits"])

    def units(self, records: list[Record]) -> dict:
        return pair_units(self.batches, [r.k % len(self.batches) for r in records])

    def release(self):
        self.engine = None

    def check(self, records: list[Record]) -> list[Check]:
        answered = [(r.k % len(self.batches), r.answer) for r in records if r.error is None]
        return score_checks(self.batches, answered, self.scoring, self.device) \
            + [failed_check(records)]
