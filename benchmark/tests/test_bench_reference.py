"""The plain reference against the port's own oracles and CPU path, on
pairs with gaps, N, padding and ties, under each scoring the
configurations use and two more."""

import numpy as np
import pytest

from vbench import gen, reference

SCORINGS = [
    dict(score_match=2, score_mismatch=-1, score_gap_read=-3, score_gap_ref=-3),
    dict(score_match=1, score_mismatch=-4, score_gap_read=-1, score_gap_ref=-1,
         gap_open_read=-6, gap_open_ref=-6),
    dict(score_match=3, score_mismatch=-2, score_gap_read=-1, score_gap_ref=-2,
         gap_open_read=-2, gap_open_ref=-1),
    dict(score_match=1, score_mismatch=-1, score_gap_read=-1, score_gap_ref=-1),
]


def _pairs(seed):
    rng = np.random.default_rng(seed)
    related = gen.make_pairs(rng, {"pad_to": 40, "length_min": 5, "length_max": 40,
                                   "n_rate": 0.1, "sub_rate": 0.3}, 120)
    unrelated = (gen.pad_tail(gen.bases(rng, (120, 30)), rng.integers(1, 31, 120)),
                 gen.pad_tail(gen.bases(rng, (120, 33)), rng.integers(1, 34, 120)))
    return [related, unrelated]


@pytest.mark.parametrize("scoring", SCORINGS, ids=["dna", "bwamem", "uneven", "unit"])
def test_scores_and_alignments_equal_the_ports_oracle(scoring):
    from versalignlib_tpu_torch.ops import gotoh, oracle
    from versalignlib_tpu_torch.params import AlignmentParameters
    from versalignlib_tpu_torch.types import TieBreak

    p = AlignmentParameters(**scoring)
    sc = reference.Scoring.from_config(scoring)
    score = gotoh.sw_score_affine if p.affine else oracle.sw_score
    align = gotoh.sw_align_affine if p.affine else oracle.sw_align
    for reads, refs in _pairs(7):
        want = np.array([score(r, f, p) for r, f in zip(reads, refs)])
        assert np.array_equal(reference.pair_scores(reads, refs, sc), want)
        cross = np.array([[score(r, f, p) for f in refs[:9]] for r in reads[:7]])
        assert np.array_equal(reference.cross_scores(reads[:7], refs[:9], sc), cross)
        for r, f in zip(reads, refs):
            a = align(r, f, p, TieBreak.DIAG_UP_LEFT)
            got = reference.align(r, f, sc)
            assert got == reference.Aligned(a.read, a.ref, a.score, a.cigar, a.read_start,
                                            a.read_end, a.ref_start, a.ref_end,
                                            a.buffer_start, a.buffer_end)


@pytest.mark.parametrize("scoring", SCORINGS[:2], ids=["dna", "bwamem"])
def test_mapping_equals_the_ports_cpu_path(scoring):
    """``map_to_reference`` on the CPU, reads with errors and a repeat in
    the reference so that second bests matter."""
    from versalignlib_tpu_torch.params import AlignmentParameters
    from versalignlib_tpu_torch.refmap import map_to_reference

    p = AlignmentParameters(**scoring)
    sc = reference.Scoring.from_config(scoring)
    rng = gen.rng_for(5, gen.REFERENCE)
    genome = gen.make_reference(rng, {"length": 2500})
    genome[1800:1900] = genome[300:400]            # a repeat: MAPQ 0 for reads in it
    spec = {"length": 60, "sub_rate": 0.05, "n_rate": 0.02, "reverse_rate": 0.5}
    reads = gen.make_reads(gen.rng_for(5, gen.READS), spec, genome, 10)["reads"]
    reads[0] = gen.mutate(rng, genome[310:370], 0.0, 0.0)
    got = map_to_reference(reads, genome, p, window=256, stride=128, device="cpu")
    want = reference.map_genome(reads, genome, 256, 128, sc)
    for field in ("ref_id", "pos", "score", "strand", "mapq"):
        assert np.array_equal(np.asarray(getattr(got, field)), want[field]), field
    assert [(a.read, a.ref, a.score, a.cigar, a.read_start, a.read_end, a.ref_start,
             a.ref_end, a.buffer_start, a.buffer_end) for a in got.alignments] == \
        [tuple(a.__dict__.values()) for a in want["alignments"]]
