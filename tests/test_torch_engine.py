"""The port's slice as a whole on its CPU path: ``AlignmentEngine(device=
"cpu")`` against the JAX package's ``AlignmentEngine(backend="pallas")``
(interpret mode on the CPU), and the golden corpus made from the unmodified
C++ reference."""

import collections
import json
import pathlib

import numpy as np
import pytest

from tests.conftest import random_codes
from versalignlib_tpu import AlignmentEngine as JaxEngine
from versalignlib_tpu.types import Algorithm as JaxAlgorithm
from versalignlib_tpu.types import TieBreak as JaxTieBreak
from versalignlib_tpu_torch import (
    Algorithm,
    AlignmentBatch,
    AlignmentEngine,
    AlignmentParameters,
    TieBreak,
)
from versalignlib_tpu_torch.alphabet import encode
from versalignlib_tpu_torch.ops import cuda_align

GOLDEN = pathlib.Path(__file__).parent / "golden" / "golden.json"
_FIELDS = ("read", "ref", "score", "cigar", "read_start", "read_end",
           "ref_start", "ref_end", "buffer_start", "buffer_end")


def _fields(a):
    return tuple(getattr(a, f) for f in _FIELDS)


@pytest.mark.parametrize("tie", list(TieBreak))
@pytest.mark.parametrize("algorithm", list(Algorithm))
def test_engine_matches_jax_pallas_engine(algorithm, tie):
    rng = np.random.default_rng(300 + 2 * int(algorithm) + int(tie))
    reads = random_codes(rng, 18, 10, padded=True, n_prob=0.08)
    refs = random_codes(rng, 18, 13, padded=True, n_prob=0.08)
    ours = AlignmentEngine(tie=tie, device="cpu")
    theirs = JaxEngine(backend="pallas", tie=JaxTieBreak(int(tie)))
    jalg = JaxAlgorithm(int(algorithm))

    np.testing.assert_array_equal(ours.score_alignments(algorithm, reads, refs),
                                  theirs.score_alignments(jalg, reads, refs))

    got = ours.compute_alignments(algorithm, reads, refs)
    want = theirs.compute_alignments(jalg, reads, refs)
    assert len(got) == len(want) == 18
    for k, (g, w) in enumerate(zip(got, want)):
        assert _fields(g) == _fields(w), k

    got_raw = ours.compute_alignments(algorithm, reads, refs, raw=True)
    want_raw = theirs.compute_alignments(jalg, reads, refs, raw=True)
    assert isinstance(got_raw, AlignmentBatch)
    for col in ("read_gapped", "ref_gapped", "cigar", "meta"):
        np.testing.assert_array_equal(getattr(got_raw, col), getattr(want_raw, col))

    cig = ours.compute_alignments(algorithm, reads, refs, raw=True, gapped=False)
    assert cig.read_gapped is None and cig.ref_gapped is None
    np.testing.assert_array_equal(cig.meta, want_raw.meta)
    np.testing.assert_array_equal(cig.cigar, want_raw.cigar)


def test_engine_strings_and_chunking():
    engine = AlignmentEngine(device="cpu")
    reads = ["ACGTACGT", "TTTT", "acgt"]
    refs = ["ACGTACGT", "GGGGTTTTGGGG", "ACGT"]
    np.testing.assert_array_equal(
        engine.score_alignments(Algorithm.SMITH_WATERMAN, reads, refs), [16, 8, 8])
    alns = engine.compute_alignments(Algorithm.SMITH_WATERMAN, reads, refs)
    assert alns[0].cigar == "8M"
    assert (alns[1].read, alns[1].ref) == ("TTTT", "TTTT")
    with pytest.raises(ValueError):
        engine.score_alignments(Algorithm.SMITH_WATERMAN, ["ACGT"], ["ACGT", "A"])

    # Several chunks, the next dispatched before the previous is decoded,
    # give what one chunk gives.
    rng = np.random.default_rng(5)
    r = random_codes(rng, 11, 9, padded=True, n_prob=0.05)
    f = random_codes(rng, 11, 12, padded=True, n_prob=0.05)
    for alg in Algorithm:
        whole = cuda_align.align_batch(r, f, engine.params, alg, device="cpu", raw=True)
        parts = cuda_align.align_batch(r, f, engine.params, alg, device="cpu",
                                       raw=True, chunk_pairs=4)
        np.testing.assert_array_equal(whole.meta, parts.meta)
        np.testing.assert_array_equal(whole.read_gapped, parts.read_gapped)


def test_degenerate_empty_axes_match_jax():
    reads = np.zeros((2, 0), np.uint8)
    refs = np.ones((2, 4), np.uint8)
    for alg in Algorithm:
        got = AlignmentEngine(device="cpu").compute_alignments(alg, reads, refs)
        want = JaxEngine(backend="pallas").compute_alignments(
            JaxAlgorithm(int(alg)), reads, refs)
        assert [_fields(a) for a in got] == [_fields(a) for a in want]


def _golden_groups():
    with open(GOLDEN) as fh:
        cases = json.load(fh)
    groups = collections.defaultdict(list)
    for c in cases:
        key = (c["match"], c["mismatch"], c["gap_read"], c["gap_ref"], c["opt"],
               len(c["read"]), len(c["ref"]))
        groups[key].append(c)
    return len(cases), groups


def test_golden_corpus_through_the_cpu_path():
    total, groups = _golden_groups()
    assert total == 672
    checked = collections.Counter()
    for (match, mismatch, gap_read, gap_ref, opt, _, _), cases in groups.items():
        p = AlignmentParameters(score_match=match, score_mismatch=mismatch,
                                score_gap_read=gap_read, score_gap_ref=gap_ref)
        alg = Algorithm(opt)
        read_texts = [c["read"].replace("_", "\0") for c in cases]
        ref_texts = [c["ref"].replace("_", "\0") for c in cases]
        reads = np.stack([encode(t) for t in read_texts])
        refs = np.stack([encode(t) for t in ref_texts])
        scores = AlignmentEngine(p, device="cpu").score_alignments(alg, reads, refs)
        assert scores.tolist() == [c["score"] for c in cases]
        checked["score"] += len(cases)
        for tie, prefix in ((TieBreak.DIAG_UP_LEFT, "default"),
                            (TieBreak.DIAG_LEFT_UP, "sse")):
            alns = cuda_align.align_batch(reads, refs, p, alg, tie, device="cpu",
                                          read_texts=read_texts, ref_texts=ref_texts)
            for c, a in zip(cases, alns):
                if f"{prefix}_read" not in c:
                    continue
                assert (a.read.replace("\0", "_"), a.ref.replace("\0", "_"),
                        a.buffer_start) == \
                    (c[f"{prefix}_read"], c[f"{prefix}_ref"], c[f"{prefix}_start"]), c
                checked[prefix] += 1
    assert checked == {"score": 672, "default": 576, "sse": 576}
