"""Banded long pairs in the port against the JAX package, with ``==``
(every output is an integer or text): the plain banded score and fill
(``ops/plain_banded.py``, reached through ``banded_score_batch`` /
``banded_align_batch(device="cpu")`` and the native banded walk) against
``banded_score_oracle`` / ``banded_align_oracle`` in every branch (SW / NW x
linear / affine x DNA / BLOSUM62 x both tie flavors), against the Pallas
banded kernels in interpret mode once per (algorithm, gap model), the full
band against the port's dense path, and ``AlignmentModel`` against the JAX
models."""

import dataclasses

import numpy as np
import pytest
import torch

from tests.conftest import random_codes
from versalignlib_tpu import models as jax_models
from versalignlib_tpu.alphabet import blosum62 as jax_blosum62
from versalignlib_tpu.ops import banded as jax_banded
from versalignlib_tpu.ops import gotoh
from versalignlib_tpu.params import AlignmentParameters as JaxParams
from versalignlib_tpu.types import Algorithm as JaxAlgorithm
from versalignlib_tpu.types import TieBreak as JaxTieBreak
from versalignlib_tpu_torch import AlignmentEngine, models, params_from_reference
from versalignlib_tpu_torch.ops import cuda_banded, plain_banded
from versalignlib_tpu_torch.ops.banded import (band_offsets, banded_align_batch,
                                               banded_score_batch)
from versalignlib_tpu_torch.types import Algorithm, TieBreak

#: (name, JAX parameters): DNA linear (the reference default), DNA affine
#: (tests/test_banded.py AFFINE_PARAMS), BLOSUM62 linear and affine.
_JAX_SETS = {
    "dna_linear": JaxParams(),
    "dna_affine": JaxParams(score_match=2, score_mismatch=-1, score_gap_read=-1,
                            score_gap_ref=-1, gap_open_read=-4, gap_open_ref=-4),
    "blosum_linear": JaxParams(score_gap_read=-11, score_gap_ref=-11, matrix=jax_blosum62()),
    "blosum_affine": JaxParams(score_gap_read=-1, score_gap_ref=-1, gap_open_read=-11,
                               gap_open_ref=-11, matrix=jax_blosum62()),
}
_SETS = {k: (p, params_from_reference(dataclasses.asdict(p))) for k, p in _JAX_SETS.items()}

#: tests/test_banded.py's shapes (b, m, n), band, tile: n > m, n < m (the
#: band clamps left), n >> m (steps d > 1), and m % tile != 0.
_SCORE_SHAPES = [((6, 40, 56), 16, 8), ((5, 64, 32), 24, 16), ((4, 30, 90), 16, 10)]
_ALIGN_SHAPES = _SCORE_SHAPES + [((5, 30, 36), 12, 6), ((4, 10, 12), 10, 4)]

_FIELDS = ("read", "ref", "score", "cigar", "read_start", "read_end",
           "ref_start", "ref_end", "buffer_start", "buffer_end")


def _fields(a):
    return tuple(getattr(a, f) for f in _FIELDS)


def _codes(rng, pset, b, length):
    if _JAX_SETS[pset].matrix is None:
        return random_codes(rng, b, length, padded=True, n_prob=0.05)
    codes = rng.integers(1, 21, size=(b, length)).astype(np.uint8)
    codes = np.where(rng.random((b, length)) < 0.05, np.uint8(23), codes)
    lens = rng.integers(1, length + 1, size=b)
    return np.where(np.arange(length)[None, :] < lens[:, None], codes, np.uint8(0))


@pytest.mark.parametrize("pset", list(_SETS))
@pytest.mark.parametrize("algorithm", list(Algorithm))
@pytest.mark.parametrize("shape,band,tile", _SCORE_SHAPES)
def test_plain_score_matches_oracle(pset, algorithm, shape, band, tile):
    jp, p = _SETS[pset]
    b, m, n = shape
    rng = np.random.default_rng(m * n + band + 7 * int(algorithm))
    reads, refs = _codes(rng, pset, b, m), _codes(rng, pset, b, n)
    got = banded_score_batch(reads, refs, p, algorithm, band=band, tile=tile, device="cpu")
    m_pad = -(-m // tile) * tile
    offs = jax_banded.band_offsets(m_pad, m, n, min(band, n))
    padded = np.pad(reads, ((0, 0), (0, m_pad - m)))
    want = [jax_banded.banded_score_oracle(r, f, jp, min(band, n), JaxAlgorithm(int(algorithm)),
                                           offs) for r, f in zip(padded, refs)]
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pset", list(_SETS))
@pytest.mark.parametrize("tie", list(TieBreak))
@pytest.mark.parametrize("algorithm", list(Algorithm))
@pytest.mark.parametrize("shape,band,tile", _ALIGN_SHAPES)
def test_plain_align_matches_oracle(pset, tie, algorithm, shape, band, tile):
    jp, p = _SETS[pset]
    b, m, n = shape
    rng = np.random.default_rng(3 * m * n + band + 5 * int(algorithm) + int(tie))
    reads, refs = _codes(rng, pset, b, m), _codes(rng, pset, b, n)
    reads[0, 0] = 0   # mrp = -1: an empty NW alignment
    got = banded_align_batch(reads, refs, p, algorithm, band=band, tile=tile, tie=tie,
                             device="cpu")
    offs = jax_banded.band_offsets(m, m, n, min(band, n))
    want = [jax_banded.banded_align_oracle(r, f, jp, min(band, n), JaxAlgorithm(int(algorithm)),
                                           offs, tie=JaxTieBreak(int(tie)))
            for r, f in zip(reads, refs)]
    assert [_fields(g) for g in got] == [_fields(w) for w in want]


@pytest.fixture(scope="module")
def jax_runs():
    """The Pallas banded kernels in interpret mode, once per (algorithm, gap
    model) at one tiny shape with m % tile != 0; NW linear scores also at a
    second tile, SW linear alignments also at a second tile."""
    rng = np.random.default_rng(77)
    reads = random_codes(rng, 5, 30, padded=True, n_prob=0.05)
    refs = random_codes(rng, 5, 36, padded=True, n_prob=0.05)
    runs = {"reads": reads, "refs": refs}
    for pset in ("dna_linear", "dna_affine"):
        jp = _JAX_SETS[pset]
        for alg in JaxAlgorithm:
            tiles = (8, 16) if (pset, alg) == ("dna_linear", JaxAlgorithm.NEEDLEMAN_WUNSCH) else (8,)
            for tile in tiles:
                runs["score", pset, int(alg), tile] = jax_banded.banded_score_batch(
                    reads, refs, jp, alg, band=12, tile=tile, interpret=True)
            tiles = (4, 7) if (pset, alg) == ("dna_linear", JaxAlgorithm.SMITH_WATERMAN) else (4,)
            for tile in tiles:
                runs["align", pset, int(alg), tile] = jax_banded.banded_align_batch(
                    reads, refs, jp, alg, band=12, tile=tile, interpret=True)
    return runs


def test_score_matches_pallas_at_two_tiles(jax_runs):
    reads, refs = jax_runs["reads"], jax_runs["refs"]
    keys = [k for k in jax_runs if k[0] == "score"]
    assert len(keys) == 5
    for _, pset, alg, tile in keys:
        got = banded_score_batch(reads, refs, _SETS[pset][1], Algorithm(alg), band=12,
                                 tile=tile, device="cpu")
        np.testing.assert_array_equal(got, jax_runs["score", pset, alg, tile])


def test_align_matches_pallas_at_two_tiles(jax_runs):
    reads, refs = jax_runs["reads"], jax_runs["refs"]
    keys = [k for k in jax_runs if k[0] == "align"]
    assert len(keys) == 5
    for _, pset, alg, tile in keys:
        for port_tile in (4, 7):   # the port's tile changes nothing
            got = banded_align_batch(reads, refs, _SETS[pset][1], Algorithm(alg), band=12,
                                     tile=port_tile, device="cpu")
            assert [_fields(g) for g in got] == \
                [_fields(w) for w in jax_runs["align", pset, alg, tile]]


def test_nw_score_depends_on_tile_as_in_jax(jax_runs):
    """Padded rows are part of the NW score: the two tiles give what the
    JAX package gives at each, and the plain score over the padded rows is
    what the kernels compute."""
    reads, refs = jax_runs["reads"], jax_runs["refs"]
    p = _SETS["dna_linear"][1]
    for tile in (8, 16):
        m_pad = -(-30 // tile) * tile
        padded = torch.from_numpy(np.pad(reads, ((0, 0), (0, m_pad - 30))))
        got = plain_banded.banded_score(padded, torch.from_numpy(refs),
                                        band_offsets(m_pad, 30, 36, 12), p,
                                        Algorithm.NEEDLEMAN_WUNSCH, 12)
        np.testing.assert_array_equal(got.numpy(), jax_runs["score", "dna_linear", 1, tile])


@pytest.mark.parametrize("algorithm", list(Algorithm))
def test_full_band_equals_dense(algorithm):
    rng = np.random.default_rng(11 + int(algorithm))
    reads = random_codes(rng, 8, 24, padded=True, n_prob=0.1)
    refs = random_codes(rng, 8, 24, padded=True, n_prob=0.1)
    for pset in ("dna_linear", "dna_affine"):
        p = _SETS[pset][1]
        dense = AlignmentEngine(p, device="cpu").score_alignments(algorithm, reads, refs)
        np.testing.assert_array_equal(
            banded_score_batch(reads, refs, p, algorithm, band=24, tile=8, device="cpu"), dense)
    if algorithm == Algorithm.SMITH_WATERMAN:
        for pset in ("dna_linear", "dna_affine"):
            for tie in TieBreak:
                p = _SETS[pset][1]
                dense = AlignmentEngine(p, tie=tie, device="cpu").compute_alignments(
                    algorithm, reads, refs)
                got = banded_align_batch(reads, refs, p, algorithm, band=24, tie=tie,
                                         device="cpu")
                assert [_fields(g)[:4] for g in got] == [_fields(w)[:4] for w in dense]


def test_raw_and_rounds_match_objects():
    rng = np.random.default_rng(21)
    reads = random_codes(rng, 13, 16, padded=True, n_prob=0.05)
    refs = random_codes(rng, 13, 20, padded=True, n_prob=0.05)
    for pset in ("dna_linear", "dna_affine"):
        p = _SETS[pset][1]
        for alg in Algorithm:
            objs = banded_align_batch(reads, refs, p, alg, band=12, device="cpu")
            raw = banded_align_batch(reads, refs, p, alg, band=12, device="cpu", raw=True)
            rounds = banded_align_batch(reads, refs, p, alg, band=12, device="cpu", raw=True,
                                        chunk_pairs=4)
            cig = banded_align_batch(reads, refs, p, alg, band=12, device="cpu", raw=True,
                                     gapped=False, chunk_pairs=5)
            assert len(raw) == len(rounds) == 13
            assert [_fields(raw[k]) for k in range(13)] == [_fields(a) for a in objs]
            for col in ("meta", "cigar", "read_gapped", "ref_gapped"):
                np.testing.assert_array_equal(getattr(rounds, col), getattr(raw, col))
            assert cig.read_gapped is None and cig.ref_gapped is None
            np.testing.assert_array_equal(cig.meta, raw.meta)
            np.testing.assert_array_equal(cig.cigar, raw.cigar)


def test_empty_axes_and_device_walk():
    refs = np.ones((2, 4), np.uint8)
    p = _SETS["dna_linear"][1]
    for alg in Algorithm:
        jalg = JaxAlgorithm(int(alg))
        for r, f in ((np.zeros((2, 0), np.uint8), refs), (refs[:, :3].copy(),
                                                          np.zeros((2, 0), np.uint8))):
            got = banded_align_batch(r, f, p, alg, device="cpu")
            want = jax_banded.banded_align_batch(r, f, _JAX_SETS["dna_linear"], jalg,
                                                 interpret=True)
            assert [_fields(a) for a in got] == [_fields(a) for a in want]
            np.testing.assert_array_equal(banded_score_batch(r, f, p, alg, device="cpu"),
                                          np.zeros(2, np.int32))
    # The walk on the device (here the plain banded walk of ops/walk.py)
    # gives what the host walk gives, in every (algorithm, gap model).
    rng = np.random.default_rng(17)
    reads = random_codes(rng, 6, 30, padded=True, n_prob=0.05)
    refs36 = random_codes(rng, 6, 36, padded=True, n_prob=0.05)
    for name in ("dna_linear", "dna_affine"):
        for alg in Algorithm:
            args = (reads, refs36, _SETS[name][1], alg)
            walked = banded_align_batch(*args, band=12, device="cpu", device_walk=True)
            host = banded_align_batch(*args, band=12, device="cpu", device_walk=False)
            assert [_fields(a) for a in walked] == [_fields(a) for a in host]


def test_plans_and_rounds():
    # 16 kbp at band 512: 64 words a row, 4.1 MB a pair; a round holds at
    # most 2.25 GiB of words (589 pairs there), in whole waves of four pairs
    # per SM where a wave fits, and longer pairs get fewer pairs a round,
    # never more bytes.
    assert cuda_banded.lane_cols(512) == 16 and cuda_banded.lane_cols(333) == 16
    assert cuda_banded.lane_cols(12) == 8 and cuda_banded.lane_cols(257) == 16
    assert cuda_banded.CHUNK_PTR_BYTES == 9 << 28
    assert cuda_banded.chunk_pairs_for(16000, 512, 132) == 528
    assert cuda_banded.chunk_pairs_for(16000, 512, 1) == 588
    for m, band in ((16000, 512), (100_000, 512), (100_000, 100_000)):
        pairs = cuda_banded.chunk_pairs_for(m, band, 132)
        assert pairs * 4 * m * -(-band // 8) <= cuda_banded.CHUNK_PTR_BYTES or pairs == 1
    assert cuda_banded.chunk_pairs_for(100_000, 512, 132) == 94
    assert cuda_banded.chunk_pairs_for(100_000, 100_000, 132) == 1
    p = _SETS["dna_linear"][1]
    assert cuda_banded.rows_in_shared(512, p)
    assert not cuda_banded.rows_in_shared(16000, p)
    # The refs are copied with 16 bytes of padding; rows in device memory
    # are 34 words a slot and 505 slots (csrc/banded.cuh) at 16000.
    # The align plan counts the walk's records, start outputs and mxp too.
    plan = cuda_banded.banded_mem_plan(100, 120, 64, 10, p)
    assert plan == 10 * (100 + 2 * 120 + 4 * 100 * 8 + 16 + 4 * 64 + 4 + 4 * 100 + 16) \
        + 400 + 16
    wide = cuda_banded.banded_mem_plan(100, 16000, 16000, 10, p, "score")
    assert wide == 10 * (100 + 2 * 16000 + 4 * 2 * 34 * 505 + 4) + 400 + 16


@pytest.mark.parametrize("name", ["banded_smith_waterman", "banded_needleman_wunsch"])
def test_banded_models_match_jax(name):
    rng = np.random.default_rng(5)
    reads = random_codes(rng, 4, 20, padded=True, n_prob=0.05)
    refs = random_codes(rng, 4, 26, padded=True, n_prob=0.05)
    ours = getattr(models, name)(band=10, tile=8)
    theirs = getattr(jax_models, name)(band=10, tile=8)
    assert ours.banded and (ours.band, ours.band_tile) == (10, 8)
    np.testing.assert_array_equal(ours.score(reads, refs, device="cpu"), theirs.score(reads, refs))
    assert [_fields(a) for a in ours.align(reads, refs, device="cpu")] == \
        [_fields(a) for a in theirs.align(reads, refs)]


def test_dense_models_match_jax():
    rng = np.random.default_rng(6)
    reads = random_codes(rng, 6, 14, padded=True, n_prob=0.05)
    refs = random_codes(rng, 6, 17, padded=True, n_prob=0.05)
    for name in ("smith_waterman", "needleman_wunsch", "affine_smith_waterman",
                 "affine_needleman_wunsch"):
        ours, theirs = getattr(models, name)(), getattr(jax_models, name)()
        assert dataclasses.asdict(ours.params) == dataclasses.asdict(theirs.params)
        np.testing.assert_array_equal(ours.score(reads, refs, device="cpu"),
                                      theirs.score(reads, refs, backend="xla"))
        assert [_fields(a) for a in ours.align(reads, refs, device="cpu")] == \
            [_fields(a) for a in theirs.align(reads, refs, backend="xla")]
    prot = models.protein_smith_waterman()
    assert prot.alphabet == jax_models.protein_smith_waterman().alphabet
    seqs = ["MKVLAAGW", "HEAGAWGHEE"]
    np.testing.assert_array_equal(prot.score(seqs, seqs[::-1], device="cpu"),
                                  jax_models.protein_smith_waterman().score(
                                      seqs, seqs[::-1], backend="xla"))
    for name in ("smith_waterman", "affine_needleman_wunsch"):
        model = getattr(models, name)()
        walked = dataclasses.replace(model, device_walk=True).align(reads, refs, device="cpu")
        assert [_fields(a) for a in walked] == \
            [_fields(a) for a in model.align(reads, refs, device="cpu")]
    with pytest.raises(KeyError):
        models.smith_waterman().score(reads, refs, backend="pallas", device="cpu")


def test_affine_full_band_equals_gotoh():
    rng = np.random.default_rng(9)
    reads = random_codes(rng, 5, 18)
    refs = random_codes(rng, 5, 18)
    jp, p = _SETS["dna_affine"]
    got = banded_align_batch(reads, refs, p, Algorithm.SMITH_WATERMAN, band=18, device="cpu")
    want = [gotoh.sw_align_affine(r, f, jp) for r, f in zip(reads, refs)]
    assert [_fields(g)[:4] for g in got] == [_fields(w)[:4] for w in want]
    np.testing.assert_array_equal(
        banded_score_batch(reads, refs, p, Algorithm.NEEDLEMAN_WUNSCH, band=18, device="cpu"),
        gotoh.score_alignments_affine(JaxAlgorithm.NEEDLEMAN_WUNSCH, reads, refs, jp))


def test_band_helpers_match_jax():
    from versalignlib_tpu_torch.alphabet import make_validity
    from versalignlib_tpu_torch.ops import banded

    for m_pad, m, n, band in ((64, 60, 56, 16), (32, 30, 90, 16), (16, 10, 12, 10),
                              (16128, 16000, 16000, 512), (8, 0, 5, 5)):
        np.testing.assert_array_equal(banded.band_offsets(m_pad, m, n, band),
                                      jax_banded.band_offsets(m_pad, m, n, band))
        assert banded.max_band_step(m, n) == jax_banded.max_band_step(m, n)
        # The offsets' own step, which sizes the kernels' rows, within it.
        assert plain_banded.max_step(banded.band_offsets(m_pad, m, n, band)) <= \
            banded.max_band_step(m, n)
    for codes in (np.array([1, 2, 0, 3]), np.array([5, 5, 1]), np.array([0, 1]), np.zeros(0)):
        assert banded.last_valid_pos(codes) == jax_banded.last_valid_pos(codes)
        v = make_validity()
        assert banded.last_valid_pos(codes, v) == jax_banded.last_valid_pos(codes, v)
