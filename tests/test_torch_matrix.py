"""S x S substitution matrices in the port against the JAX package, with
``==``: the matrix branches of the plain score, linear fill and affine fill
against one Pallas interpreter run each and against XLA and the numpy
oracles; BLOSUM62 protein alignment through ``AlignmentEngine(device="cpu")``
against the XLA backend; and the port's copies of the protein alphabet and
BLOSUM62 against the originals."""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_affine import assert_fill_equal, jax_affine_fill
from versalignlib_tpu import AlignmentEngine as JaxEngine
from versalignlib_tpu import alphabet as jax_alphabet
from versalignlib_tpu.ops import gotoh, oracle, xla
from versalignlib_tpu.ops.pallas_align import (
    ALIGN_WAVE_ROWS,
    _align_blocks,
    _last_valid_pos,
    _pack_blocks,
    _pack_vec,
    _unpack_pairs,
)
from versalignlib_tpu.ops.pallas_score import score_batch_device as jax_score_device
from versalignlib_tpu.params import AlignmentParameters as JaxParams
from versalignlib_tpu.types import Algorithm as JaxAlgorithm
from versalignlib_tpu.types import TieBreak as JaxTieBreak
from versalignlib_tpu_torch import AlignmentEngine, params_from_reference
from versalignlib_tpu_torch import alphabet
from versalignlib_tpu_torch.ops import cuda_align, plain
from versalignlib_tpu_torch.types import Algorithm, TieBreak

_FIELDS = ("read", "ref", "score", "cigar", "read_start", "read_end",
           "ref_start", "ref_end", "buffer_start", "buffer_end")


def _fields(a):
    return tuple(getattr(a, f) for f in _FIELDS)


def _random_matrix(rng, s):
    """Asymmetric, with zero padding row and column (tests/test_matrix.py)
    and an interior all-zero code 4, which the SSE flavor counts invalid."""
    m = rng.integers(-4, 5, size=(s, s))
    np.fill_diagonal(m, rng.integers(3, 7, size=s))
    m[0, :] = m[:, 0] = 0
    m[4, :] = m[:, 4] = 0
    return tuple(tuple(int(v) for v in row) for row in m)


_MAT = _random_matrix(np.random.default_rng(17), 7)
JAX_LINEAR = JaxParams(score_gap_read=-3, score_gap_ref=-2, matrix=_MAT)
JAX_AFFINE = JaxParams(score_gap_read=-1, score_gap_ref=-2, gap_open_read=-3,
                       gap_open_ref=-4, matrix=_MAT)
JAX_BLOSUM_AFFINE = JaxParams(score_gap_read=-1, score_gap_ref=-1, gap_open_read=-11,
                              gap_open_ref=-11, matrix=jax_alphabet.blosum62())
JAX_BLOSUM_LINEAR = JaxParams(score_gap_read=-11, score_gap_ref=-11,
                              matrix=jax_alphabet.blosum62())
LINEAR, AFFINE, BLOSUM_AFFINE, BLOSUM_LINEAR = (
    params_from_reference(dataclasses.asdict(p))
    for p in (JAX_LINEAR, JAX_AFFINE, JAX_BLOSUM_AFFINE, JAX_BLOSUM_LINEAR))


def _codes(rng, b, length, s=7):
    """Codes 1..S+2, so some lie outside the matrix (score 0, invalid), with
    random trailing padding."""
    codes = rng.integers(1, s + 3, size=(b, length)).astype(np.uint8)
    lens = rng.integers(1, length + 1, size=b)
    return np.where(np.arange(length)[None, :] < lens[:, None], codes, 0).astype(np.uint8)


def _jax_linear_fill(reads, refs, jax_params, algorithm, tie):
    m, n = reads.shape[1], refs.shape[1]
    m_pad = -(-m // ALIGN_WAVE_ROWS) * ALIGN_WAVE_ROWS
    jt = JaxTieBreak(int(tie))
    out = _align_blocks(
        _pack_blocks(np.pad(reads, ((0, 0), (0, m_pad - m))), 1, m_pad),
        _pack_blocks(refs, 1, n), _pack_vec(_last_valid_pos(reads, jt, jax_params.matrix), 1),
        jax_params, JaxAlgorithm(int(algorithm)), jt, True)
    ptr, aux, hsel = (None if x is None else _unpack_pairs(x, 1)[:len(reads)]
                      for x in out)
    return ptr[:, :m], aux, hsel


def test_matrix_score_matches_pallas_xla_and_oracles():
    rng = np.random.default_rng(51)
    reads, refs = _codes(rng, 18, 12), _codes(rng, 18, 9)
    for jax_params, params, ref_fn in (
            (JAX_LINEAR, LINEAR, oracle.score_alignments),
            (JAX_AFFINE, AFFINE, gotoh.score_alignments_affine)):
        for algorithm in Algorithm:
            jalg = JaxAlgorithm(int(algorithm))
            got = plain.score_batch(torch.from_numpy(reads), torch.from_numpy(refs),
                                    params, algorithm).numpy()
            np.testing.assert_array_equal(got, np.asarray(
                xla.score_batch(reads, refs, jax_params, jalg)))
            np.testing.assert_array_equal(got, ref_fn(jalg, reads, refs, jax_params))
    # One Pallas interpreter run: the bit-packed matrix lookup, affine, SW.
    got = plain.score_batch(torch.from_numpy(reads), torch.from_numpy(refs), AFFINE,
                            Algorithm.SMITH_WATERMAN).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_score_device(
        reads, refs, JAX_AFFINE, JaxAlgorithm.SMITH_WATERMAN, True)))


@pytest.mark.parametrize("affine", [False, True])
def test_matrix_fills_match_pallas_word_for_word(affine):
    """Linear fill NW in the SSE flavor (the matrix-aware DIAG gate) and
    affine fill SW in the SSE flavor, one Pallas interpreter run each."""
    rng = np.random.default_rng(52 + affine)
    reads, refs = _codes(rng, 14, 10), _codes(rng, 14, 13)
    reads[0, 0] = 4   # starts with the score-invalid code: mrp = -1 (SSE)
    tie = TieBreak.DIAG_LEFT_UP
    mrp = torch.from_numpy(cuda_align.last_valid_pos(reads, tie, _MAT))
    args = (torch.from_numpy(reads), torch.from_numpy(refs), mrp)
    if affine:
        alg = Algorithm.SMITH_WATERMAN
        got = plain.align_affine_batch(*args, AFFINE, alg, tie)
        want = jax_affine_fill(reads, refs, JAX_AFFINE, alg, tie)
    else:
        alg = Algorithm.NEEDLEMAN_WUNSCH
        got = plain.align_batch(*args, LINEAR, alg, tie)
        want = _jax_linear_fill(reads, refs, JAX_LINEAR, alg, tie)
    assert_fill_equal(got, want, refs.shape[1])


@pytest.mark.parametrize("tie", list(TieBreak))
def test_matrix_engine_matches_oracles_and_xla(tie):
    rng = np.random.default_rng(54 + int(tie))
    reads, refs = _codes(rng, 16, 11), _codes(rng, 16, 14)
    jtie = JaxTieBreak(int(tie))
    for jax_params, params, ref_fn in (
            (JAX_LINEAR, LINEAR, oracle.compute_alignments),
            (JAX_AFFINE, AFFINE, gotoh.compute_alignments_affine)):
        engine = AlignmentEngine(params, tie=tie, device="cpu")
        for algorithm in Algorithm:
            jalg = JaxAlgorithm(int(algorithm))
            got = engine.compute_alignments(algorithm, reads, refs)
            raw = engine.compute_alignments(algorithm, reads, refs, raw=True)
            want = ref_fn(jalg, reads, refs, jax_params, jtie)
            want_xla = xla.XLABackend().compute_alignments(jalg, reads, refs, jax_params, jtie)
            for k, (g, r, w, wx) in enumerate(zip(got, raw, want, want_xla)):
                assert _fields(g) == _fields(r) == _fields(w) == _fields(wx), (algorithm, k)


def _peptides(rng, b, length):
    """Random peptides over all of PROTEIN_ALPHABET (X, B, Z and * too) and
    a few unknown letters, of random lengths."""
    letters = alphabet.PROTEIN_ALPHABET + "JOU"
    return ["".join(rng.choice(list(letters), size=rng.integers(1, length + 1)))
            for _ in range(b)]


@pytest.mark.parametrize("name", ["blosum62_affine", "blosum62_linear"])
def test_blosum62_engine_matches_xla(name):
    jax_params, params = {"blosum62_affine": (JAX_BLOSUM_AFFINE, BLOSUM_AFFINE),
                          "blosum62_linear": (JAX_BLOSUM_LINEAR, BLOSUM_LINEAR)}[name]
    rng = np.random.default_rng(56 + len(name))
    reads = alphabet.encode_custom(_peptides(rng, 24, 20), alphabet.PROTEIN_ALPHABET)
    refs = alphabet.encode_custom(_peptides(rng, 24, 26), alphabet.PROTEIN_ALPHABET)
    be = xla.XLABackend()
    for tie in TieBreak:
        engine = AlignmentEngine(params, tie=tie, device="cpu")
        for algorithm in Algorithm:
            jalg = JaxAlgorithm(int(algorithm))
            np.testing.assert_array_equal(
                engine.score_alignments(algorithm, reads, refs),
                be.score_alignments(jalg, reads, refs, jax_params))
            want = be.compute_alignments(jalg, reads, refs, jax_params, JaxTieBreak(int(tie)))
            raw = engine.compute_alignments(algorithm, reads, refs, raw=True)
            assert [_fields(a) for a in raw] == [_fields(a) for a in want]


@pytest.mark.parametrize("tie", list(TieBreak))
def test_last_valid_pos_with_a_matrix_matches(tie):
    rng = np.random.default_rng(58)
    codes = _codes(rng, 30, 12)
    codes[0, 0] = 4
    np.testing.assert_array_equal(
        cuda_align.last_valid_pos(codes, tie, _MAT),
        _last_valid_pos(codes, JaxTieBreak(int(tie)), _MAT))


def test_protein_copies_match():
    assert alphabet.PROTEIN_ALPHABET == jax_alphabet.PROTEIN_ALPHABET
    assert alphabet.blosum62() == jax_alphabet.blosum62()
    seqs = ["MKTWQERLLA", "mktw*xbz", "", "ACDEFGHIKLMNPQRSTVWY", b"JOU-x"]
    for kw in ({}, {"length": 24}, {"case_sensitive": True}):
        np.testing.assert_array_equal(
            alphabet.encode_custom(seqs, alphabet.PROTEIN_ALPHABET, **kw),
            jax_alphabet.encode_custom(seqs, jax_alphabet.PROTEIN_ALPHABET, **kw))
    with pytest.raises(ValueError):
        alphabet.encode_custom(["MKTW"], alphabet.PROTEIN_ALPHABET, length=2)


def test_matrix_parameters_cross_from_jax():
    for jax_params, params in ((JAX_BLOSUM_AFFINE, BLOSUM_AFFINE),
                               (JAX_BLOSUM_LINEAR, BLOSUM_LINEAR),
                               (JAX_AFFINE, AFFINE)):
        assert dataclasses.asdict(params) == dataclasses.asdict(jax_params)
        assert (params.affine, params.sub_size) == (jax_params.affine, jax_params.sub_size)


def test_matrix_empty_axes_match_jax():
    reads = np.zeros((2, 0), np.uint8)
    refs = np.full((2, 4), 3, np.uint8)
    for jax_params, params in ((JAX_BLOSUM_LINEAR, BLOSUM_LINEAR),
                               (JAX_BLOSUM_AFFINE, BLOSUM_AFFINE)):
        for alg in Algorithm:
            got = AlignmentEngine(params, device="cpu").compute_alignments(alg, reads, refs)
            want = JaxEngine(jax_params, backend="pallas").compute_alignments(
                JaxAlgorithm(int(alg)), reads, refs)
            assert [_fields(a) for a in got] == [_fields(a) for a in want]
