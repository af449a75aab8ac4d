"""The plain PyTorch version of ``csrc/align.cu`` against the JAX package's
Pallas align kernel (``_align_blocks``) in interpret mode, word for word:
packed pointer words of every real row, the aux word and ``hsel``."""

import numpy as np
import pytest
import torch

from tests.conftest import random_codes
from versalignlib_tpu.ops.pallas_align import (
    ALIGN_WAVE_ROWS,
    _align_blocks,
    _last_valid_pos,
    _pack_blocks,
    _pack_vec,
    _unpack_pairs,
)
from versalignlib_tpu.params import DEFAULT_PARAMETERS as JAX_PARAMS
from versalignlib_tpu.types import Algorithm as JaxAlgorithm
from versalignlib_tpu.types import TieBreak as JaxTieBreak
from versalignlib_tpu_torch.ops import cuda_align, plain
from versalignlib_tpu_torch.params import DEFAULT_PARAMETERS
from versalignlib_tpu_torch.types import Algorithm, TieBreak

B, M = 20, 10


def _jax_fill(reads, refs, algorithm, tie):
    m, n = reads.shape[1], refs.shape[1]
    m_pad = -(-m // ALIGN_WAVE_ROWS) * ALIGN_WAVE_ROWS
    jt = JaxTieBreak(int(tie))
    mrp = _last_valid_pos(reads, jt)
    out = _align_blocks(
        _pack_blocks(np.pad(reads, ((0, 0), (0, m_pad - m))), 1, m_pad),
        _pack_blocks(refs, 1, n), _pack_vec(mrp, 1), JAX_PARAMS,
        JaxAlgorithm(int(algorithm)), jt, True)
    ptr, aux, hsel = (None if x is None else _unpack_pairs(x, 1)[:len(reads)]
                      for x in out)
    return ptr[:, :m], aux, hsel


# Each (algorithm, flavor) cell takes one n, and every n is taken once; in
# the canonical flavor, n = 7 and 21 leave a partial last pointer word whose
# unfilled fields must read START.
_CASES = [
    (Algorithm.SMITH_WATERMAN, TieBreak.DIAG_UP_LEFT, 21),
    (Algorithm.SMITH_WATERMAN, TieBreak.DIAG_LEFT_UP, 16),
    (Algorithm.NEEDLEMAN_WUNSCH, TieBreak.DIAG_UP_LEFT, 7),
    (Algorithm.NEEDLEMAN_WUNSCH, TieBreak.DIAG_LEFT_UP, 33),
]


@pytest.mark.parametrize("algorithm,tie,n", _CASES)
def test_plain_fill_matches_pallas_word_for_word(algorithm, tie, n):
    rng = np.random.default_rng(200 + n + 50 * int(algorithm) + 7 * int(tie))
    reads = random_codes(rng, B, M, padded=True, n_prob=0.1)
    refs = random_codes(rng, B, n, padded=True, n_prob=0.1)
    reads[0, 0] = 0   # a read that starts invalid: mrp = -1 in both flavors
    reads[1, :] = 5   # all N: valid in the canonical flavor only
    mrp = torch.from_numpy(cuda_align.last_valid_pos(reads, tie))
    ptr, aux, hsel = plain.align_batch(torch.from_numpy(reads), torch.from_numpy(refs),
                                       mrp, DEFAULT_PARAMETERS, algorithm, tie)
    want_ptr, want_aux, want_hsel = _jax_fill(reads, refs, algorithm, tie)
    assert ptr.dtype == aux.dtype == torch.int32
    assert ptr.shape == (B, M, -(-n // 16))
    np.testing.assert_array_equal(ptr.numpy(), want_ptr)
    np.testing.assert_array_equal(aux.numpy(), want_aux)
    if algorithm == Algorithm.SMITH_WATERMAN:
        assert hsel is None and want_hsel is None
    else:
        assert hsel.shape == (B, n + 1)
        np.testing.assert_array_equal(hsel.numpy(), want_hsel)


@pytest.mark.parametrize("tie", list(TieBreak))
def test_last_valid_pos_matches(tie):
    rng = np.random.default_rng(3)
    codes = random_codes(rng, 40, 12, padded=True, n_prob=0.2)
    codes[0] = 0
    np.testing.assert_array_equal(
        cuda_align.last_valid_pos(codes, tie),
        _last_valid_pos(codes, JaxTieBreak(int(tie))))


def test_pack_words_layout():
    codes = torch.tensor([[0, 1, 2, 3, 3, 2, 1, 0, 3, 3, 3, 3, 3, 3, 3, 3, 1, 2]])
    words = plain.pack_words(codes)
    assert words.shape == (1, 2) and words.dtype == torch.int32
    w = [int(x) & 0xFFFFFFFF for x in words[0]]
    got = [(w[j // 16] >> (2 * (j % 16))) & 3 for j in range(18)]
    assert got == codes[0].tolist()
    assert w[1] >> 4 == 0  # unfilled fields of the partial word are START


def test_chunk_pairs_follow_the_memory_budget():
    assert cuda_align.chunk_pairs_for(512, 512, 1) == 4096
    assert 4096 * 512 * 32 * 4 == cuda_align.CHUNK_PTR_BYTES
    # never fewer than 16 warps (one pair each) per SM
    assert cuda_align.chunk_pairs_for(512, 512, 132) == 4096
    assert cuda_align.chunk_pairs_for(100000, 100000, 1) == 16
    assert cuda_align.chunk_pairs_for(100000, 100000, 132) == 16 * 132
    assert cuda_align.chunk_pairs_for(150, 509, 132) % cuda_align.FILL_WARPS == 0
    # Past one stripe of 512 columns, two boundary columns of H per pair.
    assert cuda_align.align_mem_plan(150, 1536, 8) - cuda_align.align_mem_plan(150, 512, 8) \
        == 8 * (1024 + 4 * 150 * (96 - 32) + 4 * 1024 + 4 * 2 * 150)


def test_large_dna_scores_fill_as_their_matrix():
    # DNA scores past the fills' byte tables go to the kernel as the 6 x 6
    # matrix; under it the plain fill gives the same words, aux and hsel.
    from versalignlib_tpu_torch.alphabet import base_score_matrix
    from versalignlib_tpu_torch.params import AlignmentParameters

    assert cuda_align.dna_fits_bytes(DEFAULT_PARAMETERS)
    assert cuda_align.dna_fits_bytes(AlignmentParameters(score_match=31, score_mismatch=-32))
    assert not cuda_align.dna_fits_bytes(AlignmentParameters(score_match=32))
    assert not cuda_align.dna_fits_bytes(AlignmentParameters(score_mismatch=-33))
    rng = np.random.default_rng(9)
    reads = torch.from_numpy(random_codes(rng, B, M, padded=True, n_prob=0.1))
    refs = torch.from_numpy(random_codes(rng, B, 23, padded=True, n_prob=0.1))
    for gaps in ({"score_gap_read": -50, "score_gap_ref": -45},
                 {"score_gap_read": -10, "score_gap_ref": -15, "gap_open_read": -60,
                  "gap_open_ref": -50}):
        dna = AlignmentParameters(score_match=40, score_mismatch=-35, **gaps)
        as_matrix = AlignmentParameters(score_match=40, score_mismatch=-35, **gaps,
                                        matrix=tuple(map(tuple, base_score_matrix(40, -35).tolist())))
        fill = plain.align_affine_batch if dna.affine else plain.align_batch
        for tie in TieBreak:
            mrp = torch.from_numpy(cuda_align.last_valid_pos(reads.numpy(), tie))
            for alg in Algorithm:
                for got, want in zip(fill(reads, refs, mrp, as_matrix, alg, tie),
                                     fill(reads, refs, mrp, dna, alg, tie)):
                    assert (got is None) == (want is None)
                    if got is not None:
                        assert torch.equal(got, want), (gaps, tie, alg)
