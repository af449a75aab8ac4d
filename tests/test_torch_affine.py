"""Affine (Gotoh) gaps in the port against the JAX package, with ``==``:
the plain version of ``csrc/align_affine.cu`` word for word against the
Pallas affine align kernel (``_affine_align_blocks``, interpret mode), the
affine branch of the plain score against the Pallas score kernel and XLA,
and the slice through ``AlignmentEngine(device="cpu")`` against
``ops/gotoh.py`` and the XLA backend."""

import dataclasses

import numpy as np
import pytest
import torch

from tests.conftest import random_codes
from versalignlib_tpu import AlignmentEngine as JaxEngine
from versalignlib_tpu.ops import gotoh, xla
from versalignlib_tpu.ops.pallas_align import (
    ALIGN_WAVE_ROWS,
    _affine_align_blocks,
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
from versalignlib_tpu_torch.ops import cuda_align, plain
from versalignlib_tpu_torch.types import Algorithm, TieBreak

#: BWA-MEM's defaults -A1 -B4 -O6 -E1, the slice's DNA parameter set.
JAX_BWAMEM = JaxParams(score_match=1, score_mismatch=-4, score_gap_read=-1,
                       score_gap_ref=-1, gap_open_read=-6, gap_open_ref=-6)
#: Unequal read and ref gap costs, so a swap of the two shows.
JAX_SKEWED = JaxParams(score_match=2, score_mismatch=-3, score_gap_read=-1,
                       score_gap_ref=-2, gap_open_read=-4, gap_open_ref=-3)
BWAMEM = params_from_reference(dataclasses.asdict(JAX_BWAMEM))
SKEWED = params_from_reference(dataclasses.asdict(JAX_SKEWED))

_FIELDS = ("read", "ref", "score", "cigar", "read_start", "read_end",
           "ref_start", "ref_end", "buffer_start", "buffer_end")


def _fields(a):
    return tuple(getattr(a, f) for f in _FIELDS)


def jax_affine_fill(reads, refs, jax_params, algorithm, tie):
    """The Pallas affine fill in interpret mode, unpacked to (pair, ...) as
    ``_decode_affine_chunk`` unpacks it: ptr words of the real rows, aux,
    hsel (None for SW)."""
    m, n = reads.shape[1], refs.shape[1]
    m_pad = -(-m // ALIGN_WAVE_ROWS) * ALIGN_WAVE_ROWS
    jt = JaxTieBreak(int(tie))
    mrp = _last_valid_pos(reads, jt, jax_params.matrix)
    out = _affine_align_blocks(
        _pack_blocks(np.pad(reads, ((0, 0), (0, m_pad - m))), 1, m_pad),
        _pack_blocks(refs, 1, n), _pack_vec(mrp, 1), jax_params,
        JaxAlgorithm(int(algorithm)), jt, True)
    ptr, aux, hsel = (None if x is None else _unpack_pairs(x, 1)[:len(reads)]
                      for x in out)
    return ptr[:, :m], aux, hsel


def assert_fill_equal(got, want, n):
    ptr, aux, hsel = got
    want_ptr, want_aux, want_hsel = want
    assert ptr.dtype == aux.dtype == torch.int32
    np.testing.assert_array_equal(ptr.numpy(), want_ptr)
    np.testing.assert_array_equal(aux.numpy(), want_aux)
    if want_hsel is None:
        assert hsel is None
    else:
        assert hsel.shape == (len(aux), n + 1)
        np.testing.assert_array_equal(hsel.numpy(), want_hsel)


# One Pallas interpreter run per (algorithm, flavor) cell; n = 7, 13 and 17
# leave a partial last pointer word of 8 fields, n = 16 fills both words.
_CASES = [
    (Algorithm.SMITH_WATERMAN, TieBreak.DIAG_UP_LEFT, 13, "bwamem"),
    (Algorithm.SMITH_WATERMAN, TieBreak.DIAG_LEFT_UP, 16, "skewed"),
    (Algorithm.NEEDLEMAN_WUNSCH, TieBreak.DIAG_UP_LEFT, 7, "skewed"),
    (Algorithm.NEEDLEMAN_WUNSCH, TieBreak.DIAG_LEFT_UP, 17, "bwamem"),
]


@pytest.mark.parametrize("algorithm,tie,n,pset", _CASES)
def test_plain_affine_fill_matches_pallas_word_for_word(algorithm, tie, n, pset):
    jax_params, params = {"bwamem": (JAX_BWAMEM, BWAMEM),
                          "skewed": (JAX_SKEWED, SKEWED)}[pset]
    rng = np.random.default_rng(400 + n + 50 * int(algorithm) + 7 * int(tie))
    reads = random_codes(rng, 14, 10, padded=True, n_prob=0.1)
    refs = random_codes(rng, 14, n, padded=True, n_prob=0.1)
    reads[0, 0] = 0   # a read that starts invalid: mrp = -1 in both flavors
    reads[1, :] = 5   # all N: valid in the canonical flavor only
    mrp = torch.from_numpy(cuda_align.last_valid_pos(reads, tie))
    got = plain.align_affine_batch(torch.from_numpy(reads), torch.from_numpy(refs),
                                   mrp, params, algorithm, tie)
    assert got[0].shape == (14, 10, -(-n // 8))
    assert_fill_equal(got, jax_affine_fill(reads, refs, jax_params, algorithm, tie), n)


@pytest.mark.parametrize("algorithm", list(Algorithm))
def test_plain_affine_score_matches_pallas_xla_and_gotoh(algorithm):
    rng = np.random.default_rng(41 + int(algorithm))
    reads = random_codes(rng, 20, 15, padded=True, n_prob=0.1)
    refs = random_codes(rng, 20, 11, padded=True, n_prob=0.1)
    jalg = JaxAlgorithm(int(algorithm))
    got = plain.score_batch(torch.from_numpy(reads), torch.from_numpy(refs),
                            SKEWED, algorithm).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_score_device(reads, refs, JAX_SKEWED, jalg, True)))
    np.testing.assert_array_equal(got, np.asarray(xla.score_batch(reads, refs, JAX_SKEWED, jalg)))
    np.testing.assert_array_equal(
        got, gotoh.score_alignments_affine(jalg, reads, refs, JAX_SKEWED))


@pytest.mark.parametrize("tie", list(TieBreak))
def test_engine_affine_slice_matches_gotoh_and_xla(tie):
    rng = np.random.default_rng(45 + int(tie))
    reads = random_codes(rng, 32, 24, padded=True, n_prob=0.05)
    refs = random_codes(rng, 32, 30, padded=True, n_prob=0.05)
    reads[0, 0] = 0
    engine = AlignmentEngine(BWAMEM, tie=tie, device="cpu")
    jtie = JaxTieBreak(int(tie))
    for algorithm in Algorithm:
        jalg = JaxAlgorithm(int(algorithm))
        scores = engine.score_alignments(algorithm, reads, refs)
        np.testing.assert_array_equal(
            scores, gotoh.score_alignments_affine(jalg, reads, refs, JAX_BWAMEM))
        np.testing.assert_array_equal(
            scores, xla.XLABackend().score_alignments(jalg, reads, refs, JAX_BWAMEM))

        want = gotoh.compute_alignments_affine(jalg, reads, refs, JAX_BWAMEM, jtie)
        want_xla = xla.XLABackend().compute_alignments(jalg, reads, refs, JAX_BWAMEM, jtie)
        got = engine.compute_alignments(algorithm, reads, refs)
        raw = engine.compute_alignments(algorithm, reads, refs, raw=True)
        assert len(got) == len(raw) == 32
        for k, (g, r, w, wx) in enumerate(zip(got, raw, want, want_xla)):
            assert _fields(g) == _fields(r) == _fields(w) == _fields(wx), (algorithm, k)
        cig = engine.compute_alignments(algorithm, reads, refs, raw=True, gapped=False)
        assert cig.read_gapped is None
        np.testing.assert_array_equal(cig.meta, raw.meta)
        np.testing.assert_array_equal(cig.cigar, raw.cigar)


def test_affine_chunks_at_pack_8():
    # 4 bytes per 8 cells: 4096 pairs of 512 x 512 are 512 MiB of pointer
    # words, twice the chunk budget of 2048 pairs; 16 warps (one pair each)
    # on each of 132 SMs are 2112 pairs, so the main path's 4096 pairs fill
    # in two chunks.
    assert 4096 * 512 * 64 * 4 == 2 * cuda_align.CHUNK_PTR_BYTES
    assert cuda_align.chunk_pairs_for(512, 512, 132, cuda_align.AFFINE_PACK) == 2112
    assert cuda_align.chunk_pairs_for(512, 512, 1, cuda_align.AFFINE_PACK) == 2048
    assert cuda_align.chunk_pairs_for(512, 512, 1) == 4096
    linear = cuda_align.align_mem_plan(512, 509, 32)
    affine = cuda_align.align_mem_plan(512, 509, 32, affine=True)
    # 64 words of 8 codes instead of 32 of 16 per row; one stripe, so no
    # boundary columns (H, and E when affine).
    assert affine - linear == 32 * (4 * 512 * (64 - 32))
    wide = cuda_align.align_mem_plan(512, 1100, 32, affine=True)
    assert wide - cuda_align.align_mem_plan(512, 1100, 32) == \
        32 * (4 * 512 * (138 - 69) + 4 * 2 * 512)

    # Several chunks, the next dispatched before the previous is decoded,
    # give what one chunk gives.
    rng = np.random.default_rng(6)
    r = random_codes(rng, 11, 9, padded=True, n_prob=0.05)
    f = random_codes(rng, 11, 12, padded=True, n_prob=0.05)
    for alg in Algorithm:
        whole = cuda_align.align_batch(r, f, BWAMEM, alg, device="cpu", raw=True)
        parts = cuda_align.align_batch(r, f, BWAMEM, alg, device="cpu", raw=True,
                                       chunk_pairs=4)
        np.testing.assert_array_equal(whole.meta, parts.meta)
        np.testing.assert_array_equal(whole.read_gapped, parts.read_gapped)


def test_affine_empty_axes_match_jax():
    refs = np.ones((2, 4), np.uint8)
    for reads, f in ((np.zeros((2, 0), np.uint8), refs),
                     (refs[:, :3].copy(), np.zeros((2, 0), np.uint8))):
        for alg in Algorithm:
            jalg = JaxAlgorithm(int(alg))
            engine = AlignmentEngine(BWAMEM, device="cpu")
            theirs = JaxEngine(JAX_BWAMEM, backend="pallas")
            got = engine.compute_alignments(alg, reads, f)
            want = theirs.compute_alignments(jalg, reads, f)
            assert [_fields(a) for a in got] == [_fields(a) for a in want]
            np.testing.assert_array_equal(engine.score_alignments(alg, reads, f),
                                          theirs.score_alignments(jalg, reads, f))
