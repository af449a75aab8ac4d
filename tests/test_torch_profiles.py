"""Profiles and hit statistics in the port against the JAX package: the
plain profile scores against the Pallas search kernel in PSSM mode
(interpret mode) and the numpy oracles, ``profile_search`` (hits,
alignments, calibration), ``calibrate`` and the rest of ``stats`` on the
CPU, field by field (translated search: tests/test_torch_translate.py).
Inputs come from a seeded numpy generator; tolerance 0 on every integer, and
equality on every float (the same numpy arithmetic on the same scores)."""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_search import _jp, _same_alignments
from versalignlib_tpu import stats as jax_stats
from versalignlib_tpu.ops import pssm as jax_pssm
from versalignlib_tpu.types import Algorithm as JaxAlgorithm
from versalignlib_tpu_torch import stats
from versalignlib_tpu_torch.alphabet import blosum62
from versalignlib_tpu_torch.ops import cuda_search, plain, pssm
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm

LINEAR = AlignmentParameters()
AFFINE = AlignmentParameters(gap_open_read=-4, gap_open_ref=-4)
SW, NW = Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH


def _profiles(rng, k, m, s, lo, hi):
    P = rng.integers(lo, hi + 1, size=(k, m, s)).astype(np.int32)
    P[:, :, 0] = 0
    return P


@pytest.mark.parametrize("params", [LINEAR, AFFINE], ids=["linear", "affine"])
@pytest.mark.parametrize("lo,hi", [(-4, 11), (-60, 100)], ids=["4bit", "8bit"])
def test_plain_profile_scores_equal_the_pallas_kernel_and_the_oracles(lo, hi, params):
    """K = 3 jointly packed profiles (4-bit or 8-bit fields), pool codes
    past S; SW with coordinates against the Pallas kernel and the argmax
    oracle, NW against the score oracle."""
    rng = np.random.default_rng(12)
    tables = _profiles(rng, 3, 8, 6, lo, hi)
    pool = rng.integers(0, 9, size=(21, 8)).astype(np.uint8)
    words, meta = jax_pssm.pack_pssms(list(tables))
    assert meta.field_bits == (4 if hi - lo <= 15 else 8)
    got = plain.profile_scores(torch.from_numpy(tables), torch.from_numpy(pool), params, SW,
                               with_coords=True)
    want = jax_pssm.pssm_scores_device(words, meta, pool, _jp(params),
                                       JaxAlgorithm.SMITH_WATERMAN, interpret=True,
                                       with_coords=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    nw = plain.profile_scores(torch.from_numpy(tables), torch.from_numpy(pool), params, NW)
    for q, table in enumerate(tables):
        oracle = jax_pssm.profile_argmax_oracle(table, pool, _jp(params))
        for g, w in zip(got, oracle):
            np.testing.assert_array_equal(g[q].numpy(), w)
        np.testing.assert_array_equal(
            nw[q].numpy(), jax_pssm.score_profile_oracle(table, pool, _jp(params),
                                                         JaxAlgorithm.NEEDLEMAN_WUNSCH))
    # The wrapper's CPU path is the plain version, one table or a stack.
    single = cuda_search.pssm_scores_device(torch.from_numpy(tables[0]), torch.from_numpy(pool),
                                            params, SW, with_coords=True)
    for g, w in zip(single, got):
        np.testing.assert_array_equal(g.numpy(), w[0].numpy())


def test_pssm_wrapper_refuses_nw_coordinates_and_a_nonzero_padding_column():
    pool = torch.ones((2, 5), dtype=torch.uint8)
    with pytest.raises(ValueError, match="SW-only"):
        cuda_search.pssm_scores_device(torch.zeros((3, 6), dtype=torch.int32), pool, LINEAR,
                                       NW, with_coords=True)
    with pytest.raises(ValueError, match="column 0"):
        cuda_search.pssm_scores_device(torch.ones((3, 6), dtype=torch.int32), pool, LINEAR, SW)


def _same_hits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.index, g.score, g.end_row, g.end_col, g.evalue, g.bitscore) == \
            (w.index, w.score, w.end_row, w.end_col, w.evalue, w.bitscore)
        if w.alignment is None:
            assert g.alignment is None
        else:
            _same_alignments([g.alignment], [w.alignment])


@pytest.mark.parametrize("params", [LINEAR, AFFINE], ids=["linear", "affine"])
def test_profile_search_equals_jax(params):
    """Multi-profile search with hits, alignments and a calibration; the
    single-profile top-k; a pool in chunks; DNA and protein widths; planted
    duplicates tie on score and keep the lower index."""
    rng = np.random.default_rng(13)
    cons = rng.integers(1, 21, size=(2, 12))
    b62 = np.array(blosum62(), dtype=np.int32)
    protein = [b62[c] for c in cons]
    pool = rng.integers(1, 21, size=(40, 30)).astype(np.uint8)
    pool[[5, 17, 33], 4:16] = cons[0]
    pool[[8, 9], 10:22] = cons[1]
    jp = _jp(params)
    cal = pssm.calibrate_profile(protein[0], params, n=30, samples=64, device="cpu")
    jcal = jax_pssm.calibrate_profile(protein[0], jp, n=30, samples=64, backend="oracle")
    assert dataclasses.astuple(cal) == dataclasses.astuple(jcal)
    for chunk in (1 << 17, 16):
        got = pssm.profile_search(protein, pool, params, k=4, device="cpu", chunk=chunk,
                                  hits=True, alignments=True, calibration=cal)
        want = jax_pssm.profile_search(protein, pool, jp, k=4, backend="oracle",
                                       hits=True, alignments=True, calibration=jcal)
        for g, w in zip(got, want):
            _same_hits(g, w)
    assert [h.index for h in got[0][:3]] == [5, 17, 33]
    dna = jax_pssm.pssm_from_sequences(rng.integers(1, 5, size=(6, 8)))
    dna_pool = rng.integers(0, 7, size=(25, 20)).astype(np.uint8)
    for alg in Algorithm:
        got = pssm.profile_search(dna, dna_pool, params, alg, k=5, device="cpu")
        want = jax_pssm.profile_search(dna, dna_pool, jp, JaxAlgorithm(int(alg)), k=5,
                                       backend="oracle")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="SW-only"):
        pssm.profile_search(dna, dna_pool, params, NW, device="cpu", hits=True)


def test_pssm_from_sequences_and_consensus_equal_jax():
    rng = np.random.default_rng(14)
    seqs = rng.integers(0, 6, size=(9, 11))
    np.testing.assert_array_equal(pssm.pssm_from_sequences(seqs),
                                  jax_pssm.pssm_from_sequences(seqs))
    bg = np.full(25, 1 / 24)
    bg[0] = 0
    prot = rng.integers(1, 25, size=(5, 7))
    P = pssm.pssm_from_sequences(prot, n_symbols=25, background=bg, scale=3.0)
    np.testing.assert_array_equal(
        P, jax_pssm.pssm_from_sequences(prot, n_symbols=25, background=bg, scale=3.0))
    assert pssm.profile_consensus_text(P) == jax_pssm.profile_consensus_text(P)


@pytest.mark.parametrize("name", ["dna", "affine", "blosum62"])
def test_calibrate_and_statistics_equal_jax(name):
    params = {"dna": LINEAR, "affine": AFFINE,
              "blosum62": AlignmentParameters(score_gap_read=-1, score_gap_ref=-1,
                                              gap_open_read=-11, gap_open_ref=-11,
                                              matrix=blosum62())}[name]
    jp = _jp(params)
    for method in ("ml", "moments"):
        got = stats.calibrate(params, m=24, n=20, samples=48, seed=3, device="cpu",
                              method=method)
        want = jax_stats.calibrate(jp, m=24, n=20, samples=48, seed=3, impl="xla",
                                   method=method)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert stats.calibrate(params, m=24, n=20, samples=48, device="cpu", lam=0.5) == \
        stats.GumbelCalibration(**dataclasses.asdict(
            jax_stats.calibrate(jp, m=24, n=20, samples=48, impl="xla", lam=0.5)))
    freqs = stats.ROBINSON_FREQS if params.matrix is not None else None
    if params.matrix is not None:
        freqs = tuple(np.asarray(freqs) / sum(freqs))
    assert stats.karlin_lambda(params, freqs) == jax_stats.karlin_lambda(jp, freqs)
    assert stats.entropy_h(params, freqs) == jax_stats.entropy_h(jp, freqs)
    rng = np.random.default_rng(18)
    hi = 5 if params.matrix is None else 21
    reads = rng.integers(1, hi, size=(3, 40)).astype(np.uint8)
    refs = rng.integers(1, hi, size=(3, 40)).astype(np.uint8)
    np.testing.assert_array_equal(stats.island_scores(reads, refs, params, margin=2),
                                  jax_stats.island_scores(reads, refs, jp, margin=2))
    got = stats.calibrate_islands(params, m=60, n=60, samples=4, chunk=2, c=4)
    want = jax_stats.calibrate_islands(jp, m=60, n=60, samples=4, chunk=2, c=4)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_calibration_scores_json_and_errors_equal_jax():
    rng = np.random.default_rng(19)
    scores = rng.gumbel(30, 4, size=200).round()
    for kw in ({}, {"method": "moments"}, {"lam": 0.2}):
        got = stats.calibrate_scores(scores, 64, 64, **kw)
        want = jax_stats.calibrate_scores(scores, 64, 64, **kw)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        for fn in ("bit_score", "evalue", "pvalue"):
            args = (np.array([20, 35, 50]),) + ((64, 10_000) if fn != "bit_score" else ())
            np.testing.assert_array_equal(getattr(got, fn)(*args), getattr(want, fn)(*args))
    assert stats.GumbelCalibration.from_json(got.to_json()) == got
    assert got.to_json() == want.to_json()
    with pytest.raises(ValueError, match="unknown method"):
        stats.calibrate_scores(scores, 8, 8, method="median")
    with pytest.raises(ValueError, match="negative-drift"):
        stats.karlin_lambda(AlignmentParameters(score_match=3, score_mismatch=-1))
