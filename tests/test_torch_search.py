"""One-vs-many search in the port against the JAX package: the plain
version of the search kernel against the Pallas kernel (interpret mode), the
query profiles the CUDA kernel reads, and the search entry points on the CPU
against ``versalignlib_tpu.search`` field by field, ties across chunks
included. Inputs come from a seeded numpy generator; tolerance 0."""

import dataclasses

import numpy as np
import pytest
import torch

from versalignlib_tpu import search as jax_search
from versalignlib_tpu.ops.pallas_search import cross_scores_device as jax_cross
from versalignlib_tpu.params import AlignmentParameters as JaxParams
from versalignlib_tpu.types import Algorithm as JaxAlgorithm
from versalignlib_tpu_torch import search
from versalignlib_tpu_torch.ops import cuda_search
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm
from versalignlib_tpu_torch.utils import capabilities

_MAT = tuple(tuple(int(3 if (a == s and a) else (-2 if a and s else 0)) for s in range(6))
             for a in range(6))
PARAMS = {
    "dna_linear": AlignmentParameters(),
    "dna_affine": AlignmentParameters(gap_open_read=-5, gap_open_ref=-5),
    "matrix": AlignmentParameters(score_gap_read=-3, score_gap_ref=-3, matrix=_MAT),
}
AFFINE_DNA = AlignmentParameters(score_match=1, score_mismatch=-4, score_gap_read=-1,
                                 score_gap_ref=-1, gap_open_read=-6, gap_open_ref=-6)


def _jp(p):
    return JaxParams(**dataclasses.asdict(p))


def _same_alignments(got, want):
    assert [dataclasses.astuple(a) for a in got] == [dataclasses.astuple(a) for a in want]


@pytest.mark.parametrize("alg", list(Algorithm), ids=lambda a: a.name)
@pytest.mark.parametrize("name", ["dna_linear", "matrix"])
def test_plain_cross_scores_equal_the_pallas_search_kernel(name, alg):
    """Both tiny shapes of tests/test_pallas_search.py: b > r puts the reads
    in the pool (lanes), r > b the refs; codes cover padding and N. (The
    affine branch: tests/test_torch_mapping.py.)"""
    check_cross_scores_against_pallas(PARAMS[name], alg)


def check_cross_scores_against_pallas(params, alg):
    rng = np.random.default_rng(1)
    for b, m, r, n in ((13, 17, 4, 9), (3, 9, 21, 12)):
        reads = rng.integers(0, 6, size=(b, m)).astype(np.uint8)
        refs = rng.integers(0, 6, size=(r, n)).astype(np.uint8)
        got = cuda_search.cross_scores_device(torch.from_numpy(reads), torch.from_numpy(refs),
                                              params, alg)
        assert got.dtype == torch.int32 and got.shape == (b, r)
        want = np.asarray(jax_cross(reads, refs, _jp(params), JaxAlgorithm(int(alg)),
                                    interpret=True))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["dna_linear", "matrix", "blosum62"])
def test_query_profiles_reproduce_the_substitution_scores(name):
    """The tables the CUDA kernel reads: default DNA scores as one byte
    table per read code (a cell is byte f of its row's 8 bytes, f the ref
    code or 0 past A/C/G/T, sign-extended), and the S x S table indexed
    [read][ref] with codes past S read as 0, which also carries DNA scores
    too large for a byte. Every pair of codes scores as the substitution."""
    from versalignlib_tpu.alphabet import blosum62, substitution_scores

    params = (AlignmentParameters(matrix=blosum62()) if name == "blosum62" else PARAMS[name])
    s = params.sub_size
    codes = np.arange(0, s + 6)
    want = substitution_scores(codes[:, None], codes[None, :], params.score_match,
                               params.score_mismatch, params.matrix)
    table = cuda_search.kernel_table(params, torch.device("cpu")).numpy()
    assert table.shape == (s, s) and table.dtype == np.int32
    inside = np.where(codes < s, codes, 0)
    np.testing.assert_array_equal(table[inside[:, None], inside[None, :]], want)
    assert cuda_search.dna_fits_bytes(params) == (name == "dna_linear")
    if cuda_search.dna_fits_bytes(params):
        words = cuda_search.dna_byte_table_words(params.score_match, params.score_mismatch)
        assert words.shape == (8, 2) and words.dtype == np.int32
        rows = words.view(np.uint32).astype(np.uint64)
        row8 = rows[:, 0] | (rows[:, 1] << np.uint64(32))
        sel = np.where((codes >= 1) & (codes <= 4), codes, 0).astype(np.uint64)
        lanes = row8[np.where(codes < 8, codes, 0)][:, None] >> (np.uint64(8) * sel[None, :])
        got = (lanes & np.uint64(0xFF)).astype(np.uint8).view(np.int8).astype(np.int32)
        np.testing.assert_array_equal(got, want)


def test_stable_topk_keeps_the_lower_index_among_ties():
    s = torch.tensor([[5, 7, 7, 1, 7], [0, 0, 0, 0, 0], [3, 9, 2, 9, 9]], dtype=torch.int32)
    vals, idx = search._topk(s, 3)
    np.testing.assert_array_equal(vals, [[7, 7, 7], [0, 0, 0], [9, 9, 9]])
    np.testing.assert_array_equal(idx, [[1, 2, 4], [0, 1, 2], [1, 3, 4]])


def _panel_with_duplicates(rng, r, n):
    panel = rng.integers(1, 5, size=(r, n)).astype(np.uint8)
    panel[r // 2] = panel[1]            # equal entries in different chunks
    panel[r - 1] = panel[1]
    return panel


@pytest.mark.parametrize("alg", list(Algorithm), ids=lambda a: a.name)
def test_score_matrix_and_best_hits_equal_jax_across_chunks(alg):
    rng = np.random.default_rng(3)
    reads = rng.integers(1, 5, size=(7, 20)).astype(np.uint8)
    panel = _panel_with_duplicates(rng, 11, 24)
    reads[2] = panel[1, 2:22]           # ties between the duplicate entries
    jalg = JaxAlgorithm(int(alg))
    for max_pairs in (1 << 20, 14):     # one chunk; chunks of 2 entries
        got = search.score_matrix(reads, panel, algorithm=alg, device="cpu",
                                  max_pairs=max_pairs)
        want = jax_search.score_matrix(reads, panel, algorithm=jalg, impl="xla",
                                       max_pairs=max_pairs)
        np.testing.assert_array_equal(got, want)
        arg, best, alns = search.best_hits(reads, panel, algorithm=alg, device="cpu",
                                           max_pairs=max_pairs)
        j_arg, j_best, j_alns = jax_search.best_hits(reads, panel, algorithm=jalg, impl="xla",
                                                     max_pairs=max_pairs, backend="oracle")
        np.testing.assert_array_equal(arg, j_arg)
        np.testing.assert_array_equal(best, j_best)
        assert arg[2] == 1
        _same_alignments(alns, j_alns)


def test_empty_panel_and_empty_batch_equal_jax():
    rng = np.random.default_rng(6)
    reads = rng.integers(1, 5, size=(3, 10)).astype(np.uint8)
    empty = np.zeros((0, 12), np.uint8)
    np.testing.assert_array_equal(search.score_matrix(reads, empty, device="cpu"),
                                  jax_search.score_matrix(reads, empty, impl="xla"))
    for got, want in zip(search.best_hits(reads, empty, device="cpu"),
                         jax_search.best_hits(reads, empty, impl="xla")):
        if isinstance(got, list):
            _same_alignments(got, want)
        else:
            np.testing.assert_array_equal(got, want)
    got = search.map_reads(reads, empty, device="cpu")
    want = jax_search.map_reads(reads, empty, impl="xla")
    for field in ("index", "score", "strand", "mapq"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    _same_alignments(got.alignments, want.alignments)
    got = search.map_read_pairs(reads, reads, empty, device="cpu")
    want = jax_search.map_read_pairs(reads, reads, empty, impl="xla")
    for field in ("index", "score", "orient", "mapq"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert search.score_matrix(np.zeros((0, 5), np.uint8), reads, device="cpu").shape == (0, 3)


def test_search_accepts_strings_like_jax():
    reads = ["ACGTTGCA", "ttgacca", "GGGNNACG"]
    panel = ["ACGTTGCAAA", "CCTTGACCAT", "GGACGTT"]
    np.testing.assert_array_equal(search.score_matrix(reads, panel, device="cpu"),
                                  jax_search.score_matrix(reads, panel, impl="xla"))


def test_search_budget_gate(monkeypatch):
    """A launch whose plan exceeds the free device memory is refused with
    guidance before anything is allocated; nothing is checked off the card.
    The plan is the three int32 outputs a pair, and the boundary columns
    only where a block's do not fit shared memory: no DP row scratch."""
    assert cuda_search.search_mem_plan(1536, 1 << 20, False, 150) == (1 << 20) * 12
    assert cuda_search.search_mem_plan(1536, 1 << 20, True, 150) == (1 << 20) * 12
    assert cuda_search.search_mem_plan(512, 1 << 20, True, 8000) == (1 << 20) * 12
    assert cuda_search.search_mem_plan(1536, 1 << 20, True, 8000) == (1 << 20) * (12 + 8 * 8000)
    assert cuda_search.search_mem_plan(1536, 1 << 20, False, 8000) == (1 << 20) * (12 + 4 * 8000)
    capabilities.check_search_budget(150, 1 << 20, 1 << 20, True, torch.device("cpu"))
    monkeypatch.setattr(capabilities, "free_device_bytes", lambda device: 8 << 30)
    cuda = torch.device("cuda")
    capabilities.check_search_budget(150, 1536, 1 << 20, True, cuda)    # 12.6 MB fits
    with pytest.raises(ValueError, match="smaller --window"):
        capabilities.check_search_budget(8000, 1536, 1 << 20, True, cuda)  # 67 GB


def _edge_params(gap):
    return AFFINE_DNA if gap == "affine" else AlignmentParameters(score_gap_read=-2,
                                                                   score_gap_ref=-3)


@pytest.mark.parametrize("gap", ["linear", "affine"])
@pytest.mark.parametrize("n", [9, 513, 640])
@pytest.mark.parametrize("m", [1, 20])
def test_device_entries_on_cpu_equal_numpy_oracles_at_edge_shapes(m, n, gap):
    """What the card's checks hold the kernel to: ``cross_scores_device``
    and ``pssm_scores_device`` on the CPU (their plain versions) against
    the JAX package's numpy oracles at the kernel's edge shapes (fewer read
    rows than lanes, refs narrower than a lane, one column into a second
    stripe, the reference-mapping width): cross scores SW and NW, profiles
    SW with coordinates (periodic pools whose maximum recurs, an all-padding
    entry) and NW."""
    from versalignlib_tpu.ops import gotoh, oracle
    from versalignlib_tpu.ops.pssm import profile_argmax_oracle, score_profile_oracle

    params = _edge_params(gap)
    jp = _jp(params)
    rng = np.random.default_rng(m * 1000 + n)
    reads = rng.integers(0, 7, size=(3, m)).astype(np.uint8)
    refs = rng.integers(0, 7, size=(2, n)).astype(np.uint8)
    sw_fn, nw_fn = ((gotoh.sw_score_affine, gotoh.nw_score_affine) if params.affine
                    else (oracle.sw_score, oracle.nw_score))
    for alg, fn in ((Algorithm.SMITH_WATERMAN, sw_fn), (Algorithm.NEEDLEMAN_WUNSCH, nw_fn)):
        got = cuda_search.cross_scores_device(torch.from_numpy(reads), torch.from_numpy(refs),
                                              params, alg).numpy()
        want = [[fn(a, b, jp) for b in refs] for a in reads]
        np.testing.assert_array_equal(got, want)
    tables = rng.integers(-3, 4, size=(2, m, 6)).astype(np.int32)
    tables[:, :, 0] = 0
    pool = np.tile(np.array([1, 2, 3, 1], np.uint8), (3, -(-n // 4)))[:, :n].copy()
    pool[1] = rng.integers(0, 8, size=n)
    pool[2] = 0
    t, p = torch.from_numpy(tables), torch.from_numpy(pool)
    got = cuda_search.pssm_scores_device(t, p, params, Algorithm.SMITH_WATERMAN,
                                         with_coords=True)
    nw = cuda_search.pssm_scores_device(t, p, params, Algorithm.NEEDLEMAN_WUNSCH).numpy()
    for q in range(tables.shape[0]):
        for part, want in zip(got, profile_argmax_oracle(tables[q], pool, jp)):
            np.testing.assert_array_equal(part[q].numpy(), want)
        np.testing.assert_array_equal(
            nw[q], score_profile_oracle(tables[q], pool, jp, JaxAlgorithm.NEEDLEMAN_WUNSCH))
