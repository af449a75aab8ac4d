"""The score path at the edges of ``csrc/score.cu``'s lane groups (16 lanes a
pair, 32 or 40 ref columns a lane, stripes of 512 or 640 columns, 8 pairs a
block): the plain version against the JAX package's Pallas score kernel in
interpret mode and its XLA scan, with ``==``; the wrapper's memory plan, the
device-fit gate and its choice of scoring tables."""

import numpy as np
import pytest
import torch

from tests.conftest import random_codes
from versalignlib_tpu.alphabet import blosum62 as jax_blosum62
from versalignlib_tpu.alphabet import substitution_scores
from versalignlib_tpu.ops import xla
from versalignlib_tpu.ops.pallas_score import score_batch_device as jax_score_device
from versalignlib_tpu.params import AlignmentParameters as JaxParams
from versalignlib_tpu.types import Algorithm as JaxAlgorithm
from versalignlib_tpu_torch.alphabet import base_score_matrix, blosum62
from versalignlib_tpu_torch.ops import cuda_score, cuda_search, plain
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm
from versalignlib_tpu_torch.utils.capabilities import DeviceCapabilities

LINEAR = dict(score_gap_read=-2, score_gap_ref=-3)
AFFINE = dict(score_gap_read=-1, score_gap_ref=-2, gap_open_read=-5, gap_open_ref=-4)


def _pair(rng, b, m, n):
    """(B, m), (B, n) codes: random A/C/G/T with N and trailing padding, one
    periodic pair (maxima that recur across lanes) and one all-padding read."""
    reads = random_codes(rng, b, m, padded=True, n_prob=0.1)
    refs = random_codes(rng, b, n, padded=True, n_prob=0.1)
    reads[0] = np.tile(np.array([1, 2, 3, 4], np.uint8), -(-m // 4))[:m]
    refs[0] = np.tile(np.array([1, 2, 3, 4], np.uint8), -(-n // 4))[:n]
    reads[-1] = 0
    return reads, refs


# Fewer read rows than lanes (1, 15) and just more (17); refs one column
# into a second 32-column stripe (513), a whole 40-column stripe (640) and
# a partial third stripe (1100). One Pallas run per case, SW and NW, linear
# and affine each reached.
@pytest.mark.parametrize("m, n, algorithm, gaps", [
    (1, 513, Algorithm.SMITH_WATERMAN, LINEAR),
    (1, 513, Algorithm.NEEDLEMAN_WUNSCH, AFFINE),
    (15, 640, Algorithm.SMITH_WATERMAN, AFFINE),
    (15, 640, Algorithm.NEEDLEMAN_WUNSCH, LINEAR),
    (17, 1100, Algorithm.SMITH_WATERMAN, LINEAR),
    (17, 1100, Algorithm.NEEDLEMAN_WUNSCH, AFFINE),
], ids=lambda v: v.name if isinstance(v, Algorithm) else
    ("affine" if "gap_open_read" in v else "linear") if isinstance(v, dict) else str(v))
def test_plain_score_matches_pallas_and_xla_at_lane_edges(m, n, algorithm, gaps):
    rng = np.random.default_rng(m * 10007 + n)
    reads, refs = _pair(rng, 5, m, n)
    got = plain.score_batch(torch.from_numpy(reads), torch.from_numpy(refs),
                            AlignmentParameters(**gaps), algorithm)
    jp, ja = JaxParams(**gaps), JaxAlgorithm(int(algorithm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_score_device(reads, refs, jp, ja, True)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla.score_batch(reads, refs, jp, ja)))


@pytest.mark.parametrize("algorithm", list(Algorithm), ids=lambda a: a.name)
@pytest.mark.parametrize("m, n", [(1, 9), (15, 1100), (33, 640)])
def test_plain_score_matches_xla_with_blosum62_and_large_dna_scores(m, n, algorithm):
    """The other scorings at the edge shapes against the XLA scan: BLOSUM62
    with codes past S, and DNA scores too large for the kernel's byte
    tables (which reach it as the 6 x 6 matrix)."""
    rng = np.random.default_rng(m + 3 * n)
    ja = JaxAlgorithm(int(algorithm))
    protein_r = rng.integers(0, 30, size=(4, m)).astype(np.uint8)
    protein_f = rng.integers(0, 30, size=(4, n)).astype(np.uint8)
    for p, jp, (reads, refs) in (
            (AlignmentParameters(matrix=blosum62(), **AFFINE),
             JaxParams(matrix=jax_blosum62(), **AFFINE), (protein_r, protein_f)),
            (AlignmentParameters(score_match=300, score_mismatch=-200, **LINEAR),
             JaxParams(score_match=300, score_mismatch=-200, **LINEAR), _pair(rng, 4, m, n))):
        got = plain.score_batch(torch.from_numpy(reads), torch.from_numpy(refs), p, algorithm)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(xla.score_batch(reads, refs, jp, ja)))


def test_score_mem_plan_holds_codes_scores_and_only_a_boundary_that_leaves_shared():
    """Codes, scores and no DP row: one stripe at 512 columns needs no
    boundary column; past a stripe the boundary stays in shared memory
    while a block's eight fit (4000 linear rows: 128,000 bytes) and goes to
    device memory, for every slot of the launch's blocks of 8, where they do
    not (4000 affine rows: 256,000 bytes)."""
    assert cuda_score.score_mem_plan(512, 512, 16384) == 16384 * (512 + 512 + 4)
    assert cuda_score.score_mem_plan(512, 512, 16384, affine=True) == 16384 * 1028
    assert cuda_score.score_mem_plan(4000, 1100, 10) == 10 * (4000 + 1100 + 4)
    assert cuda_score.edge_in_shared(4000, affine=False)
    assert not cuda_score.edge_in_shared(4000, affine=True)
    assert cuda_score.score_mem_plan(4000, 1100, 10, affine=True) == \
        10 * (4000 + 1100 + 4) + 16 * 4000 * 8
    # One stripe: the boundary is never needed, whatever its size.
    assert cuda_score.score_mem_plan(4000, 500, 10, affine=True) == 10 * (4000 + 500 + 4)
    assert cuda_score.edge_in_shared(3631, affine=True)
    assert not cuda_score.edge_in_shared(3632, affine=True)


@pytest.mark.parametrize("m, n, affine, size, plan", [
    # One stripe: no boundary column; byte tables, or the table in shared memory.
    (512, 512, False, None, (32, 1, 0, 0, False)),
    (512, 512, True, 25, (32, 1, 1, 4 * 25 * 25, False)),
    # Two stripes of 640: eight 4000-row linear boundaries fit (128,000
    # bytes), the 6 x 6 table beside them; affine ones (256,000) do not.
    (4000, 1100, False, None, (40, 2, 0, 128_000, False)),
    (4000, 1100, False, 6, (40, 2, 1, 128_000 + 144, False)),
    (4000, 1100, True, None, (40, 2, 0, 0, True)),
    # A 200 x 200 table fits beside the boundaries, a 250 x 250 one does not;
    # at 3631 affine rows the boundaries alone fill shared memory.
    (33, 1100, True, 200, (40, 2, 1, 160_000 + 8 * 33 * 8, False)),
    (33, 1100, True, 250, (40, 2, 2, 8 * 33 * 8, False)),
    (3631, 1100, True, 30, (40, 2, 2, cuda_search.SMEM_BYTES, False)),
])
def test_launch_plan_places_the_table_and_the_boundary_columns(m, n, affine, size, plan):
    assert tuple(cuda_score.launch_plan(m, n, affine, size)) == plan


def test_dense_fits_score_follows_the_plan_for_one_block_of_eight_pairs():
    def caps(memory):
        return DeviceCapabilities(name="test", sm_count=132, memory_bytes=memory,
                                  power_limit=None)

    for m, n, affine in ((512, 512, False), (4000, 1100, True), (100_000, 100_000, True)):
        need = cuda_score.score_mem_plan(m, n, 8, affine)
        assert caps(need).dense_fits(m, n, "score", affine)
        assert not caps(need - 1).dense_fits(m, n, "score", affine)
    assert cuda_score.score_mem_plan(100_000, 100_000, 8, True) == \
        8 * 200_004 + 8 * 4 * 100_000 * 2


@pytest.mark.parametrize("match, mismatch, bytes_", [
    (2, -1, True), (127, -128, True), (128, -1, False), (1, -129, False), (300, -200, False)])
def test_score_tables_choose_byte_tables_while_dna_scores_fit_a_byte(match, mismatch, bytes_):
    params = AlignmentParameters(score_match=match, score_mismatch=mismatch, **LINEAR)
    table, tables, s = cuda_score.score_tables(params, torch.device("cpu"))
    assert s == 6 and (tables is not None) == bytes_ and (table is None) == bytes_
    codes = np.arange(0, 12)
    want = substitution_scores(codes[:, None], codes[None, :], match, mismatch, None)
    if bytes_:
        np.testing.assert_array_equal(tables.numpy(),
                                      cuda_search.dna_byte_table_words(match, mismatch))
        # What the kernel's prmt reads: byte f (the ref code, 0 outside
        # 1..4) of read code c's 8-byte table (code 0's past 7).
        rows = tables.numpy().view(np.uint32).astype(np.uint64)
        row8 = rows[:, 0] | (rows[:, 1] << np.uint64(32))
        sel = np.where((codes >= 1) & (codes <= 4), codes, 0).astype(np.uint64)
        lanes = row8[np.where(codes < 8, codes, 0)][:, None] >> (np.uint64(8) * sel[None, :])
        got = (lanes & np.uint64(0xFF)).astype(np.uint8).view(np.int8).astype(np.int32)
    else:
        np.testing.assert_array_equal(table.numpy(), base_score_matrix(match, mismatch))
        inside = np.where(codes < s, codes, 0)
        got = table.numpy()[inside[:, None], inside[None, :]]
    np.testing.assert_array_equal(got, want)


def test_score_tables_take_a_matrix_as_it_is():
    params = AlignmentParameters(matrix=blosum62(), **AFFINE)
    table, tables, s = cuda_score.score_tables(params, torch.device("cpu"))
    assert tables is None and s == len(blosum62()) and table.dtype == torch.int32
    np.testing.assert_array_equal(table.numpy(), np.array(blosum62(), np.int32))
