"""The score path's chunked copies (``ops/cuda_score.py::CudaScorer``): the
chunk plan on the CPU; on the card, the scores through the page-locked ring
against the plain version, ``==``, at the plan's edges, across calls and
threads. Imports no JAX.

The card cases run on a host with a CUDA device:

    python -m pytest tests/test_torch_score_staging.py -m card --noconftest -p no:cacheprovider
"""

import threading

import numpy as np
import pytest
import torch

from versalignlib_tpu_torch.alphabet import blosum62
from versalignlib_tpu_torch.dispatch import AlignmentEngine
from versalignlib_tpu_torch.ops import cuda_score, plain
from versalignlib_tpu_torch.ops.cuda_score import RING_SLOTS, CudaScorer, chunk_plan
from versalignlib_tpu_torch.params import DEFAULT_PARAMETERS, AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm

PLANS = [(0, 4), (1, 4), (7, 4), (8, 4), (9, 4), (16, 4), (17, 4), (1000, 33),
         (16384, 5280), (16384, 8448), (1_000_000, 4224)]


@pytest.mark.parametrize("b,wave", PLANS)
def test_chunks_cover_the_batch_in_whole_waves(b, wave):
    chunks = chunk_plan(b, wave)
    edges = [0] + [hi for _, hi in chunks]
    assert [lo for lo, _ in chunks] == edges[:-1] and edges[-1] == b
    assert all(hi > lo for lo, hi in chunks)
    if b < 2 * wave:
        assert len(chunks) == (1 if b else 0)
    else:
        assert all(hi - lo == wave for lo, hi in chunks[:-1])
        assert len(chunks) == b // wave
    # The ring's slots hold a chunk: bounded by the wave, not by the batch.
    assert max((hi - lo for lo, hi in chunks), default=0) < 2 * wave


def test_the_ring_is_bounded_by_two_waves_for_any_batch():
    wave = 5280
    rows = [max(hi - lo for lo, hi in chunk_plan(b, wave))
            for b in range(2 * wave - 3, 40 * wave, 997)]
    assert max(rows) < 2 * wave
    assert max(hi - lo for lo, hi in chunk_plan(2000 * wave - 1, wave)) == 2 * wave - 1


SW, NW = Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH
AFFINE = AlignmentParameters(score_match=1, score_mismatch=-4, score_gap_read=-1,
                             score_gap_ref=-1, gap_open_read=-6, gap_open_ref=-6)
SETS = {"linear": DEFAULT_PARAMETERS, "affine": AFFINE,
        "blosum62": AlignmentParameters(score_gap_read=-1, score_gap_ref=-1,
                                        gap_open_read=-11, gap_open_ref=-11,
                                        matrix=blosum62())}
#: Batch sizes at the plan's edges, from the wave of the launch.
SIZES = {"0": lambda w: 0, "1": lambda w: 1, "7": lambda w: 7,
         "wave-1": lambda w: w - 1, "wave+1": lambda w: w + 1,
         "chunks>slots": lambda w: (RING_SLOTS + 1) * w + 5}
M, N = 40, 56


def _codes(seed, b, m, n, params):
    rng = np.random.default_rng(seed)
    top = 6 if params.matrix is None else len(params.matrix)
    return (rng.integers(0, top, size=(b, m)).astype(np.uint8),
            rng.integers(0, top, size=(b, n)).astype(np.uint8))


def _plain(reads, refs, params, algorithm, dev):
    return plain.score_batch(torch.from_numpy(reads).to(dev), torch.from_numpy(refs).to(dev),
                             params, algorithm).cpu().numpy()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("algorithm", [SW, NW], ids=["SW", "NW"])
@pytest.mark.parametrize("name", sorted(SETS))
def test_scores_through_the_ring_equal_plain(card, name, algorithm, size):
    params = SETS[name]
    wave = cuda_score.wave_pairs(M, N, params, algorithm, card)
    b = SIZES[size](wave)
    reads, refs = _codes(b, b, M, N, params)
    got = CudaScorer(card)(reads, refs, params, algorithm)
    assert got.dtype == np.int32 and got.shape == (b,)
    np.testing.assert_array_equal(got, _plain(reads, refs, params, algorithm, card))


@pytest.mark.card
@pytest.mark.parametrize("m,n", [(0, 9), (7, 0), (0, 0)])
def test_an_empty_axis_scores_zero(card, m, n):
    reads, refs = _codes(1, 5, m, n, DEFAULT_PARAMETERS)
    got = CudaScorer(card)(reads, refs, DEFAULT_PARAMETERS, SW)
    np.testing.assert_array_equal(got, np.zeros(5, np.int32))


@pytest.mark.card
def test_back_to_back_calls_keep_their_own_scores_and_the_ring(card):
    scorer = CudaScorer(card)
    wave = cuda_score.wave_pairs(M, N, AFFINE, SW, card)
    batches = [_codes(10 + k, b, M, N, AFFINE)
               for k, b in enumerate((3 * wave + 2, 3 * wave + 2, 5, 2 * wave))]
    want = [_plain(*batch, AFFINE, SW, card) for batch in batches]
    got = []
    for batch in batches:
        got.append(scorer(*batch, AFFINE, SW))
        ring = [buf.data_ptr() for buf in scorer._pinned._bufs[:RING_SLOTS]]
        if len(got) == 1:
            first_ring = ring
        assert ring == first_ring          # no page-locked allocation after the first call
    for k in range(len(batches)):
        np.testing.assert_array_equal(got[k], want[k])
        for other in got[k + 1:]:
            assert not np.shares_memory(got[k], other)
    assert all(buf.numel() <= (2 * wave - 1) * (M + N)
               for buf in scorer._pinned._bufs[:RING_SLOTS])


@pytest.mark.card
def test_two_threads_on_one_engine_get_the_plain_scores(card):
    engine = AlignmentEngine(AFFINE, backend="cuda", device=card)
    wave = cuda_score.wave_pairs(M, N, AFFINE, SW, card)
    inputs = {t: [_codes(100 * t + k, 2 * wave + 3 * k + t, M, N, AFFINE) for k in range(4)]
              for t in range(2)}
    want = {t: [_plain(*batch, AFFINE, SW, card) for batch in inputs[t]] for t in inputs}
    got: dict = {}

    def work(t):
        got[t] = [engine.score_alignments(SW, *batch) for batch in inputs[t]]

    threads = [threading.Thread(target=work, args=(t,)) for t in inputs]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=120)
    assert not any(thread.is_alive() for thread in threads)
    for t in inputs:
        for g, w in zip(got[t], want[t]):
            np.testing.assert_array_equal(g, w)
