"""The port's scoring path (plain PyTorch version of ``csrc/score.cu``)
against the JAX package's Pallas score kernel in interpret mode and its XLA
scan, on the same numpy inputs, with ``==``."""

import numpy as np
import pytest
import torch

from tests.conftest import random_codes
from versalignlib_tpu.ops import xla
from versalignlib_tpu.ops.pallas_score import score_batch_device as jax_score_device
from versalignlib_tpu.params import DEFAULT_PARAMETERS as JAX_PARAMS
from versalignlib_tpu.types import Algorithm as JaxAlgorithm
from versalignlib_tpu_torch.ops import plain
from versalignlib_tpu_torch.ops.cuda_score import CudaScorer, score_batch_device
from versalignlib_tpu_torch.params import DEFAULT_PARAMETERS, AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm


@pytest.mark.parametrize("algorithm", list(Algorithm))
@pytest.mark.parametrize("n", [7, 9, 16])
def test_plain_score_matches_pallas_and_xla(algorithm, n):
    rng = np.random.default_rng(100 + n)
    reads = random_codes(rng, 24, 13, padded=True, n_prob=0.1)
    refs = random_codes(rng, 24, n, padded=True, n_prob=0.1)
    got = plain.score_batch(torch.from_numpy(reads), torch.from_numpy(refs),
                            DEFAULT_PARAMETERS, algorithm)
    assert got.dtype == torch.int32 and got.shape == (24,)
    pallas = np.asarray(jax_score_device(reads, refs, JAX_PARAMS,
                                         JaxAlgorithm(int(algorithm)), True))
    scan = np.asarray(xla.score_batch(reads, refs, JAX_PARAMS,
                                      JaxAlgorithm(int(algorithm))))
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), scan)


@pytest.mark.parametrize("algorithm", list(Algorithm))
def test_wrapper_on_cpu_tensors_is_the_plain_version_with_other_scoring(algorithm):
    from versalignlib_tpu.params import AlignmentParameters as JaxParams

    rng = np.random.default_rng(7)
    reads = random_codes(rng, 16, 20, padded=True, n_prob=0.05)
    refs = random_codes(rng, 16, 11, padded=True, n_prob=0.05)
    p = AlignmentParameters(score_match=3, score_mismatch=-2,
                            score_gap_read=-1, score_gap_ref=-2)
    jp = JaxParams(score_match=3, score_mismatch=-2, score_gap_read=-1,
                   score_gap_ref=-2)
    got = CudaScorer(torch.device("cpu"))(reads, refs, p, algorithm)
    want = np.asarray(xla.score_batch(reads, refs, jp, JaxAlgorithm(int(algorithm))))
    np.testing.assert_array_equal(got, want)


def test_empty_axes_score_zero():
    for m, n in ((0, 5), (5, 0)):
        reads = torch.zeros((3, m), dtype=torch.uint8)
        refs = torch.zeros((3, n), dtype=torch.uint8)
        out = score_batch_device(reads, refs, DEFAULT_PARAMETERS,
                                 Algorithm.NEEDLEMAN_WUNSCH)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), np.zeros(3, np.int32))


def test_all_invalid_pairs_score_zero():
    reads = torch.zeros((4, 9), dtype=torch.uint8)
    refs = torch.full((4, 6), 5, dtype=torch.uint8)
    for algorithm in Algorithm:
        out = score_batch_device(reads, refs, DEFAULT_PARAMETERS, algorithm)
        np.testing.assert_array_equal(out.numpy(), np.zeros(4, np.int32))


def test_wrapper_rejects_bad_inputs():
    good = torch.ones((2, 3), dtype=torch.uint8)
    with pytest.raises(TypeError):
        score_batch_device(good.to(torch.int32), good, DEFAULT_PARAMETERS,
                           Algorithm.SMITH_WATERMAN)
    with pytest.raises(ValueError):
        score_batch_device(good, torch.ones((3, 3), dtype=torch.uint8),
                           DEFAULT_PARAMETERS, Algorithm.SMITH_WATERMAN)
