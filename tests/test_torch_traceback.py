"""``ops/traceback.decode_batch_affine`` against the JAX package's: the
dense Gotoh codes, start cells and scores of the JAX package's
``ops/xla.py::align_affine_batch`` on the CPU go through both packages'
decoders, and every field of every alignment is compared with ``==``. Also:
the port's decoder raises where its native library does not load, with no
Python fallback."""

import numpy as np
import pytest

from tests.conftest import random_codes
from versalignlib_tpu.alphabet import blosum62 as jax_blosum62
from versalignlib_tpu.ops import traceback as jax_traceback
from versalignlib_tpu.ops import xla
from versalignlib_tpu.params import AlignmentParameters as JaxParams
from versalignlib_tpu.types import Algorithm as JaxAlgorithm
from versalignlib_tpu.types import TieBreak as JaxTieBreak
from versalignlib_tpu_torch import native
from versalignlib_tpu_torch.alphabet import blosum62
from versalignlib_tpu_torch.ops.traceback import decode_batch_affine
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm, TieBreak

#: (JAX parameters, the port's): BWA-MEM DNA, BLOSUM62 with gaps -11/-1.
SETS = {
    "bwamem": (JaxParams(score_match=1, score_mismatch=-4, score_gap_read=-1, score_gap_ref=-1,
                         gap_open_read=-6, gap_open_ref=-6),
               AlignmentParameters(score_match=1, score_mismatch=-4, score_gap_read=-1,
                                   score_gap_ref=-1, gap_open_read=-6, gap_open_ref=-6)),
    "blosum62": (JaxParams(score_gap_read=-1, score_gap_ref=-1, gap_open_read=-11,
                           gap_open_ref=-11, matrix=jax_blosum62()),
                 AlignmentParameters(score_gap_read=-1, score_gap_ref=-1, gap_open_read=-11,
                                     gap_open_ref=-11, matrix=blosum62())),
}
FIELDS = ("read", "ref", "score", "cigar", "read_start", "read_end", "ref_start", "ref_end",
          "buffer_start", "buffer_end")


def _fields(alns):
    return [tuple(getattr(a, f) for f in FIELDS) for a in alns]


def _pairs(rng, pset, b, m, n):
    if pset == "bwamem":
        return (random_codes(rng, b, m, padded=True, n_prob=0.05),
                random_codes(rng, b, n, padded=True, n_prob=0.05))
    reads = rng.integers(1, 24, size=(b, m)).astype(np.uint8)
    refs = rng.integers(1, 24, size=(b, n)).astype(np.uint8)
    refs[:b // 2] = np.resize(reads[:b // 2], (b // 2, n))   # homologous pairs: long gaps
    reads[1, m - 3:] = 0
    return reads, refs


@pytest.mark.parametrize("n", [21, 24], ids=["partial_word", "whole_words"])
@pytest.mark.parametrize("pset", list(SETS))
@pytest.mark.parametrize("tie", list(TieBreak), ids=lambda t: t.name)
@pytest.mark.parametrize("algorithm", list(Algorithm), ids=lambda a: a.name)
def test_decode_batch_affine_matches_jax(algorithm, tie, pset, n):
    jp, p = SETS[pset]
    jalg = JaxAlgorithm(int(algorithm))
    rng = np.random.default_rng(1000 + 4 * int(algorithm) + 2 * int(tie) + n)
    reads, refs = _pairs(rng, pset, 12, 17, n)
    ptr, start_r, start_f, scores = (np.asarray(x) for x in xla.align_affine_batch(
        reads, refs, jp, jalg, JaxTieBreak(int(tie))))
    assert ptr.dtype == np.uint8 and ptr.shape == (12, 17, n)
    args = (ptr, reads, refs, start_r, start_f)
    got = decode_batch_affine(*args, p, algorithm, scores)
    want = jax_traceback.decode_batch_affine(*args, jp, jalg, scores)
    assert _fields(got) == _fields(want)
    texts = ["".join(rng.choice(list("acgtnXY"), 17)) for _ in range(12)], \
        ["".join(rng.choice(list("acgtnXY"), n)) for _ in range(12)]
    got = decode_batch_affine(*args, p, algorithm, scores, *texts)
    assert _fields(got) == _fields(jax_traceback.decode_batch_affine(*args, jp, jalg, scores,
                                                                     *texts))


def test_decode_batch_affine_raises_without_the_native_decoder(monkeypatch):
    def fail():
        raise RuntimeError("native decoder build failed")

    monkeypatch.setattr(native, "_load", fail)
    codes = np.ones((1, 2, 3), np.uint8)
    with pytest.raises(RuntimeError, match="native decoder build failed"):
        decode_batch_affine(codes, np.ones((1, 2), np.uint8), np.ones((1, 3), np.uint8),
                            np.array([1]), np.array([2]), AlignmentParameters(
                                gap_open_read=-4, gap_open_ref=-4),
                            Algorithm.SMITH_WATERMAN, np.array([2]))
