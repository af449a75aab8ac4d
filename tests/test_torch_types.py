"""The port's ``AlignmentBatch`` column-store methods (``slice``,
``to_json_rows``, ``write_to``), ``AlignMode`` and the package's exports
against the JAX package's, on the same decoded batches."""

import io

import numpy as np
import pytest

import versalignlib_tpu as jax_pkg
from tests.conftest import random_codes
from versalignlib_tpu.types import AlignmentBatch as JaxBatch
from versalignlib_tpu.types import AlignMode as JaxAlignMode
import versalignlib_tpu_torch as port
from versalignlib_tpu_torch import Algorithm, AlignmentBatch, AlignmentEngine, AlignMode

SLICES = ((0, 7), (3, 11), (11, 11), (5, 20))


def _batches(algorithm, gapped):
    """The port's decoded batch of 20 pairs on its CPU path, and the JAX
    package's batch over the same columns."""
    rng = np.random.default_rng(700 + int(algorithm) + 2 * gapped)
    reads = random_codes(rng, 20, 11, padded=True, n_prob=0.08)
    refs = random_codes(rng, 20, 14, padded=True, n_prob=0.08)
    ours = AlignmentEngine(device="cpu").compute_alignments(
        algorithm, reads, refs, raw=True, gapped=gapped)
    theirs = JaxBatch(ours.read_gapped, ours.ref_gapped, ours.cigar, ours.meta)
    return ours, theirs


def _columns(batch):
    return tuple(None if c is None else c.copy()
                 for c in (batch.read_gapped, batch.ref_gapped, batch.cigar, batch.meta))


def _same_columns(a, b):
    for x, y in zip(_columns(a), _columns(b)):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("gapped", [True, False])
@pytest.mark.parametrize("algorithm", list(Algorithm))
def test_slice_and_json_rows_match_jax(algorithm, gapped):
    ours, theirs = _batches(algorithm, gapped)
    assert ours.to_json_rows() == theirs.to_json_rows()
    assert all(("read" in row) == gapped for row in ours.to_json_rows())
    for lo, hi in SLICES:
        got, want = ours.slice(lo, hi), theirs.slice(lo, hi)
        assert isinstance(got, AlignmentBatch) and len(got) == len(want)
        _same_columns(got, want)
        assert got.to_json_rows() == want.to_json_rows()
    # A slice is a view: it shares the columns' memory.
    assert np.shares_memory(ours.slice(2, 9).meta, ours.meta)


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("algorithm", list(Algorithm))
def test_write_to_matches_jax(algorithm, compat):
    ours, theirs = _batches(algorithm, True)
    got, want = io.StringIO(), io.StringIO()
    ours.write_to(got, compat=compat)
    theirs.write_to(want, compat=compat)
    assert got.getvalue() == want.getvalue() and got.getvalue()
    sliced, sliced_want = io.StringIO(), io.StringIO()
    ours.slice(4, 13).write_to(sliced, compat=compat)
    theirs.slice(4, 13).write_to(sliced_want, compat=compat)
    assert sliced.getvalue() == sliced_want.getvalue()


@pytest.mark.parametrize("compat", [False, True])
def test_write_to_cigar_only_raises_as_jax(compat):
    ours, theirs = _batches(Algorithm.SMITH_WATERMAN, False)
    with pytest.raises(ValueError) as want:
        theirs.write_to(io.StringIO(), compat=compat)
    with pytest.raises(ValueError) as got:
        ours.write_to(io.StringIO(), compat=compat)
    assert str(got.value) == str(want.value)


def test_exports_and_align_mode_match_jax():
    assert port.__version__ == jax_pkg.__version__ == "0.1.0"
    for name in ("get_backend", "register_backend", "available_backends", "__version__",
                 "AlignMode"):
        assert name in port.__all__ and hasattr(port, name), name
    assert [(m.name, m.value) for m in AlignMode] == \
        [(m.name, m.value) for m in JaxAlignMode]
    assert port.available_backends("cpu") == ["cuda"]
    assert port.get_backend("auto", "cpu").is_available()
