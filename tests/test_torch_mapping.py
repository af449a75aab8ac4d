"""Read mapping in the port against the JAX package: the affine branch of
the search kernel's plain version against the Pallas kernel (interpret
mode), ``map_reads``, ``map_read_pairs`` and ``map_to_reference`` on the CPU
field by field (ties across chunks and windows included), the window tiling
and its ``.npz`` file in both directions. Inputs come from a seeded numpy
generator; tolerance 0."""

import warnings

import numpy as np
import pytest

from tests.test_torch_search import (AFFINE_DNA, PARAMS, _jp, _panel_with_duplicates,
                                     _same_alignments, check_cross_scores_against_pallas)
from versalignlib_tpu import refmap as jax_refmap
from versalignlib_tpu import search as jax_search
from versalignlib_tpu.types import TieBreak as JaxTieBreak
from versalignlib_tpu_torch import refmap, search
from versalignlib_tpu_torch.alphabet import reverse_complement_codes
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm, TieBreak


@pytest.mark.parametrize("alg", list(Algorithm), ids=lambda a: a.name)
def test_plain_affine_cross_scores_equal_the_pallas_search_kernel(alg):
    """The affine (Gotoh) branch, as tests/test_torch_search.py checks the
    linear and matrix ones: both tiny shapes, both pool sides."""
    check_cross_scores_against_pallas(PARAMS["dna_affine"], alg)


@pytest.mark.parametrize("name", ["dna_default", "dna_affine"])
def test_map_reads_equals_jax(name):
    rng = np.random.default_rng(4)
    params = AlignmentParameters() if name == "dna_default" else AFFINE_DNA
    panel = _panel_with_duplicates(rng, 9, 40)
    src = rng.integers(0, 9, size=12)
    off = rng.integers(0, 40 - 18, size=12)
    reads = panel[src[:, None], off[:, None] + np.arange(18)]
    reads[::3] = np.where(rng.random((4, 18)) < 0.1, np.uint8(5), reads[::3])
    reads[1::2] = reverse_complement_codes(reads[1::2])
    reads[5, 15:] = 0                   # trailing padding
    for tie in TieBreak:
        for max_pairs in (1 << 20, 30):
            got = search.map_reads(reads, panel, params, device="cpu", max_pairs=max_pairs,
                                   tie=tie)
            want = jax_search.map_reads(reads, panel, _jp(params), impl="xla",
                                        max_pairs=max_pairs, backend="oracle",
                                        tie=JaxTieBreak(int(tie)))
            for field in ("index", "score", "strand", "mapq"):
                np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
                assert getattr(got, field).dtype == getattr(want, field).dtype
            _same_alignments(got.alignments, want.alignments)
    got = search.map_reads(reads, panel, params, device="cpu", align=False, both_strands=False)
    want = jax_search.map_reads(reads, panel, _jp(params), impl="xla", align=False,
                                both_strands=False)
    assert got.alignments is None and want.alignments is None
    np.testing.assert_array_equal(got.mapq, want.mapq)


def test_map_read_pairs_equals_jax():
    rng = np.random.default_rng(5)
    panel = _panel_with_duplicates(rng, 7, 60)
    src = rng.integers(0, 7, size=6)
    mate1 = panel[src, 2:20].copy()
    mate2 = reverse_complement_codes(panel[src, 35:55].copy())
    # Fragment 1 in the RF layout: mate 1 reverse, mate 2 forward.
    mate1[1] = reverse_complement_codes(panel[src[1], 35:53])
    mate2[1] = panel[src[1], 2:22]
    for max_pairs in (1 << 20, 24):
        got = search.map_read_pairs(mate1, mate2, panel, device="cpu", max_pairs=max_pairs)
        want = jax_search.map_read_pairs(mate1, mate2, panel, impl="xla",
                                         max_pairs=max_pairs, backend="oracle")
        for field in ("index", "score", "orient", "mapq", "strand1", "strand2"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
        _same_alignments(got.alignments1, want.alignments1)
        _same_alignments(got.alignments2, want.alignments2)
    with pytest.raises(ValueError, match="DNA-only"):
        search.map_read_pairs(mate1, mate2, panel, AlignmentParameters(matrix=PARAMS["matrix"].matrix),
                              device="cpu")
    with pytest.raises(ValueError, match="mate counts"):
        search.map_read_pairs(mate1, mate2[:3], panel, device="cpu")


def _genome(rng, n):
    return rng.integers(1, 5, size=n).astype(np.uint8)


def _check_reference_hits(got, want):
    for field in ("ref_id", "pos", "score", "strand", "mapq"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
        assert getattr(got, field).dtype == getattr(want, field).dtype
    if want.alignments is None:
        assert got.alignments is None
    else:
        _same_alignments(got.alignments, want.alignments)


def test_tile_references_equals_jax():
    rng = np.random.default_rng(7)
    refs = [_genome(rng, 1000), _genome(rng, 300), _genome(rng, 4)]
    for window, stride in ((256, 128), (64, 64), (100, 33)):
        got = refmap.tile_references(refs, window, stride)
        want = jax_refmap.tile_references(refs, window, stride)
        for field in ("windows", "ref_id", "start"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
            assert getattr(got, field).dtype == getattr(want, field).dtype
        assert (got.window, got.stride, got.ref_lengths) == \
            (want.window, want.stride, want.ref_lengths)
    text = "ACGTTGCANNacgt" * 10
    np.testing.assert_array_equal(refmap.tile_references(text, 32, 16).windows,
                                  jax_refmap.tile_references(text, 32, 16).windows)
    assert len(refmap.tile_references([], 32, 16)) == 0
    with pytest.raises(ValueError, match="stride"):
        refmap.tile_references(refs, 64, 65)


def test_map_to_reference_equals_jax_with_planted_reads_and_repeats():
    """Two references, planted reads on both strands, a repeated locus (MAPQ
    0 and the first copy), reads straddling window boundaries, and a small
    max_pairs so the windows stream through several chunks."""
    rng = np.random.default_rng(8)
    chr1, chr2 = _genome(rng, 1500), _genome(rng, 700)
    chr1[900:940] = chr1[100:140]
    m = 40
    pos = [(0, 0), (0, 70), (0, 100), (0, 1460), (1, 233), (1, 500), (1, 660)]
    reads = np.stack([(chr1, chr2)[r][p:p + m] for r, p in pos])
    reads[1::2] = reverse_complement_codes(reads[1::2])
    reads[3, 30:] = 0
    for max_pairs in (1 << 20, 40):
        for tie in TieBreak:
            got = refmap.map_to_reference(reads, [chr1, chr2], device="cpu",
                                          max_pairs=max_pairs, tie=tie)
            want = jax_refmap.map_to_reference(reads, [chr1, chr2], impl="xla",
                                               max_pairs=max_pairs, backend="oracle",
                                               tie=JaxTieBreak(int(tie)))
            _check_reference_hits(got, want)
    assert got.alignments[5].ref_start == 500 and got.ref_id[5] == 1
    assert got.mapq[2] == 0 and got.alignments[2].ref_start == 100
    params = AFFINE_DNA
    got = refmap.map_to_reference(reads, [chr1, chr2], params, device="cpu", window=128,
                                  stride=64, both_strands=False, align=False)
    want = jax_refmap.map_to_reference(reads, [chr1, chr2], _jp(params), impl="xla",
                                       window=128, stride=64, both_strands=False,
                                       align=False)
    _check_reference_hits(got, want)


def test_map_to_reference_ties_keep_the_lowest_window_across_chunks():
    """A motif repeated across many windows: the reported window is the
    first of the tied ones, whatever the chunking."""
    rng = np.random.default_rng(9)
    motif = _genome(rng, 64)
    ref = np.concatenate([_genome(rng, 640), np.tile(motif, 40)])
    read = motif[None, :40]
    for max_pairs in (1 << 20, 3):
        got = refmap.map_to_reference(read, [ref], device="cpu", window=128, stride=64,
                                      both_strands=False, max_pairs=max_pairs)
        want = jax_refmap.map_to_reference(read, [ref], impl="xla", window=128, stride=64,
                                           both_strands=False, max_pairs=max_pairs,
                                           backend="oracle")
        _check_reference_hits(got, want)
        assert int(got.mapq[0]) == 0


def test_window_index_npz_loads_in_both_packages(tmp_path):
    rng = np.random.default_rng(10)
    refs = [_genome(rng, 500), _genome(rng, 300)]
    ours = refmap.tile_references(refs, 128, 64)
    theirs = jax_refmap.tile_references(refs, 128, 64)
    ours.save(tmp_path / "ours.npz")
    theirs.save(tmp_path / "theirs.npz")
    for loaded, original in ((jax_refmap.WindowIndex.load(tmp_path / "ours.npz"), ours),
                             (refmap.WindowIndex.load(tmp_path / "theirs.npz"), theirs)):
        for field in ("windows", "ref_id", "start"):
            np.testing.assert_array_equal(getattr(loaded, field), getattr(original, field))
        assert (loaded.window, loaded.stride, loaded.ref_lengths) == \
            (original.window, original.stride, original.ref_lengths)
    read = refs[1][100:140][None]
    got = refmap.map_to_reference(read, refmap.WindowIndex.load(tmp_path / "theirs.npz"),
                                  device="cpu")
    want = jax_refmap.map_to_reference(read, jax_refmap.WindowIndex.load(tmp_path / "ours.npz"),
                                       impl="xla", backend="oracle")
    _check_reference_hits(got, want)
    assert int(got.ref_id[0]) == 1


def test_map_to_reference_empty_inputs_and_warning_equal_jax():
    rng = np.random.default_rng(11)
    reads = rng.integers(1, 5, size=(2, 30)).astype(np.uint8)
    got = refmap.map_to_reference(reads, [], device="cpu")
    want = jax_refmap.map_to_reference(reads, [], impl="xla")
    _check_reference_hits(got, want)
    with pytest.raises(ValueError, match="DNA-only"):
        refmap.map_to_reference(reads, [_genome(rng, 100)],
                                AlignmentParameters(matrix=PARAMS["matrix"].matrix),
                                device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        refmap.map_to_reference(reads, [_genome(rng, 300)], device="cpu", window=64,
                                stride=60, align=False)
    assert any("overlap" in str(w.message) for w in caught)
