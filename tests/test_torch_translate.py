"""Six-frame translated search in the port against the JAX package:
``translated_search`` with alignments and a calibration, the chunked fold,
the translation helpers and ``calibrate_translated`` on the CPU, field by
field. The JAX side aligns the winners with its Pallas kernel in interpret
mode. Inputs come from a seeded numpy generator; tolerance 0."""

import dataclasses

import numpy as np
import pytest

from tests.test_torch_search import _same_alignments
from versalignlib_tpu import stats as jax_stats
from versalignlib_tpu import translate as jax_translate
from versalignlib_tpu_torch import stats, translate
from versalignlib_tpu_torch.alphabet import PROTEIN_ALPHABET, encode_custom
from versalignlib_tpu_torch.params import AlignmentParameters


def _translated_inputs(rng):
    from versalignlib_tpu_torch.alphabet import pad_and_encode, reverse_complement_codes

    codon = {aa: c for c, aa in translate.GENETIC_CODE.items()}
    proteins = ["".join(rng.choice(list(PROTEIN_ALPHABET[:20]), size=int(n)))
                for n in rng.integers(14, 22, size=5)]
    frags = [proteins[1][2:11], proteins[3][4:12], proteins[0][:8]]
    reads = pad_and_encode(["".join(codon[a] for a in f) + "AC" for f in frags])
    reads[1] = reverse_complement_codes(reads[1])
    reads[2, 20:] = 0                   # a shorter read, padded
    return reads, proteins


def test_translated_search_with_alignments_equals_jax():
    rng = np.random.default_rng(15)
    reads, proteins = _translated_inputs(rng)
    panel = encode_custom(proteins, PROTEIN_ALPHABET)
    cal = stats.GumbelCalibration(lam=0.3, k=0.05, m=10, n=20, samples=1)
    got = translate.translated_search(reads, proteins, device="cpu", alignments=True,
                                      calibration=cal)
    want = jax_translate.translated_search(reads, proteins, impl="xla", alignments=True,
                                           calibration=jax_stats.GumbelCalibration(
                                               **dataclasses.asdict(cal)))
    for field in ("index", "frame", "score", "scores", "dna_start", "dna_end", "strand",
                  "evalue", "bitscore"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert got.proteins == want.proteins and got.dna_cigar == want.dna_cigar
    _same_alignments(got.alignments, want.alignments)
    assert list(got.index) == [1, 3, 0] and list(got.frame[:2]) == [1, -1]
    chunked = translate.translated_search(reads, panel, device="cpu", panel_chunk=2)
    assert chunked.scores is None
    for field in ("index", "frame", "score"):
        np.testing.assert_array_equal(getattr(chunked, field), getattr(got, field))
    with pytest.raises(ValueError, match="matrix"):
        translate.translated_search(reads, panel, AlignmentParameters(), device="cpu")


def test_translation_helpers_equal_jax():
    rng = np.random.default_rng(16)
    codes = rng.integers(0, 6, size=31).astype(np.uint8)
    for f in translate.FRAMES:
        assert translate.translate_codes(codes, f) == jax_translate.translate_codes(codes, f)
    assert translate.translate_six_frames("ATGGCCNTTTAAGG") == \
        jax_translate.translate_six_frames("ATGGCCNTTTAAGG")
    for args in ((1, 30, 2, 5), (-2, 31, 0, 4), (-3, 17, 1, 1)):
        assert translate.map_protein_to_dna(*args) == jax_translate.map_protein_to_dna(*args)
    assert translate._scale_cigar_dna("3M1I12M2D") == jax_translate._scale_cigar_dna("3M1I12M2D")
    assert dataclasses.asdict(translate.TRANSLATED_PARAMETERS) == \
        dataclasses.asdict(jax_translate.TRANSLATED_PARAMETERS)


def test_calibrate_translated_equals_jax():
    rng = np.random.default_rng(17)
    panel = encode_custom(["".join(rng.choice(list(PROTEIN_ALPHABET[:20]), size=15))
                           for _ in range(3)], PROTEIN_ALPHABET)
    got = translate.calibrate_translated(panel, read_len=30, samples=12, device="cpu")
    want = jax_translate.calibrate_translated(panel, read_len=30, samples=12, impl="xla")
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
