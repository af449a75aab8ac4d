"""The port's copies of the numpy substrate against the JAX package's
originals: parameters, enums and encoding."""

import dataclasses

import numpy as np
import pytest

from versalignlib_tpu import alphabet as jax_alphabet
from versalignlib_tpu import params as jax_params
from versalignlib_tpu import types as jax_types
from versalignlib_tpu_torch import alphabet, params, types

_SETS = {
    "default": jax_params.DEFAULT_PARAMETERS,
    "custom_linear": jax_params.AlignmentParameters(
        score_match=3, score_mismatch=-2, score_gap_read=-1, score_gap_ref=-2),
    "affine": jax_params.AlignmentParameters(
        score_match=2, score_mismatch=-1, score_gap_read=-1, score_gap_ref=-1,
        gap_open_read=-4, gap_open_ref=-5),
    "blosum62": jax_params.AlignmentParameters(
        score_gap_read=-1, score_gap_ref=-1, gap_open_read=-10,
        gap_open_ref=-10, matrix=jax_alphabet.blosum62()),
}


@pytest.mark.parametrize("name", sorted(_SETS))
def test_params_from_reference_field_for_field(name):
    ref = _SETS[name]
    got = params.params_from_reference(dataclasses.asdict(ref))
    assert isinstance(got, params.AlignmentParameters)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ref):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name
    assert got.affine == ref.affine
    assert got.sub_size == ref.sub_size
    assert got == params.AlignmentParameters(**dataclasses.asdict(ref))


def test_params_from_reference_takes_numpy_values_and_rejects_unknown_keys():
    fields = dataclasses.asdict(_SETS["custom_linear"])
    fields = {k: (np.int64(v) if v is not None else None) for k, v in fields.items()}
    got = params.params_from_reference(fields)
    assert got.score_match == 3 and type(got.score_match) is int
    with pytest.raises(ValueError):
        params.params_from_reference({**fields, "bogus": 1})
    missing = dict(fields)
    del missing["score_gap_ref"]
    with pytest.raises(ValueError):
        params.params_from_reference(missing)


def test_default_parameters_and_validation_match():
    assert dataclasses.asdict(params.DEFAULT_PARAMETERS) == \
        dataclasses.asdict(jax_params.DEFAULT_PARAMETERS)
    for bad in ({"score_gap_read": 1}, {"gap_open_ref": 2},
                {"matrix": ((1, 0), (0, 1))}):
        with pytest.raises(ValueError):
            jax_params.AlignmentParameters(**bad)
        with pytest.raises(ValueError):
            params.AlignmentParameters(**bad)


@pytest.mark.parametrize("enum_name", ["Algorithm", "TieBreak", "Trace"])
def test_enums_match_by_name_and_value(enum_name):
    ours = getattr(types, enum_name)
    theirs = getattr(jax_types, enum_name)
    assert [(e.name, int(e)) for e in ours] == [(e.name, int(e)) for e in theirs]


def test_pad_and_encode_matches():
    seqs = ["ACGTacgtNn", "xyz-ACG", "", "gattacaRYKM", b"TTNNaa", "A"]
    got = alphabet.pad_and_encode(seqs)
    want = jax_alphabet.pad_and_encode(seqs)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(alphabet.pad_and_encode(seqs, length=16),
                                  jax_alphabet.pad_and_encode(seqs, length=16))
    for s in seqs:
        np.testing.assert_array_equal(alphabet.encode(s), jax_alphabet.encode(s))


@pytest.mark.parametrize("matrix", [None, "blosum62"])
def test_make_validity_matches(matrix):
    m = jax_alphabet.blosum62() if matrix else None
    codes = np.arange(-1, 30, dtype=np.int32)
    np.testing.assert_array_equal(alphabet.make_validity(m)(codes),
                                  jax_alphabet.make_validity(m)(codes))
