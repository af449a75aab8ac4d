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


def test_reverse_complement_and_decode_match():
    rng = np.random.default_rng(20)
    codes = rng.integers(0, 6, size=(7, 15)).astype(np.uint8)
    codes[2, 9:] = 0
    codes[4] = 0
    np.testing.assert_array_equal(alphabet.reverse_complement_codes(codes),
                                  jax_alphabet.reverse_complement_codes(codes))
    np.testing.assert_array_equal(alphabet.reverse_complement_codes(codes[2]),
                                  jax_alphabet.reverse_complement_codes(codes[2]))
    with pytest.raises(ValueError, match="DNA"):
        alphabet.reverse_complement_codes(np.array([1, 6], np.uint8))
    for seq in ("ACGTNacgtn-xy", ""):
        assert alphabet.reverse_complement(seq) == jax_alphabet.reverse_complement(seq)
    for row in codes:
        assert alphabet.decode(row) == jax_alphabet.decode(row)
    assert alphabet.decode(np.array([1, 9, 3, 0, 0], np.uint8)) == \
        jax_alphabet.decode(np.array([1, 9, 3, 0, 0], np.uint8))
    a, b = rng.integers(0, 30, size=(2, 40))
    for matrix in (None, jax_alphabet.blosum62()):
        np.testing.assert_array_equal(
            alphabet.substitution_scores(a, b, 3, -2, matrix),
            jax_alphabet.substitution_scores(a, b, 3, -2, matrix))


@pytest.mark.parametrize("lo,hi,s", [(-4, 11, 6), (-60, 100, 25), (0, 3, 9)])
def test_pack_pssm_and_sub_plane_match(lo, hi, s):
    from versalignlib_tpu.ops import pssm as jax_pssm
    from versalignlib_tpu_torch.ops import pssm

    rng = np.random.default_rng(21)
    P = rng.integers(lo, hi + 1, size=(5, s)).astype(np.int32)
    P[:, 0] = 0
    words, meta = pssm.pack_pssm(P)
    j_words, j_meta = jax_pssm.pack_pssm(P)
    np.testing.assert_array_equal(words, j_words)
    assert tuple(meta) == tuple(j_meta)
    Q = P.copy()
    Q[:, 1:] = -Q[:, 1:]
    words, meta = pssm.pack_pssms([P, Q])
    j_words, j_meta = jax_pssm.pack_pssms([P, Q])
    np.testing.assert_array_equal(words, j_words)
    assert tuple(meta) == tuple(j_meta)
    ref = rng.integers(0, s + 5, size=17)
    np.testing.assert_array_equal(pssm.profile_sub_plane(P, ref),
                                  jax_pssm.profile_sub_plane(P, ref))
    for bad in (np.zeros(4, np.int32), np.ones((3, 6), np.int32)):
        with pytest.raises(ValueError):
            pssm.validate_pssm(bad)
        with pytest.raises(ValueError):
            jax_pssm.validate_pssm(bad)
    with pytest.raises(ValueError, match="span"):
        pssm.pack_pssm(np.array([[0, -300, 300]]))


@pytest.mark.parametrize("affine", [False, True], ids=["linear", "affine"])
def test_copied_oracle_fills_and_walks_match(affine):
    """The host fills, pointers and walks that the profile traceback uses,
    with and without a substitution plane, SW and the NW traceback variant,
    both tie flavors."""
    from versalignlib_tpu.ops import gotoh as jax_gotoh
    from versalignlib_tpu.ops import oracle as jax_oracle
    from versalignlib_tpu_torch.ops import gotoh, oracle

    rng = np.random.default_rng(22)
    p = _SETS["affine" if affine else "custom_linear"]
    ours = params.params_from_reference(dataclasses.asdict(p))
    read = rng.integers(0, 6, size=13)
    ref = rng.integers(0, 6, size=17)
    plane = rng.integers(-5, 6, size=(13, 17)).astype(np.int32)
    for local in (True, False):
        for sub in (None, plane):
            kw = dict(local=local, col0_penalty=not local, sub=sub)
            if affine:
                got = gotoh._fill_affine(read, ref, ours, **kw)
                want = jax_gotoh._fill_affine(read, ref, p, **kw)
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_array_equal(oracle._fill_matrix(read, ref, ours, **kw),
                                              jax_oracle._fill_matrix(read, ref, p, **kw))
    sub = jax_alphabet.substitution_scores(read[:, None], ref[None, :], p.score_match,
                                           p.score_mismatch, p.matrix)
    valid = jax_alphabet.make_validity(None)
    valid_comp = valid(read)[:, None] & valid(ref)[None, :]
    for local in (True, False):
        for tie in types.TieBreak:
            jtie = jax_types.TieBreak(int(tie))
            if affine:
                h, e, f = jax_gotoh._fill_affine(read, ref, p, local=local,
                                                 col0_penalty=not local)
                ptr = gotoh._affine_pointers(h, e, f, sub, ours, local=local, tie=tie,
                                             valid_comp=valid_comp)
                want = jax_gotoh._affine_pointers(h, e, f, sub, p, local=local, tie=jtie,
                                                  valid_comp=valid_comp)
                np.testing.assert_array_equal(ptr, want)
                args = (read, ref, ptr, 12, 15, int(h[13, 16]))
                got = gotoh._affine_traceback(*args, nw_boundary=not local)
                want = jax_gotoh._affine_traceback(*args, nw_boundary=not local)
            else:
                h = jax_oracle._fill_matrix(read, ref, p, local=local, col0_penalty=not local)
                ptr = oracle._pointers(h, sub, valid_comp, ours, local=local, tie=tie)
                want = jax_oracle._pointers(h, sub, valid_comp, p, local=local, tie=jtie)
                np.testing.assert_array_equal(ptr, want)
                args = (read, ref, ptr, 12, 15, int(h[13, 16]))
                got = oracle._traceback(*args)
                want = jax_oracle._traceback(*args)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert oracle._text_from_codes(read) == jax_oracle._text_from_codes(read)
