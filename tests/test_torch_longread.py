"""Seed-chain-extend long-read mapping in the port against the JAX package,
with ``==``: minimizers, the chunked index build and chaining array for
array, the ``MinimizerIndex`` npz in both directions, and
``map_long_reads(device="cpu")`` against ``map_long_reads(interpret=True)``
field by field (tests/test_longread.py:78-93's size), and at the default
pad and band slack against the JAX path extended by the banded oracle."""

import dataclasses

import numpy as np
import pytest
import torch

from versalignlib_tpu import longread as jax_longread
from versalignlib_tpu import seed as jax_seed
from versalignlib_tpu.alphabet import reverse_complement
from versalignlib_tpu.ops import banded as jax_banded
from versalignlib_tpu.params import AlignmentParameters as JaxParams
from versalignlib_tpu_torch import (AlignmentParameters, MinimizerIndex, build_index,
                                    find_chains, map_long_reads, minimizers)
from versalignlib_tpu_torch.ops.banded import banded_align_oracle

_BASES = np.array(list("ACGT"))


def _mutate(rng, s, sub=0.04, ind=0.008):
    """tests/test_longread.py's mutator."""
    out = []
    for ch in s:
        r = rng.random()
        if r < ind / 2:
            continue
        if r < ind:
            out.append(str(rng.choice(_BASES)))
        out.append(str(rng.choice(_BASES)) if rng.random() < sub else ch)
    return "".join(out)


def _same_index(a, b):
    for field in ("hashes", "pos", "ref_id", "strand"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y)
    assert (a.k, a.w, tuple(a.ref_lengths)) == (b.k, b.w, tuple(b.ref_lengths))


def test_minimizers_match_jax():
    rng = np.random.default_rng(1)
    seq = "".join(rng.choice(_BASES, size=20_000))
    seq = seq[:300] + "N" * 5 + seq[305:]
    for k, w in ((15, 10), (11, 5)):
        for s in (seq, reverse_complement(seq)):
            for got, want in zip(minimizers(s, k, w), jax_seed.minimizers(s, k, w)):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)


def test_index_chunked_and_npz_both_ways(tmp_path):
    rng = np.random.default_rng(2)
    refs = ["".join(rng.choice(_BASES, size=30_000)), "".join(rng.choice(_BASES, size=7_000))]
    ours = build_index(refs, k=15, w=10, chunk=4096)
    _same_index(ours, jax_seed.build_index(refs, k=15, w=10, chunk=4096))
    _same_index(ours, build_index(refs, k=15, w=10))
    ours.save(tmp_path / "port.npz")
    _same_index(jax_seed.MinimizerIndex.load(tmp_path / "port.npz"), ours)
    jax_seed.build_index(refs[1:], k=13, w=8).save(tmp_path / "jax.npz")
    _same_index(MinimizerIndex.load(tmp_path / "jax.npz"), build_index(refs[1:], k=13, w=8))


def test_find_chains_match_jax():
    rng = np.random.default_rng(3)
    genome = "".join(rng.choice(_BASES, size=20_000))
    unit = genome[5_000:5_600]
    genome2 = genome + unit        # a repeat: a second chain at another locus
    ours = build_index([genome2], k=15, w=10)
    theirs = jax_seed.build_index([genome2], k=15, w=10)
    read = _mutate(rng, genome[8_000:8_400])
    for q in (read, reverse_complement(read), _mutate(rng, unit[50:500]),
              "".join(rng.choice(_BASES, size=300))):
        got = [dataclasses.asdict(c) for c in find_chains(q, ours)]
        want = [dataclasses.asdict(c) for c in jax_longread.find_chains(q, theirs)]
        assert got == want


def _long_reads_case():
    """tests/test_longread.py:78-93's case: two 350 bp reads, the second
    reverse-complemented, and one junk read, against 20 kbp."""
    rng = np.random.default_rng(0)
    genome = "".join(rng.choice(_BASES, size=20_000))
    positions = [2_000, 11_000]
    reads = [_mutate(rng, genome[p:p + 350]) for p in positions]
    reads[1] = reverse_complement(reads[1])
    reads.append("".join(rng.choice(_BASES, size=300)))  # unmapped junk
    return genome, positions, reads


def _same_hits(got, want):
    for field in ("ref_id", "pos", "strand", "score", "mapq", "chain_score"):
        x, y = getattr(got, field), getattr(want, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y)
    assert len(got) == 3 and got.alignments[2] is None and want.alignments[2] is None
    for a, b in zip(got.alignments[:2], want.alignments[:2]):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_map_long_reads_matches_jax():
    genome, positions, reads = _long_reads_case()
    # pad=0 and band_slack=32 keep the Pallas interpreter's extension at a
    # 512-column window (about 35 s instead of 160 s at the defaults).
    got = map_long_reads(reads, [genome], AlignmentParameters(), pad=0, band_slack=32,
                         device="cpu")
    want = jax_longread.map_long_reads(reads, [genome], JaxParams(), pad=0, band_slack=32,
                                       interpret=True)
    _same_hits(got, want)
    for i, p in enumerate(positions):
        assert abs(int(got.pos[i]) - p) < 40 and int(got.strand[i]) == i
    # A prebuilt index gives the same hits, and the default pad and slack
    # the same starts.
    again = map_long_reads(reads, (build_index([genome]), [genome]), device="cpu")
    np.testing.assert_array_equal(again.pos, got.pos)


def test_map_long_reads_defaults_match_jax(monkeypatch):
    # The default pad (256) and band_slack (128) set the bucket length (1024)
    # and the bands (192, 256) the path runs with. The Pallas interpreter
    # takes minutes there, so the JAX side extends through
    # banded_align_oracle, the definition its banded kernel is held to
    # (tests/test_banded.py): the port's copy of it, held == the JAX
    # package's on each call's first pair; bucketing, windows and decoding
    # stay the JAX side's own.
    genome, _, reads = _long_reads_case()
    shapes = []

    def oracle_batch(rd, fd, params, algorithm, band, tie=None, interpret=None):
        shapes.append((rd.shape[1], band))
        out = [banded_align_oracle(r, f, params, band, algorithm, tie=tie)
               for r, f in zip(rd, fd)]
        assert dataclasses.asdict(out[0]) == dataclasses.asdict(
            jax_banded.banded_align_oracle(rd[0], fd[0], params, band, algorithm, tie=tie))
        return out

    monkeypatch.setattr(jax_banded, "banded_align_batch", oracle_batch)
    want = jax_longread.map_long_reads(reads, [genome], JaxParams())
    assert sorted(shapes) == [(1024, 192), (1024, 256)]
    _same_hits(map_long_reads(reads, [genome], AlignmentParameters(), device="cpu"), want)


def test_map_long_reads_guards(monkeypatch):
    with pytest.raises(ValueError, match="DNA-only"):
        map_long_reads(["ACGT"], ["ACGT"], AlignmentParameters(
            score_gap_read=-3, score_gap_ref=-3, matrix=((0, 0), (0, 2))), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        map_long_reads(["ACGT"], ["ACGT"])
