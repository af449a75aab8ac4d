"""The generator draws the same bytes from the same seed, and what the
configurations describe."""

import numpy as np
import pytest

from vbench import gen

PAIRS = {"pad_to": 512, "length_min": 128, "length_max": 512, "n_rate": 0.02, "sub_rate": 0.02}
READS = {"length": 150, "sub_rate": 0.01, "n_rate": 0.02, "reverse_rate": 0.5}


def test_same_seed_same_bytes_other_seed_other_bytes():
    seed = 2 ** 31 + 12345
    a = gen.make_pairs(gen.rng_for(seed, gen.PAIRS, 0), PAIRS, 64)
    b = gen.make_pairs(gen.rng_for(seed, gen.PAIRS, 0), PAIRS, 64)
    c = gen.make_pairs(gen.rng_for(seed + 1, gen.PAIRS, 0), PAIRS, 64)
    d = gen.make_pairs(gen.rng_for(seed, gen.PAIRS, 1), PAIRS, 64)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0]) and not np.array_equal(a[0], d[0])
    ref = gen.make_reference(gen.rng_for(seed, gen.REFERENCE), {"length": 5000})
    again = gen.make_reference(gen.rng_for(seed, gen.REFERENCE), {"length": 5000})
    assert ref.tobytes() == again.tobytes()
    r1 = gen.make_reads(gen.rng_for(seed, gen.READS, 0), READS, ref, 20)["reads"]
    r2 = gen.make_reads(gen.rng_for(seed, gen.READS, 0), READS, ref, 20)["reads"]
    assert r1.tobytes() == r2.tobytes()


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 3, 2 ** 40, -5])
def test_any_whole_number_seeds(seed):
    assert gen.rng_for(seed, gen.PAIRS).integers(0, 10, 4).shape == (4,)


def test_pairs_lengths_codes_and_sharing():
    reads, refs = gen.make_pairs(gen.rng_for(1, gen.PAIRS), PAIRS, 4000)
    for codes in (reads, refs):
        lens = gen.lengths(codes)
        assert codes.shape == (4000, 512) and codes.dtype == np.uint8
        assert lens.min() >= 128 and lens.max() <= 512
        body = codes[np.arange(512)[None, :] < lens[:, None]]
        assert set(np.unique(body)) <= {1, 2, 3, 4, 5}
        assert 0.01 < (body == 5).mean() < 0.03
        assert (codes[np.arange(512)[None, :] >= lens[:, None]] == 0).all()
    # Most reads copy part of their ref: their scores are far above those
    # of a read against another pair's ref.
    from vbench import reference

    sc = reference.Scoring(2, -1, -3, -3)
    own = reference.pair_scores(reads[:200], refs[:200], sc)
    other = reference.pair_scores(reads[:200], np.roll(refs[:200], 1, axis=0), sc)
    assert np.median(own) > 3 * np.median(other) and (own > 127).mean() > 0.75


def test_reads_come_from_their_place():
    ref = gen.make_reference(gen.rng_for(3, gen.REFERENCE), {"length": 20000})
    got = gen.make_reads(gen.rng_for(3, gen.READS), READS, ref, 400)
    reads = got["reads"].copy()
    reads[got["reverse"]] = gen.reverse_complement(reads[got["reverse"]])
    truth = ref[got["offset"][:, None] + np.arange(150)[None, :]]
    same = (reads == truth) | (reads == 5)
    assert same.mean() > 0.985 and 0.4 < got["reverse"].mean() < 0.6


def test_reverse_complement_keeps_padding_at_the_end():
    codes = np.array([[1, 3, 5, 4, 0, 0], [2, 2, 1, 3, 4, 1], [0, 0, 0, 0, 0, 0]], np.uint8)
    rc = gen.reverse_complement(codes)
    assert rc.tolist() == [[3, 5, 4, 2, 0, 0], [2, 3, 4, 2, 1, 1], [0] * 6]
    assert np.array_equal(gen.reverse_complement(rc), codes)
