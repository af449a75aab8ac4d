"""The benchmark's one generator: sequences and references drawn from
``--seed`` as a configuration and a traffic mix describe them.

Codes are the port's: 0 padding, 1-4 A/T/C/G, 5 N. Every draw takes its own
stream of the seed (:func:`rng_for`), so that a pool of a different size
leaves the batches it shares with a smaller one as they were, and the data
of a configuration never depends on the order in which a cell asks for it.

The draws follow ``chip_smoke.py``'s (``random_codes``, ``_substitute``,
``make_map_reads``, ``make_genome``), with substitutions and N taken from
one uniform draw a code; the copies here are frozen, so a later change to
that script moves no cell.
"""

from __future__ import annotations

import numpy as np

#: Complement of each code: A(1) <-> T(2), C(3) <-> G(4); padding and N
#: map to themselves.
COMPLEMENT = np.array([0, 2, 1, 4, 3, 5], dtype=np.uint8)

#: Named streams of a seed (:func:`rng_for`).
PAIRS, REFERENCE, READS, SAMPLE = 1, 2, 3, 4


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """The generator of ``stream`` under ``seed``; any whole number is a
    seed (negative ones are taken modulo 2**64)."""
    return np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), *stream]))


def bases(rng: np.random.Generator, shape) -> np.ndarray:
    """Uniform A/C/G/T codes."""
    return rng.integers(1, 5, size=shape, dtype=np.uint8)


def mutate(rng: np.random.Generator, codes: np.ndarray, sub_rate: float, n_rate: float,
           size: int = 4) -> np.ndarray:
    """About ``sub_rate`` of the codes (1..size) replaced with another code
    and about ``n_rate`` of the others with N (5), from one uniform draw a
    code."""
    u = rng.random(codes.shape, dtype=np.float32)
    shift = np.minimum(u * np.float32((size - 1) / max(sub_rate, 1e-30)), size - 2)
    other = codes + (shift.astype(np.uint8) + np.uint8(1))
    other = np.where(other > size, other - np.uint8(size), other)
    out = np.where(u < sub_rate, other, codes)
    return np.where((u >= sub_rate) & (u < sub_rate + n_rate), np.uint8(5), out)


def lengths(codes: np.ndarray) -> np.ndarray:
    """Each row's length without its trailing padding (code 0)."""
    nonzero = codes != 0
    return np.where(nonzero.any(axis=1),
                    codes.shape[1] - np.argmax(nonzero[:, ::-1], axis=1), 0).astype(np.int64)


def reverse_complement(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of each row's valid prefix; the padding stays at
    the end."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.shape[1]
    lens = lengths(codes)
    src = lens[:, None] - 1 - np.arange(n)[None, :]
    out = COMPLEMENT[np.take_along_axis(codes, np.clip(src, 0, n - 1), axis=1)]
    return np.where(src >= 0, out, np.uint8(0)).astype(np.uint8)


def pad_tail(codes: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """``codes`` with every position at or past its row's length set to 0."""
    keep = np.arange(codes.shape[1])[None, :] < np.asarray(lens)[:, None]
    return np.where(keep, codes, np.uint8(0)).astype(np.uint8)


def make_pairs(rng: np.random.Generator, spec: dict, count: int) -> tuple[np.ndarray, np.ndarray]:
    """``count`` (read, ref) pairs as a configuration's ``pairs`` block
    describes them: each ref a prefix of a random source of ``pad_to``
    bases, each read a copy of a window of the same source with
    ``sub_rate`` substitutions; both of uniform random length in
    [``length_min``, ``length_max``], with ``n_rate`` N, padded with 0 to
    ``pad_to``. A read whose window starts past its ref's end shares no
    bases with it."""
    width = spec["pad_to"]
    lo, hi = spec["length_min"], spec["length_max"]
    source = bases(rng, (count, width))
    ref_len = rng.integers(lo, hi + 1, size=count)
    read_len = rng.integers(lo, hi + 1, size=count)
    offset = rng.integers(0, width - read_len + 1)
    cols = np.minimum(offset.astype(np.int32)[:, None] + np.arange(width, dtype=np.int32),
                      width - 1)
    read = mutate(rng, np.take_along_axis(source, cols, axis=1), spec["sub_rate"],
                  spec["n_rate"])
    ref = mutate(rng, source, 0.0, spec["n_rate"])
    return pad_tail(read, read_len), pad_tail(ref, ref_len)


def make_reference(rng: np.random.Generator, spec: dict) -> np.ndarray:
    """A reference as a configuration's ``references`` entry describes it:
    one random sequence of ``spec["length"]``."""
    return bases(rng, spec["length"])


def make_reads(rng: np.random.Generator, spec: dict, reference: np.ndarray,
               count: int) -> dict:
    """``count`` reads of ``spec["length"]`` drawn from ``reference``: a
    uniform offset, ``sub_rate`` substitutions and ``n_rate`` N, and about
    ``reverse_rate`` of them reverse-complemented. Returns the reads with
    where each came from (``offset``, ``reverse``)."""
    length = spec["length"]
    offset = rng.integers(0, reference.size - length + 1, size=count)
    reads = reference[offset[:, None] + np.arange(length)[None, :]]
    reads = mutate(rng, reads, spec["sub_rate"], spec["n_rate"])
    reverse = rng.random(count) < spec["reverse_rate"]
    reads[reverse] = reverse_complement(reads[reverse])
    return {"reads": reads, "offset": offset, "reverse": reverse}
