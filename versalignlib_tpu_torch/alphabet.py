"""Sequence encoding: ASCII bases -> small integer codes.

The port's copy of what the alignment and search paths need from
``versalignlib_tpu/alphabet.py``: encoding and decoding, substitution
scores, the padding-aware reverse complement, protein encoding and
BLOSUM62. It replicates the reference's 256-entry
``char_to_score`` table (DefaultKernel.h:43-60): case-insensitive A->1, T->2,
C->3, G->4, N->5, everything else (including the ``'\\0'`` batch padding)
-> 0. Codes 0 and 5 score zero against everything (DefaultKernel.h:83-96),
so code 0 doubles as the padding sentinel.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

#: Number of distinct codes (SCORE_CASE, DefaultKernel.h:27).
NUM_CODES = 6
#: Code for padding / non-ACGTN characters.
INVALID = 0
#: Code for the ambiguous base N (scores zero but is NOT padding).
N_CODE = 5

_CHAR_TO_CODE = np.zeros(256, dtype=np.uint8)
for _ch, _code in (("A", 1), ("T", 2), ("C", 3), ("G", 4), ("N", 5)):
    _CHAR_TO_CODE[ord(_ch)] = _code
    _CHAR_TO_CODE[ord(_ch.lower())] = _code

_CODE_TO_CHAR = np.frombuffer(b"\0ATCGN", dtype=np.uint8).copy()


def encode(seq: str | bytes) -> np.ndarray:
    """Encode one sequence to a uint8 code array."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    return _CHAR_TO_CODE[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    """Decode a code array back to characters (padding -> '\\0' stripped)."""
    codes = np.asarray(codes, dtype=np.uint8)
    chars = _CODE_TO_CHAR[np.clip(codes, 0, NUM_CODES - 1)]
    return chars.tobytes().rstrip(b"\0").decode("ascii")


def pad_and_encode(
    seqs: Sequence[str | bytes], length: int | None = None
) -> np.ndarray:
    """Encode a batch, padding every sequence with code 0 to a uniform length
    (the reference's ``pad()``, versalignUtil.cpp:17-33). Returns a
    ``(n, length)`` uint8 array."""
    encoded = [encode(s) for s in seqs]
    maxlen = max((e.size for e in encoded), default=0)
    if length is None:
        length = maxlen
    elif length < maxlen:
        raise ValueError(f"length={length} < longest sequence ({maxlen})")
    out = np.zeros((len(encoded), length), dtype=np.uint8)
    for i, e in enumerate(encoded):
        out[i, : e.size] = e
    return out


def base_score_matrix(score_match: int, score_mismatch: int) -> np.ndarray:
    """The 6x6 substitution matrix (DefaultKernel.h:83-96), int32."""
    m = np.full((NUM_CODES, NUM_CODES), score_mismatch, dtype=np.int32)
    np.fill_diagonal(m, score_match)
    m[INVALID, :] = 0
    m[:, INVALID] = 0
    m[N_CODE, :] = 0
    m[:, N_CODE] = 0
    return m


def is_valid_base(codes):
    """True for A/T/C/G codes (1..4); False for padding (0) and N (5)."""
    return (codes >= 1) & (codes <= 4)


def substitution_scores(read_codes, ref_codes, score_match: int,
                        score_mismatch: int, matrix=None):
    """Substitution score of numpy code arrays, broadcasting: the default
    DNA table as arithmetic, or ``matrix[read][ref]`` with codes outside
    [0, S) read as code 0 (score 0)."""
    a = read_codes.astype(np.int32) if hasattr(read_codes, "astype") else read_codes
    b = ref_codes.astype(np.int32) if hasattr(ref_codes, "astype") else ref_codes
    if matrix is not None:
        m = np.asarray(matrix, dtype=np.int32)
        s = m.shape[0]
        return m[np.where((a >= 0) & (a < s), a, 0), np.where((b >= 0) & (b < s), b, 0)]
    valid = is_valid_base(a) & is_valid_base(b)
    sub = np.where(a == b, np.int32(score_match), np.int32(score_mismatch))
    return np.where(valid, sub, np.int32(0))


#: Complement permutation over the DNA codes: A(1)<->T(2), C(3)<->G(4);
#: padding (0) and N (5) map to themselves.
_COMPLEMENT = np.array([0, 2, 1, 4, 3, 5], dtype=np.uint8)

_COMPLEMENT_CHARS = np.arange(256, dtype=np.uint8)
for _a, _b in (("A", "T"), ("C", "G")):
    _COMPLEMENT_CHARS[ord(_a)] = ord(_b)
    _COMPLEMENT_CHARS[ord(_b)] = ord(_a)
    _COMPLEMENT_CHARS[ord(_a.lower())] = ord(_b.lower())
    _COMPLEMENT_CHARS[ord(_b.lower())] = ord(_a.lower())


def reverse_complement(seq: str) -> str:
    """Reverse complement of a DNA string (case preserved; N and unknown
    characters map to themselves)."""
    raw = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
    return _COMPLEMENT_CHARS[raw][::-1].tobytes().decode("latin-1")


def reverse_complement_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of encoded DNA, padding-aware.

    ``codes`` is (L,) or (B, L) uint8 with trailing 0-padding; each row's
    valid prefix is complemented and reversed in place, so the padding stays
    at the end. Codes > 5 are rejected: complementation is a DNA notion.
    """
    codes = np.asarray(codes, dtype=np.uint8)
    if codes.max(initial=0) > 5:
        raise ValueError("reverse_complement_codes is defined for the DNA "
                         "code table (codes 0..5) only")
    single = codes.ndim == 1
    arr = codes[None, :] if single else codes
    out = np.zeros_like(arr)
    comp = _COMPLEMENT[arr]
    lengths = np.where((arr != 0).any(axis=1),
                       arr.shape[1] - np.argmax((arr != 0)[:, ::-1], axis=1), 0)
    for i, length in enumerate(lengths):
        out[i, :length] = comp[i, :length][::-1]
    return out[0] if single else out


def valid_code_mask(matrix=None) -> np.ndarray:
    """(S,) bool: code can contribute a nonzero substitution score — the SSE
    flavor's "both bases A/C/G/T" DIAG gate (SSEKernel.cpp:364-379),
    generalised to a custom S x S matrix."""
    m = base_score_matrix(1, -1) if matrix is None else np.asarray(matrix, np.int64)
    return (m != 0).any(axis=1) | (m != 0).any(axis=0)


def make_validity(matrix=None):
    """Elementwise validity predicate over code arrays (numpy or torch):
    :func:`valid_code_mask` as pure comparisons. Codes outside [0, S) are
    invalid."""
    idx = np.flatnonzero(valid_code_mask(matrix))
    if idx.size == 0:
        return lambda c: c < 0  # all-False of the right shape and type
    if idx.size == idx[-1] - idx[0] + 1:  # contiguous range (the common case)
        lo, hi = int(idx[0]), int(idx[-1])
        return lambda c: (c >= lo) & (c <= hi)

    def f(c):
        v = c < 0
        for s in idx:
            v = v | (c == int(s))
        return v

    return f


# ---------------------------------------------------------------------------
# Generic alphabets (ADDITIVE: the reference only knows the DNA table)
# ---------------------------------------------------------------------------

def encode_custom(
    seqs: Sequence[str | bytes], alphabet: str, length: int | None = None,
    case_sensitive: bool = False,
) -> np.ndarray:
    """Encode a batch against a custom alphabet: ``alphabet[i]`` -> code i+1
    (code 0 stays the padding/unknown sentinel). Pads with 0 to the batch max
    (or ``length``), mirroring :func:`pad_and_encode`.
    """
    table = np.zeros(256, dtype=np.uint8)
    for i, ch in enumerate(alphabet):
        code = i + 1
        table[ord(ch)] = code
        if not case_sensitive:
            table[ord(ch.lower())] = code
            table[ord(ch.upper())] = code
    encoded = []
    for s in seqs:
        if isinstance(s, str):
            s = s.encode("ascii", errors="replace")
        encoded.append(table[np.frombuffer(s, dtype=np.uint8)])
    maxlen = max((e.size for e in encoded), default=0)
    if length is None:
        length = maxlen
    elif length < maxlen:
        raise ValueError(f"length={length} < longest sequence ({maxlen})")
    out = np.zeros((len(encoded), length), dtype=np.uint8)
    for i, e in enumerate(encoded):
        out[i, : e.size] = e
    return out


#: Standard protein alphabet order used by :func:`blosum62` (codes 1..24).
PROTEIN_ALPHABET = "ARNDCQEGHILKMFPSTWYVBZX*"

#: BLOSUM62 substitution scores (Henikoff & Henikoff 1992), row/col order =
#: PROTEIN_ALPHABET. Public-domain matrix as distributed with NCBI BLAST.
_BLOSUM62 = [
    # A  R  N  D  C  Q  E  G  H  I  L  K  M  F  P  S  T  W  Y  V  B  Z  X  *
    [4, -1, -2, -2, 0, -1, -1, 0, -2, -1, -1, -1, -1, -2, -1, 1, 0, -3, -2, 0, -2, -1, 0, -4],
    [-1, 5, 0, -2, -3, 1, 0, -2, 0, -3, -2, 2, -1, -3, -2, -1, -1, -3, -2, -3, -1, 0, -1, -4],
    [-2, 0, 6, 1, -3, 0, 0, 0, 1, -3, -3, 0, -2, -3, -2, 1, 0, -4, -2, -3, 3, 0, -1, -4],
    [-2, -2, 1, 6, -3, 0, 2, -1, -1, -3, -4, -1, -3, -3, -1, 0, -1, -4, -3, -3, 4, 1, -1, -4],
    [0, -3, -3, -3, 9, -3, -4, -3, -3, -1, -1, -3, -1, -2, -3, -1, -1, -2, -2, -1, -3, -3, -2, -4],
    [-1, 1, 0, 0, -3, 5, 2, -2, 0, -3, -2, 1, 0, -3, -1, 0, -1, -2, -1, -2, 0, 3, -1, -4],
    [-1, 0, 0, 2, -4, 2, 5, -2, 0, -3, -3, 1, -2, -3, -1, 0, -1, -3, -2, -2, 1, 4, -1, -4],
    [0, -2, 0, -1, -3, -2, -2, 6, -2, -4, -4, -2, -3, -3, -2, 0, -2, -2, -3, -3, -1, -2, -1, -4],
    [-2, 0, 1, -1, -3, 0, 0, -2, 8, -3, -3, -1, -2, -1, -2, -1, -2, -2, 2, -3, 0, 0, -1, -4],
    [-1, -3, -3, -3, -1, -3, -3, -4, -3, 4, 2, -3, 1, 0, -3, -2, -1, -3, -1, 3, -3, -3, -1, -4],
    [-1, -2, -3, -4, -1, -2, -3, -4, -3, 2, 4, -2, 2, 0, -3, -2, -1, -2, -1, 1, -4, -3, -1, -4],
    [-1, 2, 0, -1, -3, 1, 1, -2, -1, -3, -2, 5, -1, -3, -1, 0, -1, -3, -2, -2, 0, 1, -1, -4],
    [-1, -1, -2, -3, -1, 0, -2, -3, -2, 1, 2, -1, 5, 0, -2, -1, -1, -1, -1, 1, -3, -1, -1, -4],
    [-2, -3, -3, -3, -2, -3, -3, -3, -1, 0, 0, -3, 0, 6, -4, -2, -2, 1, 3, -1, -3, -3, -1, -4],
    [-1, -2, -2, -1, -3, -1, -1, -2, -2, -3, -3, -1, -2, -4, 7, -1, -1, -4, -3, -2, -2, -1, -2, -4],
    [1, -1, 1, 0, -1, 0, 0, 0, -1, -2, -2, 0, -1, -2, -1, 4, 1, -3, -2, -2, 0, 0, 0, -4],
    [0, -1, 0, -1, -1, -1, -1, -2, -2, -1, -1, -1, -1, -2, -1, 1, 5, -2, -2, 0, -1, -1, 0, -4],
    [-3, -3, -4, -4, -2, -2, -3, -2, -2, -3, -2, -3, -1, 1, -4, -3, -2, 11, 2, -3, -4, -3, -2, -4],
    [-2, -2, -2, -3, -2, -1, -2, -3, 2, -1, -1, -2, -1, 3, -3, -2, -2, 2, 7, -1, -3, -2, -1, -4],
    [0, -3, -3, -3, -1, -2, -2, -3, -3, 3, 1, -2, 1, -1, -2, -2, 0, -3, -1, 4, -3, -2, -1, -4],
    [-2, -1, 3, 4, -3, 0, 1, -1, 0, -3, -4, 0, -3, -3, -2, 0, -1, -4, -3, -3, 4, 1, -1, -4],
    [-1, 0, 0, 1, -3, 3, 4, -2, 0, -3, -3, 1, -1, -3, -1, 0, -1, -3, -2, -2, 1, 4, -1, -4],
    [0, -1, -1, -1, -2, -1, -1, -1, -1, -1, -1, -1, -1, -1, -2, 0, 0, -2, -1, -1, -1, -1, -1, -4],
    [-4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, 1],
]


def blosum62() -> tuple:
    """BLOSUM62 as an ``AlignmentParameters.matrix`` value: 25x25 with the
    padding row/column 0 prepended (codes = :data:`PROTEIN_ALPHABET` order,
    1-based via :func:`encode_custom`)."""
    s = len(_BLOSUM62) + 1
    out = [[0] * s]
    for row in _BLOSUM62:
        out.append([0] + list(row))
    return tuple(tuple(r) for r in out)
