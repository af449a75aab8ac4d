"""NumPy host fill and traceback of one pair — the port's copy of the parts
of ``versalignlib_tpu/ops/oracle.py`` that the profile traceback
(``ops/pssm.py::profile_align_oracle``) walks: the linear-gap H matrix, its
pointers and the walk that emits gapped strings exactly like
DefaultKernel.cpp:413-451.

The row fill resolves the within-row left dependency with the prefix-max
identity ``H[i,j] = gap_read*j + cummax(T - gap_read*iota)``, exact in
integer arithmetic; pointers are derived from the completed H matrix, which
is equivalent to the reference's in-loop pointer selection.
"""

from __future__ import annotations

import numpy as np

from versalignlib_tpu_torch.alphabet import substitution_scores
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Alignment, TieBreak, Trace, cigar_from_gapped


def _row_fill(t_row: np.ndarray, gap_read: int) -> np.ndarray:
    """Resolve the within-row left dependency: H[j] = max(T[j], H[j-1]+gap);
    ``t_row`` has length ref_len+1 with ``t_row[0]`` the column-0 value."""
    j = np.arange(t_row.size, dtype=np.int64)
    shifted = np.maximum.accumulate(t_row.astype(np.int64) - gap_read * j)
    return (shifted + gap_read * j).astype(np.int32)


def _fill_matrix(read: np.ndarray, ref: np.ndarray, p: AlignmentParameters, *,
                 local: bool, col0_penalty: bool,
                 sub: np.ndarray | None = None) -> np.ndarray:
    """Full (read_len+1, ref_len+1) H matrix.

    ``local``: clamp cells at 0 (Smith-Waterman). ``col0_penalty``: column 0
    = i*gap_ref as in the NW traceback variant; otherwise column 0 stays 0.
    ``sub``: optional precomputed (read_len, ref_len) substitution plane
    (position-specific scoring, ops/pssm.py); by default it derives from
    the codes.
    """
    read = np.asarray(read, dtype=np.int32)
    ref = np.asarray(ref, dtype=np.int32)
    m, n = read.size, ref.size
    h = np.zeros((m + 1, n + 1), dtype=np.int32)
    if col0_penalty:
        h[:, 0] = np.arange(m + 1, dtype=np.int32) * p.score_gap_ref
    if sub is None:
        sub = substitution_scores(read[:, None], ref[None, :], p.score_match,
                                  p.score_mismatch, p.matrix)
    for i in range(1, m + 1):
        t = np.empty(n + 1, dtype=np.int32)
        t[0] = h[i, 0]
        diag = h[i - 1, :n] + sub[i - 1]
        up = h[i - 1, 1:] + p.score_gap_ref
        t[1:] = np.maximum(diag, up)
        if local:
            t[1:] = np.maximum(t[1:], 0)
        h[i, 1:] = _row_fill(t, p.score_gap_read)[1:]
    return h


def _pointers(h: np.ndarray, sub: np.ndarray, valid_comp: np.ndarray,
              p: AlignmentParameters, *, local: bool, tie: TieBreak) -> np.ndarray:
    """Pointer matrix (same shape as h; row/col 0 = START).

    DIAG_UP_LEFT (Default, DefaultKernel.cpp:238-248/:338-346): START(SW@0)
    > DIAG > UP > LEFT, DIAG unconditional. DIAG_LEFT_UP (SSE,
    SSEKernel.cpp:364-379): DIAG > LEFT > UP, DIAG only where both symbols
    are valid (``valid_comp``), no START force at zero SW cells.
    """
    m, n = h.shape
    ptr = np.zeros((m, n), dtype=np.uint8)
    if m == 1 or n == 1:
        if not local and m > 1:
            ptr[1:, 0] = Trace.UP
        return ptr
    cur = h[1:, 1:]
    diag = h[:-1, :-1] + sub
    up = h[:-1, 1:] + p.score_gap_ref
    left = h[1:, :-1] + p.score_gap_read
    is_diag = cur == diag
    is_up = cur == up
    is_left = cur == left
    if tie == TieBreak.DIAG_UP_LEFT:
        out = np.where(is_diag, Trace.DIAG, np.where(
            is_up, Trace.UP, np.where(is_left, Trace.LEFT, Trace.START))).astype(np.uint8)
        if local:
            out = np.where(cur == 0, np.uint8(Trace.START), out)
    else:
        is_diag = is_diag & valid_comp
        out = np.where(is_diag, Trace.DIAG, np.where(
            is_left, Trace.LEFT, np.where(is_up, Trace.UP, Trace.START))).astype(np.uint8)
    ptr[1:, 1:] = out
    if not local:
        # NW traceback variant: column 0 pointers are UP (DefaultKernel.cpp:304).
        ptr[1:, 0] = Trace.UP
    return ptr


def _text_from_codes(codes: np.ndarray) -> str:
    """Rendering of a code array when the original characters are
    unavailable: A/T/C/G/N for codes 1-5, '\\0' for any other code."""
    table = "\0ATCGN"
    return "".join(table[int(c)] if 0 <= int(c) <= 5 else "\0" for c in codes)


def _traceback(read: np.ndarray, ref: np.ndarray, ptr: np.ndarray,
               start_read_pos: int, start_ref_pos: int, score: int,
               read_text: str | None = None, ref_text: str | None = None) -> Alignment:
    """Walk pointers from (start_read_pos, start_ref_pos) until START,
    emitting gapped strings exactly like DefaultKernel.cpp:413-451."""
    if read_text is None:
        read_text = _text_from_codes(read)
    if ref_text is None:
        ref_text = _text_from_codes(ref)
    aln_length = read.size + ref.size
    read_chars: list[str] = []
    ref_chars: list[str] = []
    rp, fp = int(start_read_pos), int(start_ref_pos)
    steps = 0
    while rp >= -1 and fp >= -1:
        bt = ptr[rp + 1, fp + 1]
        if bt == Trace.START:
            break
        if bt == Trace.UP:
            read_chars.append(read_text[rp])
            ref_chars.append("-")
            rp -= 1
        elif bt == Trace.LEFT:
            read_chars.append("-")
            ref_chars.append(ref_text[fp])
            fp -= 1
        else:  # DIAG
            read_chars.append(read_text[rp])
            ref_chars.append(ref_text[fp])
            rp -= 1
            fp -= 1
        steps += 1
        if steps > aln_length:  # cannot happen with valid pointers
            raise RuntimeError("traceback did not terminate")
    read_g = "".join(reversed(read_chars))
    ref_g = "".join(reversed(ref_chars))
    return Alignment(read=read_g, ref=ref_g, score=int(score),
                     cigar=cigar_from_gapped(read_g, ref_g),
                     read_start=rp + 1, read_end=int(start_read_pos) + 1,
                     ref_start=fp + 1, ref_end=int(start_ref_pos) + 1,
                     buffer_start=aln_length - 1 - steps,
                     buffer_end=aln_length - 1)
