"""Affine-gap (Gotoh) host fill and traceback of one pair — the port's copy
of the parts of ``versalignlib_tpu/ops/gotoh.py`` that the profile
traceback (``ops/pssm.py::profile_align_oracle``) walks.

A gap of length L in the read costs ``gap_open_read + L * score_gap_read``
(and symmetrically for the ref):

    F[i][j] = max(H[i-1][j] + open_ref + ext_ref, F[i-1][j] + ext_ref)
    E[i][j] = max(H[i][j-1] + open_read + ext_read, E[i][j-1] + ext_read)
    H[i][j] = max(H[i-1][j-1] + sub, E[i][j], F[i][j] [, 0 for SW])

The within-row E dependency is resolved with the exact prefix-max identity
over H' = H-without-E.
"""

from __future__ import annotations

import numpy as np

from versalignlib_tpu_torch.alphabet import substitution_scores
from versalignlib_tpu_torch.ops.oracle import _text_from_codes
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Alignment, TieBreak, Trace, cigar_from_gapped

#: -inf stand-in safe against int32 adds
NEG_INF = np.int32(-(2**30))


def _fill_affine(read: np.ndarray, ref: np.ndarray, p: AlignmentParameters, *,
                 local: bool, col0_penalty: bool, sub: np.ndarray | None = None):
    """Full (m+1, n+1) H, E, F matrices (int64 values).

    ``sub``: optional precomputed (m, n) substitution plane
    (position-specific scoring, ops/pssm.py)."""
    read = np.asarray(read, dtype=np.int32)
    ref = np.asarray(ref, dtype=np.int32)
    m, n = read.size, ref.size
    open_r, ext_r = p.gap_open_read, p.score_gap_read
    open_f, ext_f = p.gap_open_ref, p.score_gap_ref
    h = np.zeros((m + 1, n + 1), dtype=np.int64)
    e = np.full((m + 1, n + 1), NEG_INF, dtype=np.int64)
    f = np.full((m + 1, n + 1), NEG_INF, dtype=np.int64)
    if col0_penalty:
        i_idx = np.arange(1, m + 1, dtype=np.int64)
        h[1:, 0] = open_f + i_idx * ext_f
        f[1:, 0] = h[1:, 0]  # the boundary gap may extend without reopening
    if sub is None:
        sub = substitution_scores(read[:, None], ref[None, :], p.score_match,
                                  p.score_mismatch, p.matrix)
    j_idx = np.arange(n + 1, dtype=np.int64)
    for i in range(1, m + 1):
        f[i, 1:] = np.maximum(h[i - 1, 1:] + open_f + ext_f, f[i - 1, 1:] + ext_f)
        t = np.maximum(h[i - 1, :n] + sub[i - 1], f[i, 1:])
        if local:
            t = np.maximum(t, 0)
        t_full = np.empty(n + 1, dtype=np.int64)
        t_full[0] = h[i, 0]
        t_full[1:] = t
        run = np.maximum.accumulate(t_full + open_r - ext_r * j_idx)
        e[i, 1:] = run[:-1] + ext_r * j_idx[1:]
        h[i, 1:] = np.maximum(t, e[i, 1:])
        if local:
            h[i, 1:] = np.maximum(h[i, 1:], 0)
    return h, e, f


def _affine_pointers(h, e, f, sub, p: AlignmentParameters, *, local: bool,
                     tie: TieBreak = TieBreak.DIAG_UP_LEFT,
                     valid_comp: np.ndarray | None = None):
    """Per-cell 4-bit pointer: hptr(2b) | e_ext(1b)<<2 | f_ext(1b)<<3.

    Canonical flavor: DIAG > UP(F) > LEFT(E) with the SW zero-force. SSE
    flavor (``DIAG_LEFT_UP``): DIAG gated on ``valid_comp``, DIAG > LEFT(E)
    > UP(F), no zero-force. Gap open-vs-extend ties prefer extend.
    """
    m1, n1 = h.shape
    ptr = np.zeros((m1, n1), dtype=np.uint8)
    if m1 == 1 or n1 == 1:
        return ptr
    cur = h[1:, 1:]
    diag = h[:-1, :-1] + sub
    D, U, L, S = (np.uint8(Trace.DIAG), np.uint8(Trace.UP),
                  np.uint8(Trace.LEFT), np.uint8(Trace.START))
    if tie == TieBreak.DIAG_UP_LEFT:
        hp = np.where(cur == diag, D, np.where(cur == f[1:, 1:], U,
                                               np.where(cur == e[1:, 1:], L, S)))
        if local:
            hp = np.where(cur == 0, S, hp)
    else:
        hp = np.where((cur == diag) & valid_comp, D,
                      np.where(cur == e[1:, 1:], L, np.where(cur == f[1:, 1:], U, S)))
    e_ext = (e[1:, 1:] == e[1:, :-1] + p.score_gap_read).astype(np.uint8)
    f_ext = (f[1:, 1:] == f[:-1, 1:] + p.score_gap_ref).astype(np.uint8)
    ptr[1:, 1:] = hp | (e_ext << 2) | (f_ext << 3)
    return ptr


def _affine_traceback(read, ref, ptr, start_rp, start_fp, score, read_text=None,
                      ref_text=None, nw_boundary: bool = False) -> Alignment:
    """Three-state walk: state H follows hptr; states E/F emit LEFT/UP steps
    and fall back to H when the extend bit is clear."""
    if read_text is None:
        read_text = _text_from_codes(np.asarray(read))
    if ref_text is None:
        ref_text = _text_from_codes(np.asarray(ref))
    m, n = np.asarray(read).size, np.asarray(ref).size
    aln_length = m + n
    rp, fp = int(start_rp), int(start_fp)
    state = "H"
    rg: list[str] = []
    fg: list[str] = []
    steps = 0
    while steps <= aln_length:
        if rp < 0:
            break  # row 0: START
        if fp < 0:
            if not nw_boundary:
                break
            # NW column-0 boundary: walk up emitting UP steps.
            rg.append(read_text[rp])
            fg.append("-")
            rp -= 1
            steps += 1
            continue
        code = int(ptr[rp + 1, fp + 1])
        hptr = code & 3
        if state == "H":
            if hptr == Trace.START:
                break
            if hptr == Trace.DIAG:
                rg.append(read_text[rp])
                fg.append(ref_text[fp])
                rp -= 1
                fp -= 1
            elif hptr == Trace.UP:
                state = "F"
                continue
            else:
                state = "E"
                continue
        elif state == "F":
            rg.append(read_text[rp])
            fg.append("-")
            rp -= 1
            if not (code >> 3) & 1:
                state = "H"
        else:  # E
            rg.append("-")
            fg.append(ref_text[fp])
            fp -= 1
            if not (code >> 2) & 1:
                state = "H"
        steps += 1
    read_g = "".join(reversed(rg))
    ref_g = "".join(reversed(fg))
    return Alignment(read=read_g, ref=ref_g, score=int(score),
                     cigar=cigar_from_gapped(read_g, ref_g),
                     read_start=rp + 1, read_end=int(start_rp) + 1,
                     ref_start=fp + 1, ref_end=int(start_fp) + 1,
                     buffer_start=aln_length - 1 - len(rg),
                     buffer_end=aln_length - 1)
