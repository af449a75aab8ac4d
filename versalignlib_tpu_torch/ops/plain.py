"""Plain PyTorch versions of the CUDA kernels.

The counterparts of ``versalignlib_tpu/ops/xla.py`` (``score_batch``,
``align_batch`` and ``align_affine_batch``) and of the one-vs-many search
kernel (``cross_scores``, ``profile_scores``): one Python step per read row,
each step vectorised over pairs and columns, with the within-row left
dependency ``H[i,j] = max(T[j], H[i,j-1] + gap_read)`` resolved exactly by the
prefix-max identity

    H[i,j] = gap_read*j + cummax_j(T[j] - gap_read*j),

and the affine (Gotoh) E row by its open-aware form (``_row_solve_open``).
Substitution is the default DNA table or an S x S ``params.matrix`` looked
up by code, codes >= S scoring 0 like padding.

They run on whatever device their tensors lie on. The tests use them as the
reference for the kernels, ``chip_smoke.py`` compares the kernels with them
on the card, and the wrappers use them for tensors on the CPU. They are never
the path of a CUDA tensor.

``align_batch`` and ``align_affine_batch`` return their result in the
kernels' own layout (packed pointer words, the aux word, ``hsel``), so each
compares with its kernel word for word. Their move codes come from equality
tests against the candidates, as in ``xla._pointer_row`` and
``gotoh._affine_pointers``; the kernels get them from a packed (value,
priority) max, so each pair is two independent derivations of one rule.
"""

from __future__ import annotations

import torch

from versalignlib_tpu_torch.alphabet import make_validity
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm, TieBreak, Trace

#: 2-bit linear move codes per int32 pointer word
PACK = 16
#: 4-bit affine codes (hptr | e_ext<<2 | f_ext<<3) per int32 pointer word
AFFINE_PACK = 8
#: -inf stand-in safe against int32 adds (pallas_score.NEG_INF_I32)
NEG_INF = -(2**30)


def _substitution(refs: torch.Tensor, params: AlignmentParameters):
    """Substitution scores against refs (B, n) int32, as a function of one
    read column (B, 1) -> (B, n) int32 (the counterpart of
    ``xla._sub_row``). Default scoring: match / mismatch between A/C/G/T, 0
    where either side is padding or N. Matrix: ``matrix[read][ref]`` with
    codes outside [0, S) read as code 0, whose row and column are 0."""
    if params.matrix is not None:
        table = torch.tensor(params.matrix, dtype=torch.int32, device=refs.device)
        s = table.shape[0]
        cols = torch.where((refs >= 0) & (refs < s), refs, 0).long()

        def sub(read_col):
            rows = torch.where((read_col >= 0) & (read_col < s), read_col, 0).long()
            return table[rows, cols]

        return sub
    is_base = make_validity()
    ref_valid = is_base(refs)

    def sub(read_col):
        s = torch.where(read_col == refs, params.score_match, params.score_mismatch)
        return torch.where(is_base(read_col) & ref_valid, s, 0).to(torch.int32)

    return sub


def _row_solve(t_full: torch.Tensor, gap_read: int) -> torch.Tensor:
    """Exact prefix-max resolution of the within-row dependency;
    ``t_full[:, 0]`` is the column-0 boundary value."""
    j = torch.arange(t_full.shape[1], dtype=torch.int32, device=t_full.device) * gap_read
    return torch.cummax(t_full - j, dim=1).values + j


def _row_solve_open(t_full: torch.Tensor, gap_open: int, gap_ext: int) -> torch.Tensor:
    """Affine E row of columns 1..n: ``E[j] = ext*j + cummax_{k<j}(t_full[k]
    + open - ext*k)``, where t_full is the row without E (column 0 first)."""
    j = torch.arange(t_full.shape[1], dtype=torch.int32, device=t_full.device) * gap_ext
    run = torch.cummax(t_full + gap_open - j, dim=1).values
    return run[:, :-1] + j[1:]


def _score_fill(sub_row, b: int, m: int, n: int, params: AlignmentParameters,
                local: bool, coords: bool, dev):
    """The score recurrence over m read rows of b pairs with n columns;
    ``sub_row(i)`` gives row i's (b, n) int32 substitution scores.

    Returns (best, end_row, end_col), each (b,) int32. SW: the local
    maximum, and with ``coords`` its cell by the row-major strict first-win
    scan seeded at 0 and (0, 0) (DefaultKernel.cpp:252-256). NW: the
    reference's overlap score, the maximum over the last column of every row
    and over the whole final row, clamped at 0 (DefaultKernel.cpp:177,
    189-191); column 0 is 0 on this score path. Affine gaps add the Gotoh F
    row to the row carry and the open-aware E row (``xla.score_batch``).
    """
    affine = params.affine
    gap_ref = params.score_gap_ref
    zero_col = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    prev = torch.zeros((b, n + 1), dtype=torch.int32, device=dev)
    f_prev = torch.full((b, n), NEG_INF, dtype=torch.int32, device=dev)
    best = torch.zeros(b, dtype=torch.int32, device=dev)
    end_row = torch.zeros(b, dtype=torch.int32, device=dev)
    end_col = torch.zeros(b, dtype=torch.int32, device=dev)
    for i in range(m):
        sub = sub_row(i)
        if affine:
            f_prev = torch.maximum(prev[:, 1:] + params.gap_open_ref + gap_ref,
                                   f_prev + gap_ref)
            t = torch.maximum(prev[:, :-1] + sub, f_prev)
        else:
            t = torch.maximum(prev[:, :-1] + sub, prev[:, 1:] + gap_ref)
        if local:
            t = t.clamp(min=0)
        t_full = torch.cat([zero_col, t], dim=1)
        if affine:
            h_inner = torch.maximum(
                t, _row_solve_open(t_full, params.gap_open_read, params.score_gap_read))
            if local:
                h_inner = h_inner.clamp(min=0)
            prev = torch.cat([zero_col, h_inner], dim=1)
        else:
            prev = _row_solve(t_full, params.score_gap_read)
        if coords:
            row_max = prev[:, 1:].amax(dim=1)
            upd = row_max > best
            best = torch.where(upd, row_max, best)
            end_row = torch.where(upd, i, end_row)
            end_col = torch.where(upd, torch.argmax(prev[:, 1:], dim=1).to(torch.int32),
                                  end_col)
        else:
            best = torch.maximum(best, prev.amax(dim=1) if local else prev[:, -1])
    if not local:
        best = torch.maximum(best, prev.amax(dim=1)).clamp(min=0)
    return best, end_row, end_col


def score_batch(reads: torch.Tensor, refs: torch.Tensor,
                params: AlignmentParameters, algorithm: Algorithm) -> torch.Tensor:
    """Best score per pair: (B, m), (B, n) codes -> (B,) int32 (SW local
    maximum or NW overlap score, see :func:`_score_fill`)."""
    reads = reads.to(torch.int32)
    refs = refs.to(torch.int32)
    b, m = reads.shape
    sub_of = _substitution(refs, params)
    local = Algorithm(algorithm) == Algorithm.SMITH_WATERMAN
    return _score_fill(lambda i: sub_of(reads[:, i:i + 1]), b, m, refs.shape[1],
                       params, local, False, reads.device)[0]


#: Cells of one plain chunk: the cross product and the pool are scored in
#: slices of at most this many (pairs x columns), which bounds the plain
#: versions' memory to a few hundred MB per temporary.
PLAIN_CHUNK_CELLS = 1 << 26


def cross_scores(reads: torch.Tensor, refs: torch.Tensor,
                 params: AlignmentParameters, algorithm: Algorithm) -> torch.Tensor:
    """All-vs-all scores: (B, m) x (R, n) codes -> (B, R) int32, the score
    of read i against ref j as :func:`score_batch` gives it. The cross
    product of pairs is built in slices of refs (``PLAIN_CHUNK_CELLS``):
    this is the yardstick of the one-vs-many kernel, not its path."""
    b, m = reads.shape
    r, n = refs.shape
    out = torch.zeros((b, r), dtype=torch.int32, device=reads.device)
    if b == 0 or r == 0 or m == 0 or n == 0:
        return out
    step = max(1, PLAIN_CHUNK_CELLS // (b * (max(m, n) + 1)))
    for lo in range(0, r, step):
        chunk = refs[lo:lo + step]
        rc = chunk.shape[0]
        pairs_r = reads.repeat_interleave(rc, dim=0)   # read i vs every ref
        pairs_f = chunk.repeat(b, 1)
        out[:, lo:lo + rc] = score_batch(pairs_r, pairs_f, params, algorithm).view(b, rc)
    return out


def profile_scores(table: torch.Tensor, pool: torch.Tensor,
                   params: AlignmentParameters, algorithm: Algorithm,
                   with_coords: bool = False):
    """Position-specific (profile) scores: an (m, S) or (K, m, S) int32
    table against (R, n) pool codes -> (R,) or (K, R) int32.

    Profile row i against pool code c scores ``table[i, c]``, and a code
    outside [0, S) scores 0 (``ops/pssm.py``: a profile is "matrix mode with
    a position-indexed read"). ``with_coords`` (SW only) also returns the
    argmax cell (end_row, end_col) of each pair, (0, 0) where the best score
    is 0 (``pssm.profile_argmax_oracle``).
    """
    local = Algorithm(algorithm) == Algorithm.SMITH_WATERMAN
    if with_coords and not local:
        raise ValueError("profile coordinates are SW-only")
    multi = table.dim() == 3
    tables = table.to(torch.int32).reshape(-1, *table.shape[-2:])
    k, m, s = tables.shape
    r, n = pool.shape
    dev = pool.device
    outs = [torch.zeros((k, r), dtype=torch.int32, device=dev) for _ in range(3)]
    codes = pool.to(torch.int64)
    inside = (codes >= 0) & (codes < s)
    cols = torch.where(inside, codes, 0)
    step = max(1, PLAIN_CHUNK_CELLS // (n + 1))
    for q, rows in enumerate(tables):
        for lo in range(0, r, step):
            c, ins = cols[lo:lo + step], inside[lo:lo + step]
            got = _score_fill(lambda i: torch.where(ins, rows[i][c], 0), c.shape[0],
                              m, n, params, local, with_coords, dev)
            for out, part in zip(outs, got):
                out[q, lo:lo + c.shape[0]] = part
    scores, end_row, end_col = (o if multi else o[0] for o in outs)
    if with_coords:
        return scores, end_row, end_col
    return scores


def pack_words(codes: torch.Tensor, bits: int = 2, pack: int | None = None) -> torch.Tensor:
    """(B, n) codes of ``bits`` bits -> (B, ceil(n/pack)) int32 words with
    pack = 32 // bits unless given, code j in bits ``bits*(j % pack)``; the
    unfilled fields of a partial last word are 0 (START)."""
    pack = 32 // bits if pack is None else pack
    b, n = codes.shape
    nc = -(-n // pack)
    padded = torch.zeros((b, nc * pack), dtype=torch.int64, device=codes.device)
    padded[:, :n] = codes
    shifts = bits * torch.arange(pack, dtype=torch.int64, device=codes.device)
    words = (padded.view(b, nc, pack) << shifts).sum(dim=2)
    # Reinterpret the unsigned 32-bit word as int32.
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _pointer_row(cur, diag, up, left, valid_comp, local: bool, canonical: bool):
    """Move code per cell of one row (all (B, n)); in the affine fill ``up``
    is the F row and ``left`` the E row."""
    d, u, l, s = int(Trace.DIAG), int(Trace.UP), int(Trace.LEFT), int(Trace.START)
    if canonical:
        out = torch.where(cur == diag, d, torch.where(cur == up, u, torch.where(cur == left, l, s)))
        if local:
            out = torch.where(cur == 0, s, out)
    else:
        out = torch.where((cur == diag) & valid_comp, d,
                          torch.where(cur == left, l, torch.where(cur == up, u, s)))
    return out


class _Journal:
    """The aux word and ``hsel`` of one fill, folded row by row as the
    kernels fold them.

    SW: ``[max, argmax_row, argmax_col, 0]``, the reference's row-major
    strict first-win scan seeded at 0 / (0, 0) (DefaultKernel.cpp:252-256).
    NW: ``[argmax of row mrp, 0, 0, 0]``, the leftmost strict argmax seeded
    by the column-0 value at index 0 (DefaultKernel.cpp:317-318), 0 when
    mrp < 0; and ``hsel``, the H row of row mrp with column 0, zeros when
    mrp < 0.
    """

    def __init__(self, mrp: torch.Tensor, n: int, local: bool):
        b, dev = mrp.shape[0], mrp.device
        self.mrp, self.local = mrp, local
        self.zeros = torch.zeros(b, dtype=torch.int32, device=dev)
        self.best = self.best_i = self.best_j = self.arg = self.zeros
        self.hsel = torch.zeros((b, n + 1), dtype=torch.int32, device=dev)

    def row(self, i: int, h: torch.Tensor) -> None:
        """Fold read row i, whose H row (column 0 first) is ``h``."""
        cur = h[:, 1:]
        row_max = cur.amax(dim=1)
        row_arg = torch.argmax(cur, dim=1).to(torch.int32)  # first maximum
        if self.local:
            upd = row_max > self.best
            self.best = torch.where(upd, row_max, self.best)
            self.best_i = torch.where(upd, i, self.best_i)
            self.best_j = torch.where(upd, row_arg, self.best_j)
        else:
            at = self.mrp == i
            self.arg = torch.where(at, torch.where(row_max > h[:, 0], row_arg, 0), self.arg)
            self.hsel = torch.where(at[:, None], h, self.hsel)

    def result(self):
        z = self.zeros
        if self.local:
            return torch.stack([self.best, self.best_i, self.best_j, z], dim=1).to(torch.int32), None
        return torch.stack([self.arg, z, z, z], dim=1).to(torch.int32), self.hsel


def align_batch(reads: torch.Tensor, refs: torch.Tensor, mrp: torch.Tensor,
                params: AlignmentParameters, algorithm: Algorithm, tie: TieBreak):
    """Linear-gap pointer fill in ``csrc/align.cu``'s layout.

    reads (B, m), refs (B, n) codes; mrp (B,) int32, each pair's last valid
    read row (NW end row; ignored by SW). Returns

    - ptr (B, m, ceil(n/16)) int32: packed 2-bit move codes per inner cell;
    - aux (B, 4) int32 and, for NW, hsel (B, n+1) int32 (see
      :class:`_Journal`); hsel is None for SW.

    The NW column 0 is ``(i+1)*gap_ref`` here, the traceback variant
    (DefaultKernel.cpp:305), unlike the score path. The SSE flavor's DIAG
    gate is ``make_validity(params.matrix)`` of both codes.
    """
    reads = reads.to(torch.int32)
    refs = refs.to(torch.int32)
    dev = reads.device
    b, m = reads.shape
    n = refs.shape[1]
    local = Algorithm(algorithm) == Algorithm.SMITH_WATERMAN
    canonical = TieBreak(tie) == TieBreak.DIAG_UP_LEFT
    gap_ref, gap_read = params.score_gap_ref, params.score_gap_read
    valid = make_validity(params.matrix)
    ref_valid = valid(refs)
    sub_of = _substitution(refs, params)
    journal = _Journal(mrp.to(torch.int32), n, local)
    ptr = torch.empty((b, m, -(-n // PACK)), dtype=torch.int32, device=dev)
    prev = torch.zeros((b, n + 1), dtype=torch.int32, device=dev)
    for i in range(m):
        read_col = reads[:, i:i + 1]
        up_v = prev[:, 1:] + gap_ref
        diag_v = prev[:, :-1] + sub_of(read_col)
        t = torch.maximum(diag_v, up_v)
        if local:
            t = t.clamp(min=0)
        col0 = torch.full((b, 1), 0 if local else (i + 1) * gap_ref,
                          dtype=torch.int32, device=dev)
        h = _row_solve(torch.cat([col0, t], dim=1), gap_read)
        codes = _pointer_row(h[:, 1:], diag_v, up_v, h[:, :-1] + gap_read,
                             valid(read_col) & ref_valid, local, canonical)
        ptr[:, i] = pack_words(codes)
        journal.row(i, h)
        prev = h
    return (ptr, *journal.result())


def align_affine_batch(reads: torch.Tensor, refs: torch.Tensor, mrp: torch.Tensor,
                       params: AlignmentParameters, algorithm: Algorithm,
                       tie: TieBreak):
    """Affine (Gotoh) pointer fill in ``csrc/align_affine.cu``'s layout.

    Returns ptr (B, m, ceil(n/8)) int32, 4-bit codes ``hptr | e_ext<<2 |
    f_ext<<3`` packed 8 per word, code j in bits ``4*(j % 8)``; and aux and
    hsel as :func:`align_batch` gives them.

    The pointer model is ``gotoh._affine_pointers``: canonical order DIAG >
    UP(F) > LEFT(E) with the SW zero-force, or the SSE flavor's
    validity-gated DIAG > LEFT(E) > UP(F) with no zero-force; an extend bit
    is set when extending the gap is at least as good as opening it (extend
    wins ties). The NW column 0 is ``open_ref + (i+1)*gap_ref``
    (``xla.align_affine_batch``).
    """
    reads = reads.to(torch.int32)
    refs = refs.to(torch.int32)
    dev = reads.device
    b, m = reads.shape
    n = refs.shape[1]
    local = Algorithm(algorithm) == Algorithm.SMITH_WATERMAN
    canonical = TieBreak(tie) == TieBreak.DIAG_UP_LEFT
    ext_f, ext_r = params.score_gap_ref, params.score_gap_read
    open_f, open_r = params.gap_open_ref, params.gap_open_read
    valid = make_validity(params.matrix)
    ref_valid = valid(refs)
    sub_of = _substitution(refs, params)
    journal = _Journal(mrp.to(torch.int32), n, local)
    ptr = torch.empty((b, m, -(-n // AFFINE_PACK)), dtype=torch.int32, device=dev)
    prev = torch.zeros((b, n + 1), dtype=torch.int32, device=dev)
    f_prev = torch.full((b, n), NEG_INF, dtype=torch.int32, device=dev)
    neg_col = torch.full((b, 1), NEG_INF, dtype=torch.int32, device=dev)
    for i in range(m):
        read_col = reads[:, i:i + 1]
        f_row = torch.maximum(prev[:, 1:] + open_f + ext_f, f_prev + ext_f)
        diag_v = prev[:, :-1] + sub_of(read_col)
        t = torch.maximum(diag_v, f_row)
        if local:
            t = t.clamp(min=0)
        col0 = torch.full((b, 1), 0 if local else open_f + (i + 1) * ext_f,
                          dtype=torch.int32, device=dev)
        e_row = _row_solve_open(torch.cat([col0, t], dim=1), open_r, ext_r)
        h_inner = torch.maximum(t, e_row)
        if local:
            h_inner = h_inner.clamp(min=0)
        hp = _pointer_row(h_inner, diag_v, f_row, e_row,
                          valid(read_col) & ref_valid, local, canonical)
        e_ext = e_row == torch.cat([neg_col, e_row[:, :-1]], dim=1) + ext_r
        f_ext = f_row == f_prev + ext_f
        codes = hp | (e_ext.to(torch.int64) << 2) | (f_ext.to(torch.int64) << 3)
        ptr[:, i] = pack_words(codes, bits=4)
        h = torch.cat([col0, h_inner], dim=1)
        journal.row(i, h)
        prev, f_prev = h, f_row
    return (ptr, *journal.result())
