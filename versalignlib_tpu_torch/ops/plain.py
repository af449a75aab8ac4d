"""Plain PyTorch versions of the two CUDA kernels.

The counterparts of ``versalignlib_tpu/ops/xla.py`` (``score_batch``, linear
branch, and ``align_batch``): one Python step per read row, each step
vectorised over pairs and columns, with the within-row left dependency
``H[i,j] = max(T[j], H[i,j-1] + gap_read)`` resolved exactly by the prefix-max
identity

    H[i,j] = gap_read*j + cummax_j(T[j] - gap_read*j).

They run on whatever device their tensors lie on. The tests use them as the
reference for the kernels, ``chip_smoke.py`` compares the kernels with them
on the card, and the wrappers use them for tensors on the CPU. They are never
the path of a CUDA tensor.

``align_batch`` returns its result in ``csrc/align.cu``'s own layout (packed
pointer words, the aux word, ``hsel``), so the two compare word for word.
Its move codes come from equality tests against the three candidates, as in
``xla._pointer_row``; the kernel gets them from a packed (value, priority)
max, so the two are independent derivations of the same rules.
"""

from __future__ import annotations

import torch

from versalignlib_tpu_torch.alphabet import make_validity
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm, TieBreak, Trace

#: 2-bit move codes per int32 pointer word
PACK = 16

#: A/C/G/T (codes 1..4): the codes with a nonzero substitution score
_is_base = make_validity()


def _sub_row(read_col: torch.Tensor, refs: torch.Tensor, ref_valid: torch.Tensor,
             params: AlignmentParameters) -> torch.Tensor:
    """Substitution scores of one read column (B, 1) against refs (B, n):
    match / mismatch between A/C/G/T, 0 where either side is padding or N."""
    sub = torch.where(read_col == refs, params.score_match, params.score_mismatch)
    return torch.where(_is_base(read_col) & ref_valid, sub, 0).to(torch.int32)


def _row_solve(t_full: torch.Tensor, gap_read: int) -> torch.Tensor:
    """Exact prefix-max resolution of the within-row dependency;
    ``t_full[:, 0]`` is the column-0 boundary value."""
    j = torch.arange(t_full.shape[1], dtype=torch.int32, device=t_full.device) * gap_read
    return torch.cummax(t_full - j, dim=1).values + j


def score_batch(reads: torch.Tensor, refs: torch.Tensor,
                params: AlignmentParameters, algorithm: Algorithm) -> torch.Tensor:
    """Best score per pair: (B, m), (B, n) codes -> (B,) int32.

    SW: the local maximum. NW: the reference's overlap score, the maximum
    over the last column of every row and over the whole final row, clamped
    at 0 (DefaultKernel.cpp:177,189-191); column 0 is 0 on this score path.
    """
    reads = reads.to(torch.int32)
    refs = refs.to(torch.int32)
    b, m = reads.shape
    n = refs.shape[1]
    local = Algorithm(algorithm) == Algorithm.SMITH_WATERMAN
    ref_valid = _is_base(refs)
    zero_col = torch.zeros((b, 1), dtype=torch.int32, device=reads.device)
    prev = torch.zeros((b, n + 1), dtype=torch.int32, device=reads.device)
    best = torch.zeros(b, dtype=torch.int32, device=reads.device)
    for i in range(m):
        sub = _sub_row(reads[:, i:i + 1], refs, ref_valid, params)
        t = torch.maximum(prev[:, :-1] + sub, prev[:, 1:] + params.score_gap_ref)
        if local:
            t = t.clamp(min=0)
        prev = _row_solve(torch.cat([zero_col, t], dim=1), params.score_gap_read)
        best = torch.maximum(best, prev.amax(dim=1) if local else prev[:, -1])
    if not local:
        best = torch.maximum(best, prev.amax(dim=1)).clamp(min=0)
    return best


def pack_words(codes: torch.Tensor) -> torch.Tensor:
    """(B, n) 2-bit codes -> (B, ceil(n/16)) int32 words, code j in bits
    2*(j % 16); the unfilled fields of a partial last word are 0 (START)."""
    b, n = codes.shape
    nc = -(-n // PACK)
    padded = torch.zeros((b, nc * PACK), dtype=torch.int64, device=codes.device)
    padded[:, :n] = codes
    shifts = 2 * torch.arange(PACK, dtype=torch.int64, device=codes.device)
    words = (padded.view(b, nc, PACK) << shifts).sum(dim=2)
    # Reinterpret the unsigned 32-bit word as int32.
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _pointer_row(cur, diag, up, left, valid_comp, local: bool, canonical: bool):
    """Move code per cell of one row (all (B, n))."""
    d, u, l, s = int(Trace.DIAG), int(Trace.UP), int(Trace.LEFT), int(Trace.START)
    if canonical:
        out = torch.where(cur == diag, d, torch.where(cur == up, u, torch.where(cur == left, l, s)))
        if local:
            out = torch.where(cur == 0, s, out)
    else:
        out = torch.where((cur == diag) & valid_comp, d,
                          torch.where(cur == left, l, torch.where(cur == up, u, s)))
    return out


def align_batch(reads: torch.Tensor, refs: torch.Tensor, mrp: torch.Tensor,
                params: AlignmentParameters, algorithm: Algorithm, tie: TieBreak):
    """Pointer fill in ``csrc/align.cu``'s layout.

    reads (B, m), refs (B, n) codes; mrp (B,) int32, each pair's last valid
    read row (NW end row; ignored by SW). Returns

    - ptr (B, m, ceil(n/16)) int32: packed 2-bit move codes per inner cell;
    - aux (B, 4) int32: SW ``[max, argmax_row, argmax_col, 0]`` with the
      reference's row-major strict first-win scan seeded at 0 / (0, 0)
      (DefaultKernel.cpp:252-256); NW ``[argmax of row mrp, 0, 0, 0]``, the
      leftmost strict argmax seeded by the column-0 value at index 0
      (DefaultKernel.cpp:317-318), 0 when mrp < 0;
    - hsel (B, n+1) int32 (NW; None for SW): the H row of row mrp, column 0
      included, zeros when mrp < 0.

    The NW column 0 is ``(i+1)*gap_ref`` here, the traceback variant
    (DefaultKernel.cpp:305), unlike the score path.
    """
    reads = reads.to(torch.int32)
    refs = refs.to(torch.int32)
    mrp = mrp.to(torch.int32)
    dev = reads.device
    b, m = reads.shape
    n = refs.shape[1]
    local = Algorithm(algorithm) == Algorithm.SMITH_WATERMAN
    canonical = TieBreak(tie) == TieBreak.DIAG_UP_LEFT
    gap_ref, gap_read = params.score_gap_ref, params.score_gap_read
    ref_valid = _is_base(refs)
    ptr = torch.empty((b, m, -(-n // PACK)), dtype=torch.int32, device=dev)
    prev = torch.zeros((b, n + 1), dtype=torch.int32, device=dev)
    zeros = torch.zeros(b, dtype=torch.int32, device=dev)
    best, best_i, best_j = zeros, zeros, zeros
    arg = zeros
    hsel = torch.zeros((b, n + 1), dtype=torch.int32, device=dev)
    for i in range(m):
        read_col = reads[:, i:i + 1]
        sub = _sub_row(read_col, refs, ref_valid, params)
        up_v = prev[:, 1:] + gap_ref
        diag_v = prev[:, :-1] + sub
        t = torch.maximum(diag_v, up_v)
        if local:
            t = t.clamp(min=0)
        col0 = torch.full((b, 1), 0 if local else (i + 1) * gap_ref,
                          dtype=torch.int32, device=dev)
        h = _row_solve(torch.cat([col0, t], dim=1), gap_read)
        cur = h[:, 1:]
        codes = _pointer_row(cur, diag_v, up_v, h[:, :-1] + gap_read,
                             _is_base(read_col) & ref_valid, local, canonical)
        ptr[:, i] = pack_words(codes)
        row_max = cur.amax(dim=1)
        row_arg = torch.argmax(cur, dim=1).to(torch.int32)  # first maximum
        if local:
            upd = row_max > best
            best = torch.where(upd, row_max, best)
            best_i = torch.where(upd, i, best_i)
            best_j = torch.where(upd, row_arg, best_j)
        else:
            at = mrp == i
            arg = torch.where(at, torch.where(row_max > h[:, 0], row_arg, 0), arg)
            hsel = torch.where(at[:, None], h, hsel)
        prev = h
    if local:
        aux = torch.stack([best, best_i, best_j, zeros], dim=1)
        return ptr, aux.to(torch.int32), None
    aux = torch.stack([arg, zeros, zeros, zeros], dim=1)
    return ptr, aux.to(torch.int32), hsel
