"""Plain PyTorch versions of the banded kernels (``csrc/banded_score.cu``,
``csrc/banded_align.cu``).

They compute what ``banded_score_oracle`` and ``banded_align_oracle``
(``versalignlib_tpu/ops/banded.py``) define: a band of ``band`` columns per
read row, starting right of DP column ``offsets[i]``, cells outside it -inf
(``NEG_INF``), row 0 and column 0 free. One Python step per read row, each
step vectorised over pairs and band columns; the in-row LEFT (linear) or E
(affine) dependency is resolved exactly by the prefix-max identities of
``plain._row_solve`` and ``plain._row_solve_open``. The rows are held
band-relative: index 0 is the boundary column left of the band, 1 + k band
column k, and a tail of -inf as wide as the largest step between rows, so
that the row above is read at an index shifted by the step. ``banded_fill``
returns its outputs in ``csrc/banded_align.cu``'s own layout (pointer words
band-relative, 8 codes per word), so that the two compare word for word.
Its move codes come from equality against the candidates, as in the oracle.
They run on whatever device their tensors lie on; the wrappers of
``ops/cuda_banded.py`` use them for tensors on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from versalignlib_tpu_torch.alphabet import make_validity
from versalignlib_tpu_torch.ops.plain import NEG_INF, _pointer_row, pack_words
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm, TieBreak

#: Move codes per int32 pointer word on the banded path, in both the 2-bit
#: linear and the 4-bit affine format.
BAND_PACK = 8


def max_step(offsets) -> int:
    """The largest step between consecutive band starts, at least 1: the
    tail of -inf each staged row carries, in the plain versions and the
    kernels alike."""
    return max(1, int(np.diff(np.asarray(offsets)).max(initial=1)))


def _sub_table(params: AlignmentParameters, dev: torch.device) -> torch.Tensor:
    """Substitution scores of every pair of byte codes, read code a against
    ref code c at a * 256 + c: the default DNA table (match / mismatch
    between A/C/G/T, else 0), or ``matrix[a][c]`` with codes outside [0, S)
    read as code 0. One gather per row replaces the compares and selects."""
    codes = np.arange(256)
    if params.matrix is not None:
        mat = np.asarray(params.matrix, dtype=np.int32)
        idx = np.where(codes < mat.shape[0], codes, 0)
        table = mat[idx[:, None], idx[None, :]]
    else:
        valid = (codes >= 1) & (codes <= 4)
        table = np.where(codes[:, None] == codes[None, :], params.score_match,
                         params.score_mismatch)
        table = np.where(valid[:, None] & valid[None, :], table, 0)
    return torch.from_numpy(table.astype(np.int32).ravel()).to(dev)


def _band_rows(reads: torch.Tensor, refs: torch.Tensor, offsets,
               params: AlignmentParameters, band: int, local: bool):
    """Yields, for each read row i in order, ``(i, o, cells)``: o the band
    start and ``cells`` a dict of (B, band) int32 tensors: ``h`` (H),
    ``diag`` (H above-left + substitution), ``up`` (H above + gap_ref, or F
    under affine gaps), ``left`` (H left + gap_read, or E), under affine
    gaps ``f_up`` (F above); ``ref`` the band's ref codes and ``read_col``
    the row's read code (B, 1).

    The in-row dependency is the prefix-max identity of ``plain._row_solve``
    (linear: H[k] = g*k + cummax(T[j] - g*j), with T[-1] the boundary) or
    of ``plain._row_solve_open`` (affine E), with the ramps made once."""
    b, m = reads.shape
    dev = reads.device
    offs = [int(v) for v in offsets]
    d = max_step(offs)
    affine = params.affine
    table = _sub_table(params, dev)
    read_base = reads.long() * 256
    refs_l = refs.long()
    ramp = torch.arange(band + 1, dtype=torch.int32, device=dev) * params.score_gap_read
    open_ramp = params.gap_open_read - ramp      # affine: open - ext * j
    neg = lambda w: torch.full((b, w), NEG_INF, dtype=torch.int32, device=dev)  # noqa: E731
    bounds = (torch.zeros((b, 1), dtype=torch.int32, device=dev), neg(1))
    # DP row 0: 0 everywhere, the tail included (row 0 is never shifted).
    prev = torch.zeros((b, band + d + 1), dtype=torch.int32, device=dev)
    f_prev = neg(band + d + 1)
    tail = neg(d)
    o_prev = offs[0] if m else 0
    for i in range(m):
        o = offs[i]
        s = o - o_prev
        o_prev = o
        ref = refs_l[:, o:o + band]
        diag = prev[:, s:s + band] + table[read_base[:, i:i + 1] + ref]
        h_up = prev[:, s + 1:s + 1 + band]
        bnd = bounds[0 if o == 0 else 1]
        cells = {"diag": diag, "ref": ref, "read_col": reads[:, i:i + 1]}
        if affine:
            f_up = f_prev[:, s + 1:s + 1 + band]
            f = (torch.maximum(h_up + params.gap_open_ref, f_up)
                 + params.score_gap_ref).clamp(min=NEG_INF)
            t = torch.maximum(diag, f).clamp(min=0 if local else NEG_INF)
            run = torch.cummax(torch.cat([bnd, t], dim=1) + open_ramp, dim=1).values
            e = (run[:, :-1] + ramp[1:]).clamp(min=NEG_INF)
            h = torch.maximum(t, e)
            cells.update(up=f, left=e, f_up=f_up)
            f_prev = torch.cat([bounds[1], f, tail], dim=1)
        else:
            up = h_up + params.score_gap_ref
            t = torch.maximum(diag, up).clamp(min=0 if local else NEG_INF)
            h_full = torch.cummax(torch.cat([bnd, t], dim=1) - ramp, dim=1).values + ramp
            h = h_full[:, 1:]
            cells.update(up=up, left=h_full[:, :-1] + params.score_gap_read)
        cells["h"] = h
        yield i, o, cells
        prev = torch.cat([bnd, h, tail], dim=1)


def banded_score(reads: torch.Tensor, refs: torch.Tensor, offsets,
                 params: AlignmentParameters, algorithm: Algorithm,
                 band: int) -> torch.Tensor:
    """Banded best score per pair, (B, m) x (B, n) codes -> (B,) int32, over
    every row given (the wrapper's padded rows included). SW: the band's
    maximum, at least 0. NW: max(the last DP column over the rows whose band
    reaches it, the final row's band, 0)."""
    reads = reads.to(torch.int32)
    refs = refs.to(torch.int32)
    b, m = reads.shape
    n = refs.shape[1]
    local = Algorithm(algorithm) == Algorithm.SMITH_WATERMAN
    dev = reads.device
    best = torch.zeros(b, dtype=torch.int32, device=dev) if local else \
        torch.full((b,), NEG_INF, dtype=torch.int32, device=dev)
    h = None
    for _, o, cells in _band_rows(reads, refs, offsets, params, band, local):
        h = cells["h"]
        if local:
            best = torch.maximum(best, h.amax(dim=1))
        elif o + band == n:
            best = torch.maximum(best, h[:, -1])
    if local:
        return best
    if h is not None:
        best = torch.maximum(best, h.amax(dim=1))
    return best.clamp(min=0)


def banded_fill(reads: torch.Tensor, refs: torch.Tensor, offsets, mrp: torch.Tensor,
                params: AlignmentParameters, algorithm: Algorithm, tie: TieBreak,
                band: int):
    """Banded pointer fill in ``csrc/banded_align.cu``'s layout.

    reads (B, m), refs (B, n) codes; offsets (m,) band starts; mrp (B,)
    int32, each pair's last valid read row (NW end row; ignored by SW).
    Returns

    - ptr (B, m, ceil(band/8)) int32: row i's code of band column k in field
      k % 8 of word k // 8, 2-bit moves or 4-bit ``hptr | e_ext<<2 |
      f_ext<<3``; fields past the band are 0;
    - best (B, 4) int32 for SW: [score, end row, end ref position, 0], the
      first in-band cell in row-major order that holds the maximum, (0, 0)
      when it is 0; None for NW;
    - keep (B, band) int32 for NW: the H row of row mrp, -inf throughout
      when mrp < 0; None for SW.
    """
    reads = reads.to(torch.int32)
    refs = refs.to(torch.int32)
    b, m = reads.shape
    dev = reads.device
    local = Algorithm(algorithm) == Algorithm.SMITH_WATERMAN
    canonical = TieBreak(tie) == TieBreak.DIAG_UP_LEFT
    affine = params.affine
    valid = make_validity(params.matrix)
    mrp = mrp.to(torch.int32).to(dev)
    ptr = torch.empty((b, m, -(-band // BAND_PACK)), dtype=torch.int32, device=dev)
    zeros = torch.zeros(b, dtype=torch.int32, device=dev)
    best, best_row, best_col = zeros, zeros, zeros
    keep = torch.full((b, band), NEG_INF, dtype=torch.int32, device=dev)
    for i, o, c in _band_rows(reads, refs, offsets, params, band, local):
        h = c["h"]
        codes = _pointer_row(h, c["diag"], c["up"], c["left"],
                             valid(c["read_col"]) & valid(c["ref"]), local, canonical)
        if affine:
            e_prev = torch.cat([torch.full_like(h[:, :1], NEG_INF), c["left"][:, :-1]], dim=1)
            e_ext = c["left"] == e_prev + params.score_gap_read
            f_ext = c["up"] == c["f_up"] + params.score_gap_ref
            codes = codes | (e_ext.to(torch.int64) << 2) | (f_ext.to(torch.int64) << 3)
        ptr[:, i] = pack_words(codes, bits=4 if affine else 2, pack=BAND_PACK)
        if local:
            row_max = h.amax(dim=1)
            upd = row_max > best
            best = torch.where(upd, row_max, best)
            best_row = torch.where(upd, i, best_row)
            best_col = torch.where(upd, o + torch.argmax(h, dim=1).to(torch.int32), best_col)
        else:
            keep = torch.where((mrp == i)[:, None], h, keep)
    if local:
        return ptr, torch.stack([best, best_row, best_col, zeros], dim=1).to(torch.int32), None
    return ptr, None, keep


def nw_end_cells(keep: np.ndarray, mrp: np.ndarray, max_ref_pos: np.ndarray,
                 offsets: np.ndarray, band: int, n: int):
    """NW traceback start and score per pair from the fill's ``keep`` rows
    (banded.py:1359-1382): row mrp, column the leftmost maximum of that row's
    band cells at valid ref positions (``< max_ref_pos + 1``); (-1, -1) and
    score 0 when mrp < 0 or no such cell exists. Returns (start_r, start_f,
    scores), each (B,) int32."""
    rows = np.clip(mrp, 0, None)
    o = offsets[rows].astype(np.int64)
    width = np.minimum(np.minimum(o + band, n), max_ref_pos.astype(np.int64) + 1) - o
    ok = (mrp >= 0) & (width > 0)
    cols = np.arange(keep.shape[1])[None, :]
    vals = np.where(cols < width[:, None], keep.astype(np.int64), np.iinfo(np.int64).min)
    arg = np.argmax(vals, axis=1)
    score = keep[np.arange(len(keep)), arg] if len(keep) else np.zeros(0, np.int32)
    return (np.where(ok, mrp, -1).astype(np.int32),
            np.where(ok, o + arg, -1).astype(np.int32),
            np.where(ok, score, 0).astype(np.int32))
