"""The plain reference that decides ``correct``: Smith-Waterman scores and
alignments, linear or affine (Gotoh) gaps, and the mapping entry's
semantics (window tiling, reverse complements, best hit and its tie rules,
the distinct-locus second best, MAPQ, the winner's alignment in global
coordinates), in plain PyTorch and NumPy.

It imports nothing of the measured program and takes nothing it made: it
works everything out again from the codes, the references and the
configuration's scoring. Its semantics are those of the reference
program's DefaultKernel (``SW``, the canonical DIAG > UP > LEFT flavor);
the per-pair walk is a frozen copy of that oracle.

``cell_bits`` computes every DP cell saturated to a signed integer of that
many bits; 32 is the configurations' own precision, and a narrower one is
the control that the comparison has to fail.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vbench.gen import reverse_complement

#: -inf stand-in safe against int32 adds.
NEG_INF = -(2 ** 30)
#: The mapping entry's "no candidate" score.
NEG32 = -(2 ** 31)
#: Gapped-string rendering of codes 0..5.
TEXT = "\0ATCGN"
START, UP, LEFT, DIAG = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class Scoring:
    """A configuration's scoring: a gap of length L costs ``open + L * gap``
    (``open`` 0: linear gaps). ``gap_read`` is paid for a ref base against a
    gap in the read (LEFT), ``gap_ref`` for a read base against a gap in the
    ref (UP)."""

    match: int
    mismatch: int
    gap_read: int
    gap_ref: int
    open_read: int = 0
    open_ref: int = 0

    @classmethod
    def from_config(cls, s: dict) -> "Scoring":
        return cls(s["score_match"], s["score_mismatch"], s["score_gap_read"],
                   s["score_gap_ref"], s.get("gap_open_read", 0), s.get("gap_open_ref", 0))

    @property
    def affine(self) -> bool:
        return self.open_read != 0 or self.open_ref != 0

    def table(self) -> np.ndarray:
        """(6, 6) int32 substitution scores: match or mismatch between
        A/C/G/T codes, 0 wherever padding or N takes part."""
        t = np.full((6, 6), self.mismatch, dtype=np.int32)
        np.fill_diagonal(t, self.match)
        t[[0, 5], :] = 0
        t[:, [0, 5]] = 0
        return t


def _limits(cell_bits: int) -> tuple[int, int] | None:
    return None if cell_bits >= 32 else (-(1 << (cell_bits - 1)), (1 << (cell_bits - 1)) - 1)


def _sw_best(sub_row, shape: tuple, n: int, m: int, sc: Scoring, device,
             cell_bits: int = 32) -> torch.Tensor:
    """Best local score of each problem of ``shape``: read rows 0..m-1, ref
    columns 0..n-1, ``sub_row(i)`` the (*shape, n) int32 substitution row
    of read position i. A row's left dependency is the exact prefix-max
    identity ``H[j] = max_k<=j (T[k] + gap * (j - k))`` (``torch.cummax``)."""
    lim = _limits(cell_bits)
    j = torch.arange(n + 1, dtype=torch.int32, device=device)
    zero = torch.zeros(shape + (1,), dtype=torch.int32, device=device)
    h = torch.zeros(shape + (n + 1,), dtype=torch.int32, device=device)
    f = torch.full(shape + (n,), NEG_INF, dtype=torch.int32, device=device)
    best = torch.zeros(shape, dtype=torch.int32, device=device)
    for i in range(m):
        diag = h[..., :-1] + sub_row(i)
        if sc.affine:
            f = torch.maximum(h[..., 1:] + (sc.open_ref + sc.gap_ref), f + sc.gap_ref)
            t = torch.maximum(diag, f).clamp_(min=0)
            run = torch.cummax(torch.cat([zero, t], -1) + (sc.open_read - sc.gap_read * j),
                               -1).values
            h = torch.cat([zero, torch.maximum(t, run[..., :-1] + sc.gap_read * j[1:])], -1)
        else:
            t = torch.maximum(diag, h[..., 1:] + sc.gap_ref).clamp_(min=0)
            h = torch.cummax(torch.cat([zero, t], -1) - sc.gap_read * j, -1).values \
                + sc.gap_read * j
        if lim is not None:
            h = h.clamp(*lim)
            f = f.clamp(*lim)
        best = torch.maximum(best, h.amax(-1))
    return best


def pair_scores(reads: np.ndarray, refs: np.ndarray, sc: Scoring, device="cpu",
                cell_bits: int = 32, block: int = 1 << 26) -> np.ndarray:
    """SW score of each (read, ref) row pair: (B, m), (B, n) codes -> (B,)
    int64, in blocks of about ``block`` cells a row."""
    b, m = reads.shape
    n = refs.shape[1]
    out = np.zeros(b, dtype=np.int64)
    if m == 0 or n == 0:
        return out
    table = torch.from_numpy(sc.table()).to(device)
    rows = max(1, block // (n + 1))
    for lo in range(0, b, rows):
        r = torch.from_numpy(np.ascontiguousarray(reads[lo:lo + rows])).to(device).long()
        f = torch.from_numpy(np.ascontiguousarray(refs[lo:lo + rows])).to(device).long()
        prof = table[:, f].permute(1, 0, 2).contiguous()       # (b, 6, n)
        idx = r[:, :, None].expand(-1, -1, n)

        def sub_row(i, prof=prof, idx=idx):
            return torch.gather(prof, 1, idx[:, i:i + 1]).squeeze(1)

        best = _sw_best(sub_row, (r.shape[0],), n, m, sc, device, cell_bits)
        out[lo:lo + rows] = best.cpu().numpy()
    return out


def cross_scores(queries: np.ndarray, pool: np.ndarray, sc: Scoring, device="cpu",
                 cell_bits: int = 32, block: int = 1 << 26) -> np.ndarray:
    """SW score of every query against every pool entry: (Q, m), (R, n)
    codes -> (Q, R) int64, the pool in chunks of about ``block`` cells a
    row."""
    q, m = queries.shape
    r, n = pool.shape
    out = np.zeros((q, r), dtype=np.int64)
    if m == 0 or n == 0 or q == 0:
        return out
    table = torch.from_numpy(sc.table()).to(device)
    codes = torch.from_numpy(np.ascontiguousarray(queries)).to(device).long()
    per = max(1, block // (q * (n + 1)))
    for lo in range(0, r, per):
        p = torch.from_numpy(np.ascontiguousarray(pool[lo:lo + per])).to(device).long()
        prof = table[:, p]                                       # (6, Rc, n)

        def sub_row(i, prof=prof):
            return prof[codes[:, i]]                             # (Q, Rc, n)

        best = _sw_best(sub_row, (q, p.shape[0]), n, m, sc, device, cell_bits)
        out[:, lo:lo + p.shape[0]] = best.cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# One pair's alignment: a frozen copy of the canonical-flavor SW oracle.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Aligned:
    """The fields of one alignment that are compared."""

    read: str
    ref: str
    score: int
    cigar: str
    read_start: int
    read_end: int
    ref_start: int
    ref_end: int
    buffer_start: int
    buffer_end: int

    def shifted(self, by: int) -> "Aligned":
        return dataclasses.replace(self, ref_start=self.ref_start + by,
                                   ref_end=self.ref_end + by)


def cigar(read_g: str, ref_g: str) -> str:
    """M/I/D run lengths: I a gap in the ref, D a gap in the read."""
    ops: list[list] = []
    for rc, fc in zip(read_g, ref_g):
        op = "D" if rc == "-" else ("I" if fc == "-" else "M")
        if ops and ops[-1][0] == op:
            ops[-1][1] += 1
        else:
            ops.append([op, 1])
    return "".join(f"{k}{op}" for op, k in ops)


def _fill(read: np.ndarray, ref: np.ndarray, sc: Scoring):
    """(m+1, n+1) int64 H, E, F of a local alignment (E, F None with
    linear gaps)."""
    m, n = read.size, ref.size
    sub = sc.table()[read[:, None], ref[None, :]].astype(np.int64)
    j = np.arange(n + 1, dtype=np.int64)
    h = np.zeros((m + 1, n + 1), dtype=np.int64)
    if not sc.affine:
        for i in range(1, m + 1):
            t = np.zeros(n + 1, dtype=np.int64)
            t[1:] = np.maximum(np.maximum(h[i - 1, :n] + sub[i - 1], h[i - 1, 1:] + sc.gap_ref), 0)
            h[i] = np.maximum.accumulate(t - sc.gap_read * j) + sc.gap_read * j
        return h, None, None
    e = np.full((m + 1, n + 1), NEG_INF, dtype=np.int64)
    f = np.full((m + 1, n + 1), NEG_INF, dtype=np.int64)
    for i in range(1, m + 1):
        f[i, 1:] = np.maximum(h[i - 1, 1:] + sc.open_ref + sc.gap_ref, f[i - 1, 1:] + sc.gap_ref)
        t = np.maximum(np.maximum(h[i - 1, :n] + sub[i - 1], f[i, 1:]), 0)
        run = np.maximum.accumulate(np.concatenate([[0], t]) + sc.open_read - sc.gap_read * j)
        e[i, 1:] = run[:-1] + sc.gap_read * j[1:]
        h[i, 1:] = np.maximum(np.maximum(t, e[i, 1:]), 0)
    return h, e, f


def align(read: np.ndarray, ref: np.ndarray, sc: Scoring) -> Aligned:
    """SW alignment of one pair: the walk starts at the row-major first
    maximum; pointers DIAG > UP > LEFT, START at zero cells; under affine
    gaps a gap state extends while its extend bit is set (extend wins
    open-vs-extend ties)."""
    read = np.asarray(read, dtype=np.int64)
    ref = np.asarray(ref, dtype=np.int64)
    m, n = read.size, ref.size
    h, e, f = _fill(read, ref, sc)
    sub = sc.table()[read[:, None], ref[None, :]].astype(np.int64)
    cur = h[1:, 1:]
    if sc.affine:
        up, left = f[1:, 1:], e[1:, 1:]
        e_ext = e[1:, 1:] == e[1:, :-1] + sc.gap_read
        f_ext = f[1:, 1:] == f[:-1, 1:] + sc.gap_ref
    else:
        up, left = h[:-1, 1:] + sc.gap_ref, h[1:, :-1] + sc.gap_read
    ptr = np.where(cur == h[:-1, :-1] + sub, DIAG,
                   np.where(cur == up, UP, np.where(cur == left, LEFT, START)))
    ptr = np.where(cur == 0, START, ptr)
    rp, fp = divmod(int(np.argmax(cur)), n)
    score = int(cur[rp, fp])
    end_r, end_f = rp, fp
    rg: list[str] = []
    fg: list[str] = []
    state = "H"
    while rp >= 0 and fp >= 0:
        if state == "H":
            move = ptr[rp, fp]
            if move == START:
                break
            if move == DIAG:
                rg.append(TEXT[read[rp]])
                fg.append(TEXT[ref[fp]])
                rp, fp = rp - 1, fp - 1
                continue
            state = "F" if move == UP else "E"
            if not sc.affine:
                state = "UP" if move == UP else "LEFT"
        if state in ("F", "UP"):
            rg.append(TEXT[read[rp]])
            fg.append("-")
            rp -= 1
            if state == "UP" or not f_ext[rp + 1, fp]:
                state = "H"
        else:
            rg.append("-")
            fg.append(TEXT[ref[fp]])
            fp -= 1
            if state == "LEFT" or not e_ext[rp, fp + 1]:
                state = "H"
    read_g = "".join(reversed(rg))
    ref_g = "".join(reversed(fg))
    return Aligned(read_g, ref_g, score, cigar(read_g, ref_g), rp + 1, end_r + 1, fp + 1,
                   end_f + 1, m + n - 1 - len(rg), m + n - 1)


# ---------------------------------------------------------------------------
# The mapping entry.
# ---------------------------------------------------------------------------

def tile(genome: np.ndarray, window: int, stride: int) -> tuple[np.ndarray, np.ndarray]:
    """Windows of ``window`` codes every ``stride``, the last one starting
    at the last stride multiple below the end and padded with 0: (windows
    (W, window), starts (W,))."""
    count = max(1, -(-max(genome.size - window, 0) // stride) + 1)
    starts = np.arange(count, dtype=np.int64) * stride
    padded = np.zeros(int(starts[-1]) + window, dtype=np.uint8)
    padded[:genome.size] = genome
    return padded[starts[:, None] + np.arange(window)[None, :]], starts


def mapq(best: np.ndarray, second: np.ndarray, unit: int) -> np.ndarray:
    """min(60, 6 * (best - second) // unit), 60 with no second candidate."""
    gap = np.maximum(best - second, 0)
    return np.where(second == NEG32, 60, np.minimum(60, 6 * gap // max(unit, 1)))


def _strands(reads, pool, sc, device, cell_bits):
    rc = reverse_complement(reads)
    both = cross_scores(np.concatenate([reads, rc]), pool, sc, device, cell_bits)
    return rc, both[:len(reads)], both[len(reads):]


def map_genome(reads: np.ndarray, genome: np.ndarray, window: int, stride: int, sc: Scoring,
               device="cpu", cell_bits: int = 32) -> dict:
    """Each read's best window of one reference over both strands (ties:
    forward strand, then the lower window); the second best is the best
    score, either strand, of a window at least ceil(window / stride)
    windows from the winner; the winner aligned in its window and shifted
    to reference coordinates."""
    windows, starts = tile(genome, window, stride)
    rc, fwd, rev_s = _strands(reads, windows, sc, device, cell_bits)
    arg_f, arg_r = fwd.argmax(1), rev_s.argmax(1)
    best_f, best_r = fwd.max(1), rev_s.max(1)
    rev = best_r > best_f
    win = np.where(rev, arg_r, arg_f)
    best = np.where(rev, best_r, best_f)
    far = np.abs(np.arange(len(windows))[None, :] - win[:, None]) >= -(-window // stride)
    second = np.maximum(np.where(far, fwd, NEG32).max(1), np.where(far, rev_s, NEG32).max(1))
    oriented = np.where(rev[:, None], rc, reads)
    return {"ref_id": np.zeros(len(reads), dtype=np.int64), "pos": starts[win], "score": best,
            "strand": rev.astype(np.int64), "mapq": mapq(best, second, sc.match),
            "alignments": [align(oriented[i], windows[win[i]], sc).shifted(int(starts[win[i]]))
                           for i in range(len(reads))]}
