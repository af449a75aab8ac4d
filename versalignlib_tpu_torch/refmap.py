"""Whole-reference read mapping: exhaustive window tiling on the card.

The port of ``versalignlib_tpu/refmap.py`` (less the mesh helpers). Reads
are mapped against long references (contigs, chromosomes) by tiling each
reference into overlapping fixed-size windows and scoring every (read,
window) pair with the one-vs-many kernel (``csrc/search.cu``). Exhaustive
search is exact by construction: ``stride = window - overlap`` with
``overlap >= max_read_span`` puts every reference interval a read can align
to entirely inside at least one window, so the best window score is the
best full-reference score. Window coordinates shift back to global
reference coordinates on output.

MAPQ needs the best score gap over distinct loci, and nearby windows see
the same locus through their overlap, so the fold keeps the top-k (value,
window) pairs per read, and the second best is the best candidate on a
different reference or at least ceil(window/stride) windows away.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from versalignlib_tpu_torch.alphabet import pad_and_encode, reverse_complement_codes
from versalignlib_tpu_torch.dispatch import _resolve_device
from versalignlib_tpu_torch.params import DEFAULT_PARAMETERS, AlignmentParameters
from versalignlib_tpu_torch.search import (NEG32, _align_pairs, _chunk_for,
                                           _chunk_scores, _encode, _mapq_from_gap,
                                           _to_device, _topk, unmapped_alignment)
from versalignlib_tpu_torch.types import Algorithm, Alignment, TieBreak
from versalignlib_tpu_torch.utils.capabilities import check_search_budget

#: Minimum top-k pool per read; map_to_reference widens it to twice the
#: same-locus window distance, so the pool always keeps a distinct-locus
#: candidate when one exists.
TOPK = 4


@dataclasses.dataclass(frozen=True)
class WindowIndex:
    """Tiling of one or more reference sequences into scoring windows. Its
    ``.npz`` file has the JAX package's layout, so either package loads what
    the other saved."""

    windows: np.ndarray    # (n_windows, window) uint8 codes, 0-padded tails
    ref_id: np.ndarray     # (n_windows,) which reference each window tiles
    start: np.ndarray      # (n_windows,) global start of each window
    window: int
    stride: int
    ref_lengths: list[int]

    def __len__(self) -> int:
        return self.windows.shape[0]

    def save(self, path) -> None:
        """Persist the tiling (npz): tile a large genome once, reuse it."""
        np.savez_compressed(
            path, windows=self.windows, ref_id=self.ref_id, start=self.start,
            meta=np.array([self.window, self.stride], dtype=np.int64),
            ref_lengths=np.array(self.ref_lengths, dtype=np.int64))

    @classmethod
    def load(cls, path) -> "WindowIndex":
        with np.load(path) as z:
            return cls(windows=z["windows"], ref_id=z["ref_id"], start=z["start"],
                       window=int(z["meta"][0]), stride=int(z["meta"][1]),
                       ref_lengths=[int(v) for v in z["ref_lengths"]])


def tile_references(references, window: int, stride: int) -> WindowIndex:
    """Tile reference sequences (str or uint8 code arrays) into windows.

    Windows never span two references. The final window of each reference
    starts at the last stride multiple below its length and is 0-padded, so
    every suffix is covered.
    """
    if window <= 0 or stride <= 0 or stride > window:
        raise ValueError(f"need 0 < stride <= window, got window={window} stride={stride}")
    if isinstance(references, (str, np.ndarray)) and getattr(references, "ndim", 1) == 1:
        references = [references]
    enc = [r if isinstance(r, np.ndarray) else pad_and_encode([r])[0] for r in references]
    if not enc:
        return WindowIndex(windows=np.zeros((0, window), dtype=np.uint8),
                           ref_id=np.zeros(0, dtype=np.int32),
                           start=np.zeros(0, dtype=np.int64),
                           window=window, stride=stride, ref_lengths=[])
    chunks, rids, starts = [], [], []
    for rid, codes in enumerate(enc):
        length = codes.shape[0]
        n_w = max(1, -(-max(length - window, 0) // stride) + 1)
        padded = np.zeros((n_w - 1) * stride + window, dtype=np.uint8)
        padded[:length] = codes
        view = np.lib.stride_tricks.sliding_window_view(padded, window)[::stride]
        chunks.append(view)
        rids.append(np.full(view.shape[0], rid, dtype=np.int32))
        starts.append(np.arange(view.shape[0], dtype=np.int64) * stride)
    return WindowIndex(windows=np.ascontiguousarray(np.concatenate(chunks)),
                       ref_id=np.concatenate(rids), start=np.concatenate(starts),
                       window=window, stride=stride,
                       ref_lengths=[c.shape[0] for c in enc])


def _stream_topk(reads_enc, windows, params, algorithm, device, chunk, k: int = TOPK):
    """Top-k (score, window-index) fold over window chunks.

    Returns (vals (B, k) int32 descending, args (B, k) int32). Ties within
    and across chunks resolve to the lower window index (scan order): each
    chunk's top-k is stable on the card (``search._topk``), and the host
    merge sorts by (-score, window).
    """
    b = reads_enc.shape[0]
    r = windows.shape[0]
    reads_dev = _to_device(reads_enc, device)
    vals = np.full((b, k), NEG32, dtype=np.int64)
    args = np.zeros((b, k), dtype=np.int64)
    for lo in range(0, r, chunk):
        pc = windows[lo:lo + chunk]
        kk = min(k, pc.shape[0])
        top_v, top_a = _topk(_chunk_scores(reads_dev, pc, params, algorithm), kk)
        cand_v = np.concatenate([vals, top_v.astype(np.int64)], axis=1)
        cand_a = np.concatenate([args, top_a + lo], axis=1)
        order = np.lexsort((cand_a, -cand_v), axis=1)[:, :k]
        vals = np.take_along_axis(cand_v, order, axis=1)
        args = np.take_along_axis(cand_a, order, axis=1)
    return vals.astype(np.int32), args.astype(np.int32)


def _second_distinct(vals, args, win_arg, ref_id, min_dist):
    """Best score among pool candidates at a locus distinct from each
    read's winning window ``win_arg`` (NEG32 if the pool has none).

    Distinct = a different reference sequence, or the same reference at
    window distance >= ``min_dist`` (= ceil(window/stride)).
    """
    win = win_arg[:, None]
    distinct = (ref_id[args] != ref_id[win]) | (np.abs(args - win) >= min_dist)
    distinct &= vals > NEG32
    masked = np.where(distinct, vals, NEG32)
    return masked.max(axis=1).astype(np.int32)


@dataclasses.dataclass
class ReferenceHits:
    """Per-read best-locus results from :func:`map_to_reference`.

    Alignments (``align=True``) are in global reference coordinates:
    ``ref_start``/``ref_end`` index into the full reference ``ref_id[i]``.
    """

    ref_id: np.ndarray      # (B,) reference index (-1: empty reference set)
    pos: np.ndarray         # (B,) int64 global start of the hit window
    score: np.ndarray       # (B,) int32 best window score
    strand: np.ndarray      # (B,) 0 = forward, 1 = reverse complement
    mapq: np.ndarray        # (B,) uint8 distinct-locus gap heuristic
    alignments: list[Alignment] | None

    def __len__(self) -> int:
        return self.ref_id.shape[0]


def map_to_reference(
    reads,
    references,
    params: AlignmentParameters = DEFAULT_PARAMETERS,
    algorithm: Algorithm = Algorithm.SMITH_WATERMAN,
    window: int | None = None,
    stride: int | None = None,
    device: torch.device | str = "cuda",
    max_pairs: int = 1 << 20,
    align: bool = True,
    backend: str = "auto",
    tie: TieBreak = TieBreak.DIAG_UP_LEFT,
    both_strands: bool = True,
) -> ReferenceHits:
    """Map reads against long references by exhaustive window scoring.

    ``window`` defaults to 4x the longest read (rounded up to a multiple of
    128) and ``stride`` to ``window // 2``: any alignment whose reference
    span is <= window - stride is fully contained in some window, making the
    search exact. Both strands are scored (DNA; ``both_strands=False`` turns
    it off). ``align=True`` traces back each read against its winning window
    only and shifts the result to global coordinates. ``references`` may be
    a prebuilt :class:`WindowIndex`.
    """
    if params.matrix is not None and both_strands:
        raise ValueError("both_strands mapping is DNA-only (custom "
                         "substitution matrices have no complement)")
    reads_enc = _encode(reads)
    b, m = reads_enc.shape
    if isinstance(references, WindowIndex):
        index = references
    else:
        if window is None:
            window = max(128, -(-4 * m // 128) * 128)
        if stride is None:
            stride = window // 2
        index = tile_references(references, window, stride)
    overlap = index.window - index.stride
    if overlap < min(2 * m, index.stride):
        warnings.warn(
            f"window-stride overlap {overlap} < 2x read length {2 * m}: "
            f"alignments spanning more than {overlap}bp of reference may "
            "straddle every window and score low", stacklevel=2)
    device = _resolve_device(device)
    n_w = len(index)
    if b == 0 or n_w == 0:
        return ReferenceHits(np.full(b, -1, np.int32), np.zeros(b, np.int64),
                             np.full(b, NEG32, np.int32), np.zeros(b, np.int8),
                             np.zeros(b, np.uint8),
                             [unmapped_alignment() for _ in range(b)] if align else None)
    algorithm = Algorithm(algorithm)
    chunk = _chunk_for(b, n_w, max_pairs)
    check_search_budget(m, index.window, b * chunk, params.affine, device)
    # Windows of one reference closer than this overlap the winner's locus;
    # the pool must be wide enough to keep a distinct candidate past up to
    # 2 * (min_dist - 1) overlap neighbours.
    min_dist = -(-index.window // index.stride)
    k = max(TOPK, 2 * min_dist)
    vals, args = _stream_topk(reads_enc, index.windows, params, algorithm,
                              device, chunk, k=k)
    if both_strands:
        rc_enc = reverse_complement_codes(reads_enc)
        rc_vals, rc_args = _stream_topk(rc_enc, index.windows, params, algorithm,
                                        device, chunk, k=k)
        rev = rc_vals[:, 0] > vals[:, 0]     # strict >: forward wins ties
        # The distinct-locus second best takes candidates from both
        # orientations relative to the winning orientation's locus.
        all_vals = np.concatenate([vals, rc_vals], axis=1)
        all_args = np.concatenate([args, rc_args], axis=1)
        win_arg = np.where(rev, rc_args[:, 0], args[:, 0])
        second = _second_distinct(all_vals, all_args, win_arg, index.ref_id, min_dist)
        best = np.where(rev, rc_vals[:, 0], vals[:, 0])
        arg = win_arg
        strand = rev.astype(np.int8)
        oriented = np.where(rev[:, None], rc_enc, reads_enc)
    else:
        best = vals[:, 0]
        arg = args[:, 0]
        second = _second_distinct(vals, args, args[:, 0], index.ref_id, min_dist)
        strand = np.zeros(b, dtype=np.int8)
        oriented = reads_enc
    mapq = _mapq_from_gap(best, second, params)
    alns = None
    if align:
        alns = _align_pairs(oriented, index.windows[arg], params, algorithm, tie,
                            backend, device)
        # Window-relative coordinates to global reference coordinates.
        alns = [dataclasses.replace(a, ref_start=a.ref_start + int(index.start[w]),
                                    ref_end=a.ref_end + int(index.start[w]))
                for a, w in zip(alns, arg)]
    return ReferenceHits(index.ref_id[arg].astype(np.int32),
                         index.start[arg].astype(np.int64),
                         best.astype(np.int32), strand, mapq, alns)
