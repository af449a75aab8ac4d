"""Position-specific scoring (PSSM / profile) search — the port of
``versalignlib_tpu/ops/pssm.py``.

A PSSM generalises one substitution rule to a per-position score row:
aligning profile position ``i`` against symbol code ``s`` scores ``P[i, s]``
(the model behind PSI-BLAST / MEME / HMM match states). Gap costs stay the
engine's linear or affine (Gotoh) model, and both algorithms keep their
reference semantics. Semantically a PSSM is "matrix mode with a
position-indexed read", so the oracle is the numpy fills with a precomputed
substitution plane (``ops/oracle.py``, ``ops/gotoh.py``, ``sub=``).

On the card a profile is the query side of the one-vs-many kernel
(``csrc/search.cu``): the kernel reads the (m, S) table unpacked, one int32
per entry, which is exactly what the JAX kernel's packed biased fields
decode to. :func:`pack_pssm` and :func:`pack_pssms` stay: they validate the
entry span (<= 255) as the JAX package does, and their words are that
package's format.

Score conventions: ``P[i, 0]`` must be 0 (code 0 is the padding sentinel);
codes outside the table score 0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from versalignlib_tpu_torch.alphabet import PROTEIN_ALPHABET, pad_and_encode
from versalignlib_tpu_torch.dispatch import _resolve_device
from versalignlib_tpu_torch.ops import cuda_search, gotoh, oracle
from versalignlib_tpu_torch.params import DEFAULT_PARAMETERS, AlignmentParameters
from versalignlib_tpu_torch.stats import calibrate_scores
from versalignlib_tpu_torch.types import Algorithm, TieBreak
from versalignlib_tpu_torch.utils.capabilities import check_search_budget


class PssmMeta(NamedTuple):
    """Packing descriptor of a bit-packed profile."""

    n_symbols: int    # S: table width (codes >= S score 0)
    words: int        # W: int32 words per profile row
    field_bits: int   # 4 or 8
    bias: int         # stored field = score + bias (fields non-negative)


def validate_pssm(P) -> np.ndarray:
    P = np.asarray(P, dtype=np.int32)
    if P.ndim != 2 or P.shape[1] < 2:
        raise ValueError(f"PSSM must be (m, S >= 2), got {P.shape}")
    if np.any(P[:, 0] != 0):
        raise ValueError("PSSM column 0 must be zero (code 0 is padding)")
    return P


def pack_pssms(Ps) -> tuple[np.ndarray, PssmMeta]:
    """Jointly pack K equal-shape profiles -> ((K, m, W) words, shared
    PssmMeta)."""
    Ps = [validate_pssm(P) for P in Ps]
    if len({P.shape for P in Ps}) != 1:
        raise ValueError("multi-profile packing requires equal (m, S) shapes")
    stack = np.stack(Ps)
    lo = int(min(0, stack.min()))
    hi = int(max(0, stack.max()))
    packed = [pack_pssm(P, lo=lo, hi=hi) for P in Ps]
    return np.stack([w for w, _ in packed]), packed[0][1]


def pack_pssm(P, lo: int | None = None,
              hi: int | None = None) -> tuple[np.ndarray, PssmMeta]:
    """(m, S) int score table -> ((m, W) int32 packed words, PssmMeta).

    Field width is the narrowest power of two the entry span allows (4 bits
    for span <= 15, 8 for span <= 255); wider tables are rejected.
    ``lo``/``hi`` widen the assumed entry range (joint multi-profile packs).
    """
    P = validate_pssm(P)
    m, s = P.shape
    lo = int(min(0, P.min())) if lo is None else lo
    hi = int(max(0, P.max())) if hi is None else hi
    span = hi - lo
    if span <= 15:
        fw = 4
    elif span <= 255:
        fw = 8
    else:
        raise ValueError(f"PSSM entry span {span} exceeds 255; rescale the profile")
    bias = -lo
    fpw = 32 // fw
    fmask = (1 << fw) - 1
    w_cnt = -(-s // fpw)
    words = np.zeros((m, w_cnt), dtype=np.int64)
    for w in range(w_cnt):
        for k in range(fpw):
            sym = w * fpw + k
            field = (P[:, sym].astype(np.int64) + bias) if sym < s else bias
            words[:, w] |= (field & fmask) << (fw * k)
    words = np.where(words >= (1 << 31), words - (1 << 32), words)
    return words.astype(np.int32), PssmMeta(s, w_cnt, fw, bias)


# ---------------------------------------------------------------------------
# Oracle (numpy): the semantic source of truth for profile scoring
# ---------------------------------------------------------------------------

def profile_sub_plane(P: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """(m, n) substitution plane: sub[i, j] = P[i, ref_j] (0 outside)."""
    P = validate_pssm(P)
    ref = np.asarray(ref, dtype=np.int32)
    s = P.shape[1]
    inside = (ref >= 0) & (ref < s)
    codes = np.where(inside, ref, 0)
    return np.where(inside[None, :], P[:, codes], 0).astype(np.int32)


def _profile_fill(P: np.ndarray, ref: np.ndarray, params: AlignmentParameters,
                  local: bool):
    """The fill of profile P against one ref: H (linear) or (H, E, F)
    (affine), with the plane of :func:`profile_sub_plane`."""
    dummy_read = np.zeros(P.shape[0], dtype=np.int32)
    sub = profile_sub_plane(P, ref)
    if params.affine:
        return gotoh._fill_affine(dummy_read, ref, params, local=local,
                                  col0_penalty=False, sub=sub), sub
    return oracle._fill_matrix(dummy_read, ref, params, local=local,
                               col0_penalty=False, sub=sub), sub


def score_profile_oracle(P: np.ndarray, refs: np.ndarray, params: AlignmentParameters,
                         algorithm: Algorithm) -> np.ndarray:
    """Batch profile scores vs an (R, n) code array — numpy reference, with
    the SW / NW-overlap / affine semantics of sequence scoring."""
    P = validate_pssm(P)
    refs = np.asarray(refs, dtype=np.uint8)
    local = Algorithm(algorithm) == Algorithm.SMITH_WATERMAN
    out = np.empty(refs.shape[0], dtype=np.int32)
    for i, ref in enumerate(refs):
        fill, _ = _profile_fill(P, ref, params, local)
        h = fill[0] if params.affine else fill
        if local:
            out[i] = int(h.max())
        else:
            last_col = h[1:, -1].max() if h.shape[0] > 1 else 0
            out[i] = int(max(0, int(last_col), int(h[-1, :].max())))
    return out


def profile_argmax_oracle(P: np.ndarray, refs: np.ndarray,
                          params: AlignmentParameters):
    """SW (scores, end_rows, end_cols) per pool entry — numpy reference for
    the device coords fold: the first cell attaining the global max in
    row-major order, strict-> scan seeded 0/(0, 0) (DefaultKernel.cpp:252-256)."""
    P = validate_pssm(P)
    refs = np.asarray(refs, dtype=np.uint8)
    nb = refs.shape[0]
    scores = np.zeros(nb, dtype=np.int32)
    rows = np.zeros(nb, dtype=np.int32)
    cols = np.zeros(nb, dtype=np.int32)
    for i, ref in enumerate(refs):
        fill, _ = _profile_fill(P, ref, params, True)
        h = fill[0] if params.affine else fill
        best = int(h.max())
        if best > 0:
            flat = int(np.argmax(h[1:, 1:]))  # row-major first maximum
            rows[i] = flat // ref.size
            cols[i] = flat % ref.size
            scores[i] = best
    return scores, rows, cols


def profile_consensus_text(P: np.ndarray) -> str:
    """Per-position consensus letters for the profile side of an alignment
    (argmax symbol per row; DNA letters for S <= 6 tables, the protein
    alphabet otherwise)."""
    P = validate_pssm(P)
    table = "\0ATCGN" if P.shape[1] <= 6 else ("\0" + PROTEIN_ALPHABET)
    out = []
    for row in P:
        sym = int(np.argmax(row[1:])) + 1
        out.append(table[sym] if sym < len(table) else "X")
    return "".join(out)


def profile_align_oracle(P: np.ndarray, ref: np.ndarray, params: AlignmentParameters,
                         end: tuple[int, int] | None = None,
                         ref_text: str | None = None):
    """Full SW alignment of a profile against one pool entry: gapped
    strings (profile side as consensus letters), CIGAR and true start/end
    coordinates, walked on the host.

    ``end``: (end_row, end_col) walk start (e.g. from the device coords
    fold); derived from the fill's row-major argmax when omitted. Linear
    parameters walk ``oracle._pointers``, affine ones the Gotoh pointers,
    canonical DIAG > UP > LEFT flavor in both.
    """
    P = validate_pssm(P)
    ref = np.asarray(ref, dtype=np.uint8)
    dummy_read = np.zeros(P.shape[0], dtype=np.int32)
    fill, sub = _profile_fill(P, ref, params, True)
    h = fill[0] if params.affine else fill
    if end is None:
        if int(h.max()) <= 0:
            end = (0, 0)
        else:
            flat = int(np.argmax(h[1:, 1:]))
            end = (flat // ref.size, flat % ref.size)
    score = int(h[end[0] + 1, end[1] + 1])
    consensus = profile_consensus_text(P)
    if params.affine:
        ptr = gotoh._affine_pointers(*fill, sub, params, local=True)
        return gotoh._affine_traceback(dummy_read, ref, ptr, end[0], end[1], score,
                                       consensus, ref_text)
    ptr = oracle._pointers(h, sub, None, params, local=True, tie=TieBreak.DIAG_UP_LEFT)
    return oracle._traceback(dummy_read, ref, ptr, end[0], end[1], score,
                             consensus, ref_text)


# ---------------------------------------------------------------------------
# Device path
# ---------------------------------------------------------------------------

def _device_scores(Ps: list[np.ndarray], pool: np.ndarray, params, algorithm,
                   device: torch.device, chunk: int, with_coords: bool):
    """Scores (K, R) of equal-shape profiles against the pool through the
    one-vs-many kernel, ``chunk`` pool entries per launch; with coords also
    (K, R) end rows and columns."""
    table = torch.from_numpy(np.stack(Ps)).to(device)
    k, m = table.shape[0], table.shape[1]
    r, n = pool.shape
    check_search_budget(m, n, k * min(chunk, max(r, 1)), params.affine, device)
    parts = []
    for lo in range(0, r, chunk):
        pc = torch.from_numpy(np.ascontiguousarray(pool[lo:lo + chunk])).to(device)
        got = cuda_search.pssm_scores_device(table, pc, params, algorithm, with_coords)
        parts.append([x.cpu().numpy() for x in (got if with_coords else (got,))])
    if not parts:
        return [np.zeros((k, 0), np.int32)] * (3 if with_coords else 1)
    return [np.concatenate(col, axis=-1) for col in zip(*parts)]


def calibrate_profile(P: np.ndarray, params: AlignmentParameters | None = None,
                      n: int = 128, samples: int = 512, seed: int = 0,
                      device: torch.device | str = "cuda"):
    """Gumbel calibration for profile scores vs random sequences: E-values
    for profile_search hits (``cal.evalue(score, P.shape[0], db_len)``).

    Scores ``samples`` random uniform sequences of length ``n`` through the
    profile (uniform ACGT for DNA-width tables, uniform over codes 1..S-1
    otherwise) and fits the extreme-value law with
    :func:`versalignlib_tpu_torch.stats.calibrate_scores`.
    """
    params = DEFAULT_PARAMETERS if params is None else params
    P = validate_pssm(P)
    pack_pssm(P)
    s = P.shape[1]
    hi_code = 5 if s == 6 else s  # DNA tables: uniform ACGT (skip N)
    rng = np.random.default_rng(seed)
    pool = rng.integers(1, hi_code, size=(samples, n)).astype(np.uint8)
    device = _resolve_device(device)
    (scores,) = _device_scores([P], pool, params, Algorithm.SMITH_WATERMAN, device,
                               max(samples, 1), False)
    return calibrate_scores(scores[0], P.shape[0], n, samples=samples)


# ---------------------------------------------------------------------------
# Profile construction
# ---------------------------------------------------------------------------

def pssm_from_sequences(seqs: np.ndarray, n_symbols: int = 6, pseudocount: float = 1.0,
                        scale: float = 2.0,
                        background: np.ndarray | None = None) -> np.ndarray:
    """Log-odds PSSM from aligned equal-length sequences ((B, m) codes).

    Counts each valid symbol (codes 1..n_symbols-1) per column, adds the
    pseudocount, and scores ``round(scale * log2(freq / background))``.
    Background defaults to uniform over codes 1..4 (the DNA alphabet);
    column 0 (padding) is fixed at 0.
    """
    seqs = np.asarray(seqs, dtype=np.int32)
    if seqs.ndim != 2:
        raise ValueError("seqs must be (B, m) code array")
    _, m = seqs.shape
    s = n_symbols
    counts = np.zeros((m, s), dtype=np.float64)
    for sym in range(1, s):
        counts[:, sym] = (seqs == sym).sum(axis=0)
    if background is None:
        background = np.zeros(s)
        background[1:5] = 0.25
    background = np.asarray(background, dtype=np.float64)
    P = np.zeros((m, s), dtype=np.int32)
    valid_total = counts[:, 1:].sum(axis=1) + pseudocount * (s - 1)
    for sym in range(1, s):
        if background[sym] <= 0:
            continue  # symbols with no background stay 0 (neutral)
        freq = (counts[:, sym] + pseudocount) / valid_total
        P[:, sym] = np.round(scale * np.log2(freq / background[sym]))
    return P


class ProfileHit(NamedTuple):
    """One reported profile hit: where the motif sits, not just how well.

    ``end_row``/``end_col``: 0-based profile position / pool-entry column of
    the hit's last aligned pair (the SW argmax cell). ``alignment``
    (opt-in): full traceback. ``evalue``/``bitscore`` (opt-in): Gumbel
    statistics from a profile calibration.
    """

    index: int
    score: int
    end_row: int
    end_col: int
    alignment: object = None   # types.Alignment when requested
    evalue: float | None = None
    bitscore: float | None = None


def profile_search(
    P: np.ndarray,
    pool,
    params: AlignmentParameters = None,
    algorithm: Algorithm = Algorithm.SMITH_WATERMAN,
    k: int = 10,
    device: torch.device | str = "cuda",
    chunk: int = 1 << 17,
    hits: bool = False,
    alignments: bool = False,
    calibration=None,
    db_len: int | None = None,
):
    """Top-k pool entries for a profile: (scores, indices), score-sorted
    (ties keep the lower index).

    ``P``: one (m, S) table, or a list of equal-shape tables, scored
    together in one launch per pool chunk and returning a list of (scores,
    indices). ``pool``: (R, n) uint8 code array or list of sequence strings.
    ``chunk``: pool entries per launch.

    ``hits=True`` (SW only) returns list[ProfileHit] instead, with hit
    coordinates from the kernel's argmax fold; ``alignments=True`` adds the
    full traceback per reported hit via :func:`profile_align_oracle` (host,
    k small fills); ``calibration`` (a GumbelCalibration, e.g. from
    :func:`calibrate_profile`) adds bitscore/E-value with ``db_len`` total
    database residues (default: pool cells).
    """
    params = DEFAULT_PARAMETERS if params is None else params
    multi = isinstance(P, (list, tuple))
    if not isinstance(pool, np.ndarray):
        pool = pad_and_encode(list(pool))
    want_coords = hits or alignments
    if want_coords and Algorithm(algorithm) != Algorithm.SMITH_WATERMAN:
        raise ValueError("profile hits with coordinates are SW-only "
                         "(NW overlap end cells are not a single argmax)")
    device = _resolve_device(device)
    Ps = [validate_pssm(p0) for p0 in P] if multi else [validate_pssm(P)]
    if multi:
        pack_pssms(Ps)   # equal shapes and the joint entry span
    else:
        pack_pssm(Ps[0])
    out = _device_scores(Ps, pool, params, Algorithm(algorithm), device, chunk,
                         want_coords)
    score_rows = list(out[0])
    coord_rows = list(zip(out[1], out[2])) if want_coords else None

    def topk(scores):
        kk = min(k, scores.shape[0])
        # Stable top-k: sort by (-score, index).
        order = np.lexsort((np.arange(scores.shape[0]), -scores.astype(np.int64)))
        top = order[:kk]
        return scores[top].astype(np.int32), top.astype(np.int32)

    if not want_coords:
        return [topk(s) for s in score_rows] if multi else topk(score_rows[0])
    if db_len is None:
        db_len = int(pool.size)

    def build_hits(pi):
        scores, idx = topk(score_rows[pi])
        rows, cols = coord_rows[pi]
        found = []
        for s, i in zip(scores, idx):
            er, ec = int(rows[i]), int(cols[i])
            aln = None
            if alignments:
                aln = profile_align_oracle(Ps[pi], pool[i], params, end=(er, ec))
            ev = bs = None
            if calibration is not None:
                bs = float(calibration.bit_score(int(s)))
                ev = float(calibration.evalue(int(s), Ps[pi].shape[0], db_len))
            found.append(ProfileHit(int(i), int(s), er, ec, aln, ev, bs))
        return found

    if multi:
        return [build_hits(i) for i in range(len(Ps))]
    return build_hits(0)
