"""Alignment score statistics: bit scores and E-values (Karlin-Altschul) —
the port of ``versalignlib_tpu/stats.py``.

Under the Karlin-Altschul / Gumbel theory the maximal local
(Smith-Waterman) score S of two random sequences of lengths m, n follows

    P(S >= x)  ~=  1 - exp(-K * m * n * exp(-lambda * x))

with lambda the positive root of ``sum_ij p_i q_j e^{lambda s_ij} = 1``.
Ungapped scoring has lambda from the theory (:func:`karlin_lambda`); gapped
scoring needs simulation: :func:`calibrate` scores random pairs through the
port's own score kernel (``csrc/score.cu``) and fits the Gumbel law, and
:func:`calibrate_islands` gives asymptotic constants by the island method.

E-value of a hit with raw score x against a database of total length D
with query length m: ``E = K * m * D * exp(-lambda * x)``; the bit score
``S' = (lambda * x - ln K) / ln 2`` makes ``E = m * D * 2^{-S'}``.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import torch

from versalignlib_tpu_torch.dispatch import _resolve_device
from versalignlib_tpu_torch.ops.cuda_score import score_batch_device
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm

#: Euler-Mascheroni constant (Gumbel mean = mode + gamma / lambda).
EULER_GAMMA = 0.5772156649015329

#: Background DNA composition: uniform A/C/G/T (codes 1..4).
DNA_UNIFORM = (0.25, 0.25, 0.25, 0.25)

#: Robinson & Robinson (1991) amino-acid background frequencies in
#: :data:`alphabet.PROTEIN_ALPHABET` order (B/Z/X/* at zero), the
#: composition NCBI BLAST's published (lambda, K) tables assume.
ROBINSON_FREQS = (
    0.07805, 0.05129, 0.04487, 0.05364, 0.01925, 0.04264, 0.06295,  # ARNDCQE
    0.07377, 0.02199, 0.05142, 0.09019, 0.05744, 0.02243, 0.03856,  # GHILKMF
    0.05203, 0.07120, 0.05841, 0.01330, 0.03216, 0.06441,           # PSTWYV
    0.0, 0.0, 0.0, 0.0,                                             # BZX*
)


def _score_table(params: AlignmentParameters) -> np.ndarray:
    """Dense substitution table over the valid (nonzero-scoring) codes."""
    if params.matrix is not None:
        M = np.asarray(params.matrix, dtype=np.float64)
        return M[1:, 1:]  # code 0 is padding by contract
    M = np.full((4, 4), float(params.score_mismatch))
    np.fill_diagonal(M, float(params.score_match))
    return M


def karlin_lambda(params: AlignmentParameters, freqs: tuple[float, ...] | None = None,
                  tol: float = 1e-12) -> float:
    """The ungapped Karlin-Altschul lambda for this substitution model.

    Solves ``sum_ij p_i p_j exp(lambda * s_ij) = 1`` by bisection. Requires
    a negative expected score and at least one positive score (raises
    otherwise).
    """
    S = _score_table(params)
    if freqs is None:
        k = S.shape[0]
        p = np.full(k, 1.0 / k)
    else:
        p = np.asarray(freqs, dtype=np.float64)
        if p.shape[0] != S.shape[0] or abs(p.sum() - 1.0) > 1e-9:
            raise ValueError(f"freqs must be {S.shape[0]} probabilities summing to 1")
    w = np.outer(p, p)
    expected = float((w * S).sum())
    if expected >= 0:
        raise ValueError(
            f"expected score {expected:.3f} >= 0: local-alignment "
            "statistics require a negative-drift scoring model")
    if S.max() <= 0:
        raise ValueError("no positive substitution score: lambda undefined")

    def phi(lam: float) -> float:
        return float((w * np.exp(lam * S)).sum()) - 1.0

    lo, hi = 0.0, 1.0
    while phi(hi) < 0:
        hi *= 2.0
        if hi > 1e3:
            raise ValueError("failed to bracket lambda")
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if phi(mid) < 0:
            lo = mid
        else:
            hi = mid
        if hi - lo < tol:
            break
    return 0.5 * (lo + hi)


def entropy_h(params: AlignmentParameters, freqs: tuple[float, ...] | None = None) -> float:
    """Relative entropy H in nats: ``H = lambda * sum p_i p_j s_ij e^{lambda s_ij}``."""
    lam = karlin_lambda(params, freqs)
    S = _score_table(params)
    k = S.shape[0]
    p = np.full(k, 1.0 / k) if freqs is None else np.asarray(freqs, dtype=np.float64)
    w = np.outer(p, p)
    return float(lam * (w * S * np.exp(lam * S)).sum())


@dataclasses.dataclass(frozen=True)
class GumbelCalibration:
    """Fitted extreme-value law for one scoring model.

    ``lam``/``k`` are the Gumbel parameters for ``P(S >= x) ~= 1 -
    exp(-k*m*n*e^{-lam*x})`` at the calibration lengths; ``m``/``n`` and
    ``samples`` record provenance.
    """

    lam: float
    k: float
    m: int
    n: int
    samples: int

    def bit_score(self, raw) -> np.ndarray:
        return (self.lam * np.asarray(raw, dtype=np.float64) - math.log(self.k)) / math.log(2.0)

    def evalue(self, raw, query_len: int, db_len: int) -> np.ndarray:
        """Expected chance hits >= raw in a (query_len x db_len) search."""
        return (self.k * float(query_len) * float(db_len)
                * np.exp(-self.lam * np.asarray(raw, dtype=np.float64)))

    def pvalue(self, raw, query_len: int, db_len: int) -> np.ndarray:
        return -np.expm1(-self.evalue(raw, query_len, db_len))

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, text: str) -> "GumbelCalibration":
        return cls(**json.loads(text))


def _gumbel_mle(s: np.ndarray) -> tuple[float, float]:
    """Maximum-likelihood Gumbel fit: returns (lam, mode), by damped
    fixed-point iteration on the scale equation ``beta = mean(x) -
    sum(x e^{-x/beta}) / sum(e^{-x/beta})``, then ``mode = -beta *
    ln(mean(e^{-x/beta}))``."""
    x = np.asarray(s, dtype=np.float64)
    xm = float(x.mean())
    beta = math.sqrt(6.0 * float(x.var())) / math.pi  # moments seed
    if beta <= 0:
        raise ValueError("degenerate score distribution; raise samples")
    for _ in range(200):
        w = np.exp(-(x - xm) / beta)  # shift for stability
        new = xm - float((x * w).sum() / w.sum())
        if new <= 0:
            new = beta / 2.0
        if abs(new - beta) < 1e-12 * beta:
            beta = new
            break
        beta = 0.5 * (beta + new)
    w = np.exp(-(x - xm) / beta)
    mode = xm - beta * math.log(float(w.mean()))
    return 1.0 / beta, mode


def calibrate(params: AlignmentParameters, m: int = 128, n: int = 128,
              samples: int = 512, seed: int = 0, device: torch.device | str = "cuda",
              lam: float | None = None, method: str = "ml") -> GumbelCalibration:
    """Empirically fit the Gumbel law for this scoring model (SW only).

    Scores ``samples`` random uniform pairs of shape (m, n) through the
    port's score kernel on ``device`` (the plain version with
    ``device="cpu"``), then fits the extreme-value law to the per-pair
    maxima: ``method="ml"`` (default) is the maximum-likelihood Gumbel fit,
    ``method="moments"`` lambda from the variance. K comes from the fitted
    mode: ``K = e^{lambda*mode} / (m*n)``. Pass ``lam`` to fit the location
    only.
    """
    n_codes, lo_code = (len(params.matrix) - 1, 1) if params.matrix is not None else (4, 1)
    rng = np.random.default_rng(seed)
    reads = rng.integers(lo_code, lo_code + n_codes, size=(samples, m)).astype(np.uint8)
    refs = rng.integers(lo_code, lo_code + n_codes, size=(samples, n)).astype(np.uint8)
    device = _resolve_device(device)
    scores = score_batch_device(torch.from_numpy(reads).to(device),
                                torch.from_numpy(refs).to(device), params,
                                Algorithm.SMITH_WATERMAN).cpu().numpy()
    return calibrate_scores(scores, m, n, lam=lam, method=method, samples=samples)


def calibrate_scores(scores, m: int, n: int, lam: float | None = None, method: str = "ml",
                     samples: int | None = None) -> GumbelCalibration:
    """Fit the Gumbel law to any sample of per-comparison SW maxima (each
    over an effective m x n search space): the fitting core of
    :func:`calibrate`, reused for profiles and translated search."""
    s = np.asarray(scores, dtype=np.float64)
    if lam is not None:
        mode = float(s.mean()) - EULER_GAMMA / lam
    elif method == "ml":
        lam, mode = _gumbel_mle(s)
    elif method == "moments":
        var = float(s.var())
        if var <= 0:
            raise ValueError("degenerate score distribution; raise samples")
        lam = math.pi / math.sqrt(6.0 * var)
        mode = float(s.mean()) - EULER_GAMMA / lam
    else:
        raise ValueError(f"unknown method {method!r} (ml | moments)")
    k = math.exp(lam * mode) / (m * n)
    return GumbelCalibration(lam=lam, k=k, m=m, n=n,
                             samples=len(s) if samples is None else samples)


# ---------------------------------------------------------------------------
# Island method (Altschul-Bundschuh-Olsen-Hwa 2001): asymptotic (lambda, K)
# from the per-island peak-score distribution. Host numpy.
# ---------------------------------------------------------------------------

def island_scores(reads: np.ndarray, refs: np.ndarray, params: AlignmentParameters,
                  margin: int = 0) -> np.ndarray:
    """All SW island peak scores of a batch of encoded pairs (host numpy).

    An island is a maximal set of DP cells whose optimal local paths trace
    back to the same zero-scoring origin; its peak is the largest H over the
    set. Anchors propagate through the DP row by row (vectorised over the
    batch and the ref axis; the in-row E dependency resolves through a
    running prefix max over the gap-free part G of H). Affine and linear
    gaps share the recurrence (linear = ``gap_open 0``). ``margin`` drops
    islands anchored in the last ``margin`` rows/columns.
    """
    B, m = reads.shape
    n = refs.shape[1]
    S = _score_table(params)
    S_int = np.rint(S).astype(np.int64)
    if not np.array_equal(S_int, S):
        raise ValueError("island method requires an integer score lattice")
    open_r = int(params.gap_open_read)
    ext_r = int(params.score_gap_read)
    open_f = int(params.gap_open_ref)
    ext_f = int(params.score_gap_ref)
    NEG = np.int64(-1) << 40

    ri = reads.astype(np.int64) - 1          # codes 1..k -> table rows
    fi = refs.astype(np.int64) - 1
    if ri.min() < 0 or fi.min() < 0:
        raise ValueError("island_scores takes valid codes only (>= 1)")

    ids_base = 1 + np.arange(n, dtype=np.int64)[None, :]   # anchor id of
    # cell (i, j) = 1 + i*n + (j-1); id 0 = "none" sink for dead anchors.
    js = np.arange(1, n + 1, dtype=np.int64)[None, :]      # ref positions
    jidx = np.arange(n, dtype=np.int64)[None, :]           # row-array index
    b_off = (np.arange(B, dtype=np.int64) * (m * n + 1))[:, None]
    peaks = np.zeros(B * (m * n + 1), dtype=np.int64)

    H_prev = np.zeros((B, n + 1), np.int64)   # previous row incl. col 0
    aH_prev = np.zeros((B, n + 1), np.int64)
    F = np.full((B, n), NEG, np.int64)        # F/anchors for columns 1..n
    aF = np.zeros((B, n), np.int64)

    for i in range(m):
        srow = S_int[ri[:, i][:, None], fi]                # (B, n)
        # F: gap in the ref (vertical), donors from the previous row.
        open_cand = H_prev[:, 1:] + (open_f + ext_f)
        ext_cand = F + ext_f
        aF = np.where(ext_cand >= open_cand, aF, aH_prev[:, 1:])
        F = np.maximum(ext_cand, open_cand)
        # Gap-free part of H: zero-restart, diagonal, F.
        diag = H_prev[:, :-1] + srow
        ids_row = ids_base + i * n
        a_diag = np.where(H_prev[:, :-1] > 0, aH_prev[:, :-1], ids_row)
        G = np.maximum(0, np.maximum(diag, F))
        aG = np.where(G == 0, ids_row, np.where(G == diag, a_diag, aF))
        # E: gap in the read (horizontal) via prefix max over G.
        cand = G - ext_r * js
        run = np.maximum.accumulate(cand, axis=1)
        src = np.maximum.accumulate(np.where(cand >= run, jidx, np.int64(-1)), axis=1)
        E = np.empty((B, n), np.int64)
        E[:, 0] = NEG
        E[:, 1:] = run[:, :-1] + (open_r + ext_r) + ext_r * jidx[:, 1:]
        aE = np.take_along_axis(aG, np.maximum(np.roll(src, 1, axis=1), 0), axis=1)
        aE[:, 0] = 0
        H = np.maximum(G, E)
        aH = np.where(E > G, aE, aG)
        # Fold this row's values into the per-anchor peaks (H > 0 only).
        bm, jm = np.nonzero(H > 0)
        if bm.size:
            flat = b_off[bm, 0] + aH[bm, jm]
            np.maximum.at(peaks, flat, H[bm, jm])
        H_prev[:, 1:] = H
        aH_prev[:, 1:] = aH

    peaks = peaks.reshape(B, m * n + 1)[:, 1:]
    out = []
    for b in range(B):
        nz = np.nonzero(peaks[b])[0]
        if margin:
            ai, aj = nz // n, nz % n
            nz = nz[(ai < m - margin) & (aj < n - margin)]
        out.append(peaks[b][nz])
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def island_fit(peaks: np.ndarray, c: int, area: float,
               n_matrices: int) -> tuple[float, float]:
    """(lambda, K) from island peaks at threshold ``c``: the lattice
    geometric tail MLE ``lambda = ln(1 + A / sum(s - c))`` over the A
    islands with peak >= c, and ``K = A e^{lambda*c} / (n_matrices * area)``."""
    sel = np.asarray(peaks)[np.asarray(peaks) >= c]
    A = int(sel.size)
    if A < 16:
        raise ValueError(f"only {A} islands >= c={c}; lower c or add samples")
    excess = float((sel - c).sum())
    if excess <= 0:
        raise ValueError(f"all islands sit exactly at c={c}; lower c")
    lam = math.log1p(A / excess)
    K = A * math.exp(lam * c) / (n_matrices * area)
    return lam, K


def calibrate_islands(params: AlignmentParameters, m: int = 1024, n: int = 1024,
                      samples: int = 16, seed: int = 0, c: int | None = None,
                      margin: int | None = None, chunk: int = 8,
                      freqs: tuple[float, ...] | None = None) -> GumbelCalibration:
    """Published-table-quality (lambda, K) via the island method.

    Samples random pairs over the model's alphabet (``freqs`` sets the
    background composition, default uniform; pass :data:`ROBINSON_FREQS`
    for protein models), extracts every island peak and fits the geometric
    tail at threshold ``c`` (default: the 99.5th peak percentile, lowered
    until >= 100 islands remain). ``margin`` (default ``min(m, n) // 8``)
    drops edge-truncated anchors.
    """
    n_codes = len(params.matrix) - 1 if params.matrix is not None else 4
    if margin is None:
        margin = min(m, n) // 8
    if freqs is not None:
        pvec = np.asarray(freqs, dtype=np.float64)
        if pvec.shape[0] != n_codes or abs(pvec.sum() - 1.0) > 1e-6:
            raise ValueError(f"freqs must be {n_codes} probabilities summing to 1")
        pvec = pvec / pvec.sum()
    rng = np.random.default_rng(seed)
    peaks = []
    for lo in range(0, samples, chunk):
        bs = min(chunk, samples - lo)
        if freqs is None:
            reads = rng.integers(1, 1 + n_codes, size=(bs, m)).astype(np.uint8)
            refs = rng.integers(1, 1 + n_codes, size=(bs, n)).astype(np.uint8)
        else:
            reads = (1 + rng.choice(n_codes, size=(bs, m), p=pvec)).astype(np.uint8)
            refs = (1 + rng.choice(n_codes, size=(bs, n), p=pvec)).astype(np.uint8)
        peaks.append(island_scores(reads, refs, params, margin=margin))
    peaks = np.concatenate(peaks)
    if c is None:
        c = int(np.quantile(peaks, 0.995))
        while (peaks >= c).sum() < 100 and c > 1:
            c -= 1
    area = float((m - margin) * (n - margin))
    lam, K = island_fit(peaks, c, area, samples)
    return GumbelCalibration(lam=lam, k=K, m=m, n=n, samples=samples)
