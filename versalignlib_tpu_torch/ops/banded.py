"""Banded DP for long pairs (10-100 kbp): the counterpart of
``versalignlib_tpu/ops/banded.py`` (``banded_score_batch``,
``banded_align_batch``, and the numpy definitions of the banded semantics,
``banded_score_oracle`` and ``banded_align_oracle``).

A diagonal band of ``band`` columns follows the main diagonal with per-row
start ``o(i) = clamp(i*n//m - band/2, 0, n - band)``; cells outside it are
-inf (an approximation by construction, exact when the band covers the
ref). Scores come from ``csrc/banded_score.cu``; alignments from
``csrc/banded_align.cu``, which writes band-relative pointer rows, and a
walk of them: on the card ``csrc/banded_walk.cu`` with a replay of its row
records on the host, or the native host walk. A tensor on the CPU takes the
plain versions (``ops/plain_banded.py``, ``ops/walk.py``); on the card the
kernels launch or raise.
"""

from __future__ import annotations

import numpy as np
import torch

from versalignlib_tpu_torch.alphabet import make_validity, substitution_scores
from versalignlib_tpu_torch.dispatch import _resolve_device
from versalignlib_tpu_torch.native import decode_banded_native
from versalignlib_tpu_torch.ops import cuda_banded, cuda_walk
from versalignlib_tpu_torch.ops import traceback as tb
from versalignlib_tpu_torch.ops import walk as walks
from versalignlib_tpu_torch.ops.cuda_align import last_valid_pos as _last_valid_pos
from versalignlib_tpu_torch.ops.oracle import _text_from_codes
from versalignlib_tpu_torch.ops.plain import NEG_INF
from versalignlib_tpu_torch.ops.plain_banded import BAND_PACK, nw_end_cells
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import (Algorithm, Alignment, AlignmentBatch, TieBreak,
                                          Trace, cigar_from_gapped)


def band_offsets(m_pad: int, m_real: int, n: int, band: int) -> np.ndarray:
    """Per-row band start columns (0-based ref position of band cell 0)."""
    i = np.arange(m_pad, dtype=np.int64)
    o = (i * n) // max(m_real, 1) - band // 2
    return np.clip(o, 0, max(n - band, 0)).astype(np.int32)


def max_band_step(m_real: int, n: int) -> int:
    """Max per-row band advance D = ceil(n/m) (offsets are monotone): a
    bound from the shapes alone, kept for the JAX package's API. The kernels
    and plain versions size their rows by the offsets' own largest step
    (``plain_banded.max_step``), which never exceeds it."""
    return max(1, -(-n // max(m_real, 1)))


def last_valid_pos(codes: np.ndarray, valid=None) -> int:
    """max_*_pos for one sequence: index before the first invalid code, else
    len-1. ``valid``: elementwise validity predicate (default: the canonical
    flavor, any nonzero code). Kept for the JAX package's API; the batch
    paths use ``cuda_align.last_valid_pos``."""
    codes = np.asarray(codes)
    inv = np.flatnonzero(codes == 0 if valid is None else ~valid(codes))
    return int(inv[0]) - 1 if inv.size else codes.size - 1


# ---------------------------------------------------------------------------
# NumPy banded oracle (semantics definition): the port's copy of the JAX
# package's, numpy only
# ---------------------------------------------------------------------------

def banded_score_oracle(read, ref, p: AlignmentParameters, band: int,
                        algorithm: Algorithm,
                        offsets: np.ndarray | None = None) -> int:
    """Reference banded score: full-matrix DP with -inf outside the band.

    Row 0 and (for band windows touching it) column 0 are 0 — the same free
    boundaries as the dense kernels, restricted to the band.
    """
    read = np.asarray(read, dtype=np.int32)
    ref = np.asarray(ref, dtype=np.int32)
    m, n = read.size, ref.size
    local = Algorithm(algorithm) == Algorithm.SMITH_WATERMAN
    if offsets is None:
        offsets = band_offsets(m, m, n, band)
    band = min(band, n)
    NEG = np.int64(NEG_INF)
    h = np.zeros((m + 1, n + 1), dtype=np.int64)
    f = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    best = np.int64(0)
    last_col = np.int64(NEG)
    for i in range(1, m + 1):
        o = int(offsets[i - 1])
        prev = h[i - 1]
        f_prev = f[i - 1]
        row = np.full(n + 1, NEG, dtype=np.int64)
        f_row = np.full(n + 1, NEG, dtype=np.int64)
        row[0] = 0
        lo, hi = o + 1, min(o + band, n)  # H columns in band
        sub = substitution_scores(
            read[i - 1], ref[lo - 1 : hi], p.score_match, p.score_mismatch,
            p.matrix,
        ).astype(np.int64)
        e = NEG
        for j in range(lo, hi + 1):
            diag = prev[j - 1] + sub[j - lo]
            if p.affine:
                f_row[j] = max(prev[j] + p.gap_open_ref + p.score_gap_ref,
                               f_prev[j] + p.score_gap_ref, NEG)
                e = max(row[j - 1] + p.gap_open_read + p.score_gap_read,
                        e + p.score_gap_read, NEG)
                cur = max(diag, f_row[j], e)
            else:
                up = prev[j] + p.score_gap_ref
                left = row[j - 1] + p.score_gap_read
                cur = max(diag, up, left)
            cur = max(cur, NEG)
            if local:
                cur = max(cur, 0)
                best = max(best, cur)
            row[j] = cur
        h[i] = row
        f[i] = f_row
        if not local and hi == n:
            last_col = max(last_col, row[n])
    if local:
        return int(best)
    final = max(int(h[m].max()), int(last_col), 0)
    return final


def banded_align_oracle(read, ref, p: AlignmentParameters, band: int,
                        algorithm: Algorithm,
                        offsets: np.ndarray | None = None,
                        read_text: str | None = None,
                        ref_text: str | None = None,
                        tie=None):
    """Reference banded ALIGNMENT: full-matrix DP with -inf outside the band,
    canonical pointer flavor, explicit end-cell rules. This is the semantics
    definition; ``ops/plain_banded.py`` and the kernels compute the same
    alignments in their band-relative layout (the reference has no banding;
    its only long-pair strategy is spilling the pointer matrix to global
    memory, alignment_kernels.cl:10-12). The pointer matrix here stays dense
    over the whole (m + 1, n + 1) grid, as in the JAX package's oracle.

    Boundaries are the banded-score oracle's (row 0 / col 0 free). Pointer
    model: canonical flavor (``tie`` None/DIAG_UP_LEFT) linear DIAG > UP >
    LEFT with SW zero-force; affine 4-bit ``hptr | e_ext<<2 | f_ext<<3``
    with extend-beats-open ties (ops/gotoh.py). SSE flavor
    (``TieBreak.DIAG_LEFT_UP``): validity-gated DIAG > LEFT > UP (affine:
    DIAG > LEFT(E) > UP(F)), no SW zero-force, and validity-flavored NW
    end-cell tracking — the banded extension of the dense SSE rules
    (oracle._pointers / gotoh._affine_pointers).

    End cells:
      - SW: first in-band cell (row-major) attaining the global clamped max;
        (0, 0) when the max is 0 (the reference's argmax-initial cell).
      - NW (overlap): row = last valid read row ``mrp`` (code != 0 flavor);
        column = leftmost argmax over that row's band cells at valid ref
        positions (<= max_ref_pos) — the banded analogue of the dense
        ``(max_read_pos, min(max_ref_pos, globalRowMaxIndex))`` rule
        (DefaultKernel.cpp:285-388) that keeps tracebacks off padding
        rows/columns. Empty intersection (or mrp < 0) -> empty alignment.

    The walk stops at START pointers, at the free row-0/col-0 boundaries,
    and when stepping outside the band.
    """
    read = np.asarray(read, dtype=np.int32)
    ref = np.asarray(ref, dtype=np.int32)
    m, n = read.size, ref.size
    local = Algorithm(algorithm) == Algorithm.SMITH_WATERMAN
    canonical = tie is None or TieBreak(tie) == TieBreak.DIAG_UP_LEFT
    vfn = make_validity(p.matrix)
    rvalid = vfn(read)
    fvalid = vfn(ref)
    if offsets is None:
        offsets = band_offsets(m, m, n, band)
    band = min(band, n)
    affine = p.affine
    NEG = np.int64(NEG_INF)
    D, U, L, S = 3, 1, 2, 0  # Trace.DIAG/UP/LEFT/START

    h = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    h[0, :] = 0
    h[:, 0] = 0
    f = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    ptr = np.zeros((m + 1, n + 1), dtype=np.uint8)
    for i in range(1, m + 1):
        o = int(offsets[i - 1])
        lo, hi = o + 1, min(o + band, n)
        sub_row = substitution_scores(
            read[i - 1], ref[lo - 1 : hi], p.score_match, p.score_mismatch,
            p.matrix,
        ).astype(np.int64)
        e = NEG
        for j in range(lo, hi + 1):
            diag_v = h[i - 1, j - 1] + sub_row[j - lo]
            if affine:
                f_prev = f[i - 1, j]
                f_v = max(h[i - 1, j] + p.gap_open_ref + p.score_gap_ref,
                          f_prev + p.score_gap_ref, NEG)
                e_prev = e
                e = max(h[i, j - 1] + p.gap_open_read + p.score_gap_read,
                        e_prev + p.score_gap_read, NEG)
                cur = max(diag_v, f_v, e)
            else:
                up_v = h[i - 1, j] + p.score_gap_ref
                left_v = h[i, j - 1] + p.score_gap_read
                cur = max(diag_v, up_v, left_v)
            cur = max(cur, NEG)
            if local:
                cur = max(cur, 0)
            cell_valid = bool(rvalid[i - 1]) and bool(fvalid[j - 1])
            if affine:
                if canonical:
                    hp = D if cur == diag_v else (U if cur == f_v else
                                                  (L if cur == e else S))
                    if local and cur == 0:
                        hp = S
                else:
                    hp = (D if (cur == diag_v and cell_valid) else
                          (L if cur == e else (U if cur == f_v else S)))
                e_ext = 1 if e == e_prev + p.score_gap_read else 0
                f_ext = 1 if f_v == f_prev + p.score_gap_ref else 0
                ptr[i, j] = hp | (e_ext << 2) | (f_ext << 3)
                f[i, j] = f_v
            else:
                if canonical:
                    hp = D if cur == diag_v else (U if cur == up_v else
                                                  (L if cur == left_v else S))
                    if local and cur == 0:
                        hp = S
                else:
                    hp = (D if (cur == diag_v and cell_valid) else
                          (L if cur == left_v else (U if cur == up_v else S)))
                ptr[i, j] = hp
            h[i, j] = cur

    # In-band mask over inner cells (for end-cell picks and walk bounds).
    jj = np.arange(1, n + 1)[None, :]
    oo = np.asarray(offsets[:m], dtype=np.int64)[:, None]
    in_band = (jj >= oo + 1) & (jj <= np.minimum(oo + band, n))

    if local:
        inner = np.where(in_band, h[1:, 1:], -1)
        best = int(inner.max(initial=0))
        if best <= 0:
            start_r, start_f, score = 0, 0, 0
        else:
            flat = int(np.argmax(inner))
            start_r, start_f = divmod(flat, n)
            score = best
    else:
        bvalid = None if canonical else vfn
        mrp = last_valid_pos(read, bvalid)
        max_ref_pos = last_valid_pos(ref, bvalid)
        if mrp < 0:
            start_r = start_f = -1
            score = 0
        else:
            o = int(offsets[mrp])
            hi = min(o + band, n, max_ref_pos + 1)
            if hi <= o:
                start_r = start_f = -1
                score = 0
            else:
                vals = h[mrp + 1, o + 1 : hi + 1]
                arg = int(np.argmax(vals))
                start_r, start_f = mrp, o + arg
                score = int(vals[arg])

    return _banded_oracle_walk(ptr, in_band, read, ref, start_r, start_f,
                               score, affine, read_text, ref_text)


def _banded_oracle_walk(ptr, in_band, read, ref, start_r, start_f, score,
                        affine, read_text=None, ref_text=None):
    """Shared walker over the oracle's dense banded pointer matrix."""
    m, n = read.shape[0], ref.shape[0]
    if read_text is None:
        read_text = _text_from_codes(read)
    if ref_text is None:
        ref_text = _text_from_codes(ref)
    rp, fp = int(start_r), int(start_f)
    rg, fg = [], []
    state = 0  # 0=H, 1=F(up), 2=E(left) — affine only
    steps = 0
    while steps <= m + n and rp >= 0 and fp >= 0:
        if not in_band[rp, fp]:
            break
        code = int(ptr[rp + 1, fp + 1])
        hp = code & 3
        if not affine:
            if hp == Trace.START:
                break
            if hp == Trace.UP:
                rg.append(read_text[rp]); fg.append("-"); rp -= 1
            elif hp == Trace.LEFT:
                rg.append("-"); fg.append(ref_text[fp]); fp -= 1
            else:
                rg.append(read_text[rp]); fg.append(ref_text[fp])
                rp -= 1; fp -= 1
            steps += 1
            continue
        if state == 0:
            if hp == Trace.START:
                break
            if hp == Trace.DIAG:
                rg.append(read_text[rp]); fg.append(ref_text[fp])
                rp -= 1; fp -= 1
                steps += 1
            elif hp == Trace.UP:
                state = 1
            else:
                state = 2
        elif state == 1:
            rg.append(read_text[rp]); fg.append("-")
            rp -= 1
            if not ((code >> 3) & 1):
                state = 0
            steps += 1
        else:
            rg.append("-"); fg.append(ref_text[fp])
            fp -= 1
            if not ((code >> 2) & 1):
                state = 0
            steps += 1
    read_g = "".join(reversed(rg))
    ref_g = "".join(reversed(fg))
    aln_length = m + n
    return Alignment(
        read=read_g, ref=ref_g, score=int(score),
        cigar=cigar_from_gapped(read_g, ref_g),
        read_start=rp + 1, read_end=int(start_r) + 1,
        ref_start=fp + 1, ref_end=int(start_f) + 1,
        buffer_start=aln_length - 1 - len(rg), buffer_end=aln_length - 1,
    )


def banded_score_batch(
    reads: np.ndarray,
    refs: np.ndarray,
    params: AlignmentParameters,
    algorithm: Algorithm,
    band: int = 512,
    tile: int = 256,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Banded batch scoring: (B, m) x (B, n) codes -> (B,) int32.

    ``band`` is rounded down to the ref length. Rows pad with code 0 to a
    multiple of ``tile`` (at most max(8, m)), as the JAX package pads them,
    and the NW score reads the final padded row and the last column of every
    row, so it equals the JAX package's at every ``tile``.
    """
    device = _resolve_device(device)
    b, m = reads.shape
    n = refs.shape[1]
    if b == 0 or m == 0 or n == 0:
        return np.zeros(b, dtype=np.int32)
    band = min(band, n)
    tile = min(tile, max(8, m))
    m_pad = -(-m // tile) * tile
    reads_pad = np.zeros((b, m_pad), dtype=np.uint8)
    reads_pad[:, :m] = reads
    out = cuda_banded.score(
        torch.from_numpy(reads_pad).to(device),
        torch.from_numpy(np.ascontiguousarray(refs, np.uint8)).to(device),
        band_offsets(m_pad, m, n, band), params, Algorithm(algorithm), band)
    return out.cpu().numpy().astype(np.int32)


def banded_align_batch(
    reads: np.ndarray,
    refs: np.ndarray,
    params: AlignmentParameters,
    algorithm: Algorithm,
    band: int = 512,
    tile: int = 64,
    device: torch.device | str = "cuda",
    raw: bool = False,
    chunk_pairs: int | None = None,
    tie=None,
    device_walk: bool | None = None,
    gapped: bool = True,
):
    """Banded full alignment: pointer fill on ``device``, then the band
    walk: with ``device_walk`` on the device too (``ops/cuda_walk.py``),
    whose row records the host replays, else on the host. None, the
    default, walks on the card for CUDA and on the host for the CPU, as the
    JAX package walks on the device when compiled. Semantics:
    ``banded_align_oracle`` (both tie flavors, linear and affine gaps).

    ``tile`` is accepted for the JAX signature and changes nothing: the
    kernel has no row tiles, and the JAX package's outputs do not depend on
    them. Pairs go through in rounds of ``chunk_pairs`` (default
    ``cuda_banded.chunk_pairs_for``: at most 2.25 GiB of pointer words, or
    with the walk on the device, where they stay, 16 GiB; in whole waves of
    four pairs per SM); the fill of round k+1 is queued before round k is
    decoded, and the pointer words or the records come back into two
    page-locked buffers that later calls reuse
    (``cuda_banded.PINNED.release()`` frees them). Returns a list of
    :class:`Alignment`, or with ``raw=True`` an :class:`AlignmentBatch`
    (``gapped=False``: without the gapped strings).
    """
    device = _resolve_device(device)
    device_walk = cuda_walk.resolve_device_walk(device_walk, device)
    algorithm = Algorithm(algorithm)
    tie = TieBreak.DIAG_UP_LEFT if tie is None else TieBreak(tie)
    local = algorithm == Algorithm.SMITH_WATERMAN
    reads = np.ascontiguousarray(reads, np.uint8)
    refs = np.ascontiguousarray(refs, np.uint8)
    b, m = reads.shape
    n = refs.shape[1]
    if b == 0:
        return []
    if m == 0 or n == 0:
        return [tb.decode_one(np.zeros((1, 1), np.uint8), reads[i], refs[i], -1, -1,
                              params, algorithm, 0) for i in range(b)]
    band = min(band, n)
    offsets = band_offsets(m, m, n, band)
    nw = -(-band // BAND_PACK)
    mrp_all = _last_valid_pos(reads, tie, params.matrix)
    max_ref_all = _last_valid_pos(refs, tie, params.matrix)
    on_card = device.type == "cuda"
    if chunk_pairs is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count if on_card else 1
        chunk_pairs = cuda_banded.chunk_pairs_for(
            m, band, sms,
            cuda_banded.WALK_CHUNK_PTR_BYTES if device_walk else cuda_banded.CHUNK_PTR_BYTES)

    def dispatch(k, lo):
        r_np, f_np = reads[lo:lo + chunk_pairs], refs[lo:lo + chunk_pairs]
        mrp = mrp_all[lo:lo + chunk_pairs]
        mrp_dev = torch.from_numpy(mrp).to(device)
        out = cuda_banded.fill(torch.from_numpy(r_np).to(device),
                               torch.from_numpy(f_np).to(device), offsets, mrp_dev, params,
                               algorithm, tie, band)
        if device_walk:
            # The pointer words stay where the fill left them; only the
            # records and start cells come back.
            mxp = torch.from_numpy(max_ref_all[lo:lo + chunk_pairs]).to(device)
            out = cuda_walk.banded_walk(*out, mrp_dev, mxp, offsets, n, band, local,
                                        params.affine)
        if not on_card:
            return lo, r_np, f_np, mrp, out, None
        # Queue the copies back, the large one (records, or pointer words)
        # into this round's page-locked buffer, so that the host replays or
        # decodes the previous round meanwhile.
        big, small = out[0], torch.stack(out[1:]) if device_walk else \
            (out[1] if local else out[2])
        host_big = cuda_banded.PINNED.take(k % 2, tuple(big.shape))
        host_big.copy_(big, non_blocking=True)
        host_small = torch.empty(small.shape, dtype=small.dtype, pin_memory=True)
        host_small.copy_(small, non_blocking=True)
        if device_walk:
            out = (host_big, *host_small)
        else:
            out = (host_big, host_small, None) if local else (host_big, None, host_small)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        return lo, r_np, f_np, mrp, out, done

    def decode(entry):
        lo, r_np, f_np, mrp, out, done = entry
        if done is not None:
            done.synchronize()
        if device_walk:
            records, start_r, start_f, scores = (x.numpy() for x in out)
            return walks.replay_batch(records, r_np, f_np, start_r, start_f, scores, params,
                                      algorithm, raw=raw, gapped=gapped)
        ptr, best, keep = out
        if local:
            best = best.numpy()
            start_r, start_f, scores = best[:, 1], best[:, 2], best[:, 0]
        else:
            start_r, start_f, scores = nw_end_cells(
                keep.numpy(), mrp, max_ref_all[lo:lo + len(mrp)], offsets, band, n)
        return decode_banded_native(ptr.numpy(), band, nw * BAND_PACK, offsets, offsets,
                                    r_np, f_np, start_r, start_f, params, algorithm,
                                    scores, raw=raw, gapped=gapped)

    results = []
    pending = None
    for k, lo in enumerate(range(0, b, chunk_pairs)):
        entry = dispatch(k, lo)
        if pending is not None:
            results.append(decode(pending))
        pending = entry
    results.append(decode(pending))
    if raw:
        return AlignmentBatch.concat(results)
    return [a for chunk in results for a in chunk]
