"""Banded DP for long pairs (10-100 kbp): the counterpart of
``versalignlib_tpu/ops/banded.py`` (``banded_score_batch``,
``banded_align_batch``).

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

from versalignlib_tpu_torch.dispatch import _resolve_device
from versalignlib_tpu_torch.native import decode_banded_native
from versalignlib_tpu_torch.ops import cuda_banded, cuda_walk
from versalignlib_tpu_torch.ops import traceback as tb
from versalignlib_tpu_torch.ops import walk as walks
from versalignlib_tpu_torch.ops.cuda_align import last_valid_pos as _last_valid_pos
from versalignlib_tpu_torch.ops.plain_banded import BAND_PACK, nw_end_cells
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm, AlignmentBatch, TieBreak


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
