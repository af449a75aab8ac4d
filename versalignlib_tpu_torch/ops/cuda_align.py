"""Full alignment through ``csrc/align.cu`` or ``csrc/align_affine.cu`` and
a traceback walk — the counterpart of ``versalignlib_tpu/ops/pallas_align.py``
(``pallas_align_batch``, ``pallas_align_affine_batch`` and their
``_decode_chunk`` / ``_decode_affine_chunk``).

The device fills packed pointer words (2-bit linear codes, 16 per word, or
4-bit Gotoh codes, 8 per word), the aux word and (NW) ``hsel``. With
``device_walk`` the walk runs where the fill ran (``ops/cuda_walk.py``: on
the card ``csrc/walk.cu``), only its row records and start cells come back,
and the host replays them (``walk.replay_batch``); otherwise the pointer
words come back, the host derives each pair's start cell and score and
walks them with the native decoder. Pairs go through in chunks sized by a
budget of device memory, and the fill of chunk k+1 is queued before chunk k
is decoded, so the card works while the host walks.

A tensor on the CPU goes to the plain version (:func:`plain.align_batch`,
:func:`plain.align_affine_batch`); a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from versalignlib_tpu_torch.alphabet import base_score_matrix, make_validity, valid_code_mask
from versalignlib_tpu_torch.native import decode_batch_native
from versalignlib_tpu_torch.ops import cuda_walk, plain
from versalignlib_tpu_torch.ops import traceback as tb
from versalignlib_tpu_torch.ops import walk as walks
from versalignlib_tpu_torch.ops._build import CudaKernel
from versalignlib_tpu_torch.ops.cuda_score import check_codes
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm, AlignmentBatch, TieBreak

_P, _I = ctypes.c_void_p, ctypes.c_int

#: The linear pointer-fill kernel; ``ALIGN_KERNEL.launches`` counts its
#: launches.
ALIGN_KERNEL = CudaKernel(
    "align.cu", "val_align_launch", [_P] * 8 + [_I] * 10 + [_P])

#: The affine (Gotoh) pointer-fill kernel, with its own launch count.
AFFINE_KERNEL = CudaKernel(
    "align_affine.cu", "val_align_affine_launch", [_P] * 8 + [_I] * 12 + [_P])

PACK = plain.PACK
AFFINE_PACK = plain.AFFINE_PACK

#: The fills' launch (``csrc/fill.cuh``): one warp per pair, FILL_WARPS
#: pairs a block, each lane 16 columns of a stripe of STRIPE ref columns.
FILL_WARPS = 4
STRIPE = 512

#: Packed pointer bytes per chunk: 256 MiB is 4096 pairs at 512 x 512 with
#: 2-bit codes.
CHUNK_PTR_BYTES = 256 << 20

#: Warps per SM that a fill launch must reach: four on each of an SM's four
#: schedulers, so that one warp's dependent instructions never leave a
#: scheduler idle.
MIN_WARPS_PER_SM = 16


def edge_words(affine: bool) -> int:
    """int32 values per row of a pair's boundary column between stripes:
    H, and E with affine gaps."""
    return 2 if affine else 1


def align_mem_plan(m: int, n: int, batch: int, affine: bool = False) -> int:
    """Device bytes the fill and the walk allocate for ``batch`` pairs of m
    x n: the codes, mrp, the two boundary columns between stripes (only past
    one stripe of :data:`STRIPE` columns), the packed pointers (16 codes per
    word, 8 when affine), aux and hsel; then the walk's records (4 bytes a
    row) and its three start outputs, and mxp."""
    nc = -(-n // (AFFINE_PACK if affine else PACK))
    edge = 2 * m * edge_words(affine) if n > STRIPE else 0
    fill_bytes = (m + n) + 4 + 4 * edge + 4 * m * nc + 16 + 4 * (n + 1)
    return batch * (fill_bytes + 4 * m + 12 + 4)


def chunk_pairs_for(m: int, n: int, sm_count: int, pack: int = PACK) -> int:
    """Pairs per device round: as many as :data:`CHUNK_PTR_BYTES` of packed
    pointers (``pack`` codes per word) hold, in whole blocks of
    :data:`FILL_WARPS` pairs, but never fewer than
    :data:`MIN_WARPS_PER_SM` warps (pairs) per SM: a smaller launch leaves
    schedulers without a warp to issue from for the same time."""
    per_pair = 4 * m * -(-n // pack)
    return max(MIN_WARPS_PER_SM * sm_count,
               CHUNK_PTR_BYTES // per_pair // FILL_WARPS * FILL_WARPS)


def dna_fits_bytes(params: AlignmentParameters) -> bool:
    """Whether the default DNA scores, shifted << 2 with a priority of up
    to 3, fit the fills' signed byte tables (``csrc/fill.cuh``, ``Sub``);
    larger ones go to the kernel as their 6 x 6 matrix, with the same
    scores and validity."""
    return all(-128 <= 4 * v and 4 * v + 3 <= 127
               for v in (params.score_match, params.score_mismatch))


@functools.lru_cache(maxsize=None)
def fill_table(matrix: tuple, canonical: bool, device: torch.device) -> torch.Tensor:
    """The fills' copy of an S x S ``matrix`` on ``device``: int32, shifted
    << 2, and for the SSE flavor with the DIAG priority added, 3 where both
    codes are valid (``valid_code_mask``), else 0 (``csrc/fill.cuh``,
    ``Sub``). Kept per (matrix, flavor, device)."""
    table = torch.tensor(matrix, dtype=torch.int32) << 2
    if not canonical:
        valid = torch.from_numpy(valid_code_mask(matrix))
        table += 3 * (valid[:, None] & valid[None, :]).to(torch.int32)
    return table.to(device)


def last_valid_pos(codes: np.ndarray, tie: TieBreak, matrix=None) -> np.ndarray:
    """The reference's max_*_pos: the index before the first invalid code,
    else len-1. Canonical flavor: any code but 0 is valid; SSE flavor: only
    the codes with a nonzero score (A/C/G/T, or ``valid_code_mask(matrix)``)
    (pallas_align.py:508-522)."""
    if TieBreak(tie) == TieBreak.DIAG_UP_LEFT:
        invalid = codes == 0
    else:
        invalid = ~make_validity(matrix)(codes)
    any_inv = invalid.any(axis=1)
    return np.where(any_inv, invalid.argmax(axis=1) - 1,
                    codes.shape[1] - 1).astype(np.int32)


def _launch_fill(reads, refs, mrp, params, algorithm, tie):
    """Allocate the outputs and scratch of one fill and launch the kernel of
    the parameters' branch."""
    affine = params.affine
    kernel, pack = (AFFINE_KERNEL, AFFINE_PACK) if affine else (ALIGN_KERNEL, PACK)
    b, m = reads.shape
    n = refs.shape[1]
    local = Algorithm(algorithm) == Algorithm.SMITH_WATERMAN
    dev = reads.device
    ptr = torch.empty((b, m, -(-n // pack)), dtype=torch.int32, device=dev)
    aux = torch.empty((b, 4), dtype=torch.int32, device=dev)
    hsel = None if local else torch.empty((b, n + 1), dtype=torch.int32, device=dev)
    if b == 0:
        return ptr, aux, hsel
    reads = reads.contiguous()
    refs = refs.contiguous()
    mrp = mrp.contiguous()
    edge = (torch.empty((b, 2, m, edge_words(affine)), dtype=torch.int32, device=dev)
            if n > STRIPE else None)
    canonical = TieBreak(tie) == TieBreak.DIAG_UP_LEFT
    matrix, s = params.matrix, params.sub_size
    if matrix is None and not dna_fits_bytes(params):
        matrix = tuple(map(tuple, base_score_matrix(params.score_match,
                                                    params.score_mismatch).tolist()))
    table = None if matrix is None else fill_table(matrix, canonical, dev)
    gaps = [params.score_gap_read, params.score_gap_ref]
    if affine:
        gaps += [params.gap_open_read, params.gap_open_ref]
    kernel.launch(
        reads.data_ptr(), refs.data_ptr(), mrp.data_ptr(),
        None if edge is None else edge.data_ptr(), ptr.data_ptr(), aux.data_ptr(),
        None if hsel is None else hsel.data_ptr(),
        None if table is None else table.data_ptr(),
        b, m, n, s, params.score_match, params.score_mismatch,
        *gaps, int(local), int(canonical),
        torch.cuda.current_stream(dev).cuda_stream)
    return ptr, aux, hsel


def fill(reads: torch.Tensor, refs: torch.Tensor, mrp: torch.Tensor,
         params: AlignmentParameters, algorithm: Algorithm, tie: TieBreak):
    """Pointer fill of (B, m), (B, n) uint8 codes with (B,) int32 mrp, on
    their device: ``(ptr, aux (B, 4), hsel (B, n+1) or None)``, all int32.
    Linear gaps fill ptr (B, m, ceil(n/16)) with 2-bit codes
    (``csrc/align.cu``); affine gaps fill ptr (B, m, ceil(n/8)) with 4-bit
    Gotoh codes (``csrc/align_affine.cu``), as ``pallas_align_batch`` routes
    them. m, n >= 1."""
    check_codes(reads, refs)
    if reads.shape[1] == 0 or refs.shape[1] == 0:
        raise ValueError("the pointer fill needs m >= 1 and n >= 1")
    if mrp.shape != (reads.shape[0],) or mrp.dtype != torch.int32 \
            or mrp.device != reads.device:
        raise ValueError("mrp must be (B,) int32 on the codes' device")
    if reads.device.type == "cpu":
        plain_fill = plain.align_affine_batch if params.affine else plain.align_batch
        return plain_fill(reads, refs, mrp, params, algorithm, tie)
    return _launch_fill(reads, refs, mrp, params, algorithm, tie)


def start_cells(aux: np.ndarray, hsel: np.ndarray | None, mrp: np.ndarray,
                refs: np.ndarray, tie: TieBreak, local: bool, matrix=None):
    """Traceback start cell and score per pair from the fill's outputs.

    SW: the aux word is the folded argmax. NW: the end cell is
    ``(mrp, min(max_ref_pos, aux[0]))`` and its score is read from ``hsel``
    (0 when mrp < 0, where the end cell is on the boundary row)
    (pallas_align.py:651-668, 1180-1192).
    """
    if local:
        return aux[:, 1].copy(), aux[:, 2].copy(), aux[:, 0].copy()
    n = refs.shape[1]
    start_f = np.minimum(last_valid_pos(refs, tie, matrix), aux[:, 0]).astype(np.int32)
    scores = np.where(
        mrp >= 0, hsel[np.arange(len(mrp)), np.clip(start_f, -1, n - 1) + 1], 0
    ).astype(np.int32)
    return mrp, start_f, scores


def align_batch(
    reads: np.ndarray,
    refs: np.ndarray,
    params: AlignmentParameters,
    algorithm: Algorithm,
    tie: TieBreak = TieBreak.DIAG_UP_LEFT,
    device: torch.device | str = "cuda",
    chunk_pairs: int | None = None,
    read_texts: list[str] | None = None,
    ref_texts: list[str] | None = None,
    raw: bool = False,
    device_walk: bool = False,
    gapped: bool = True,
):
    """Full-batch alignment of (B, m), (B, n) uint8 codes: pointer fill on
    ``device``; with ``device_walk`` the traceback walk there too and a
    replay of its records on the host, else the walk on the host (the
    default here, as ``pallas_align_batch`` has it; the backend resolves
    its own default with ``cuda_walk.resolve_device_walk``). Affine
    parameters go through the Gotoh fill and walk, as
    ``pallas_align_batch`` routes them.

    Returns a list of :class:`Alignment`, or with ``raw=True`` an
    :class:`AlignmentBatch` column store; ``gapped=False`` (raw only) leaves
    out the gapped strings.
    """
    algorithm = Algorithm(algorithm)
    tie = TieBreak(tie)
    local = algorithm == Algorithm.SMITH_WATERMAN
    affine = params.affine
    pack = AFFINE_PACK if affine else PACK
    device = torch.device(device)
    b, m = reads.shape
    n = refs.shape[1]
    if m == 0 or n == 0:
        # Degenerate empty sequences: empty alignments (boundary-only walk).
        return [
            tb.decode_one(np.zeros((1, 1), np.uint8), reads[i], refs[i],
                          -1, -1, params, algorithm)
            for i in range(b)
        ]
    if chunk_pairs is None:
        sms = (torch.cuda.get_device_properties(device).multi_processor_count
               if device.type == "cuda" else 1)
        chunk_pairs = chunk_pairs_for(m, n, sms, pack)

    def dispatch(lo):
        r_np = np.ascontiguousarray(reads[lo:lo + chunk_pairs], np.uint8)
        f_np = np.ascontiguousarray(refs[lo:lo + chunk_pairs], np.uint8)
        mrp = last_valid_pos(r_np, tie, params.matrix)
        mrp_dev = torch.from_numpy(mrp).to(device)
        out = fill(torch.from_numpy(r_np).to(device),
                   torch.from_numpy(f_np).to(device), mrp_dev, params, algorithm, tie)
        if device_walk:
            # The walk reads the pointer words where the fill left them; only
            # its records and start cells leave the device.
            mxp = torch.from_numpy(last_valid_pos(f_np, tie, params.matrix)).to(device)
            out = cuda_walk.walk(*out, mrp_dev, mxp, n, local, affine)
        done = None
        if device.type == "cuda":
            # Queue the copies back into page-locked memory, so that the
            # host returns at once and decodes the previous chunk meanwhile.
            out = tuple(None if x is None else
                        torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                        .copy_(x, non_blocking=True) for x in out)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
        return lo, r_np, f_np, mrp, out, done

    def decode(entry):
        lo, r_np, f_np, mrp, out, done = entry
        if done is not None:
            done.synchronize()
        nb = r_np.shape[0]
        texts = (None if read_texts is None else read_texts[lo:lo + nb],
                 None if ref_texts is None else ref_texts[lo:lo + nb])
        if device_walk:
            records, start_r, start_f, scores = (x.numpy() for x in out)
            return walks.replay_batch(records, r_np, f_np, start_r, start_f, scores, params,
                                      algorithm, *texts, raw=raw, gapped=gapped)
        ptr, aux, hsel = out
        start_r, start_f, scores = start_cells(
            aux.numpy(), None if hsel is None else hsel.numpy(), mrp, f_np,
            tie, local, params.matrix)
        return decode_batch_native(
            (ptr.numpy(), pack), r_np, f_np, start_r, start_f, params,
            algorithm, scores, *texts, affine=affine, raw=raw, gapped=gapped)

    results = []
    pending = None
    for lo in range(0, b, chunk_pairs):
        entry = dispatch(lo)
        if pending is not None:
            results.append(decode(pending))
        pending = entry
    if pending is not None:
        results.append(decode(pending))
    if raw:
        return AlignmentBatch.concat(results)
    return [a for chunk in results for a in chunk]
