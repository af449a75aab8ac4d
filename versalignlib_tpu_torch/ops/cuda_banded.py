"""The banded kernels ``csrc/banded_score.cu`` and ``csrc/banded_align.cu``
and their device-memory plan — the counterparts of
``_banded_score_blocks`` and ``_banded_align_blocks`` in
``versalignlib_tpu/ops/banded.py``.

:func:`score` and :func:`fill` take (B, m), (B, n) uint8 codes and the (m,)
band starts. A tensor on the CPU goes to the plain version
(``ops/plain_banded.py``); a CUDA tensor launches the kernel or raises. Each
launch is first held to the free device memory by
``capabilities.check_banded_budget``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from versalignlib_tpu_torch.alphabet import valid_code_mask
from versalignlib_tpu_torch.ops import plain_banded
from versalignlib_tpu_torch.ops._build import CudaKernel
from versalignlib_tpu_torch.ops.plain_banded import BAND_PACK
from versalignlib_tpu_torch.ops.cuda_score import check_codes
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm, TieBreak
from versalignlib_tpu_torch.utils.capabilities import check_banded_budget

_P, _I = ctypes.c_void_p, ctypes.c_int

#: The banded score kernel (B5); ``BANDED_SCORE_KERNEL.launches`` counts its
#: launches.
BANDED_SCORE_KERNEL = CudaKernel(
    "banded_score.cu", "val_banded_score_launch", [_P] * 7 + [_I] * 14 + [_P])

#: The banded pointer-fill kernel (B6), with its own launch count.
BANDED_ALIGN_KERNEL = CudaKernel(
    "banded_align.cu", "val_banded_align_launch", [_P] * 10 + [_I] * 15 + [_P])


@functools.lru_cache(maxsize=None)
def matrix_tables(matrix: tuple, device: torch.device):
    """The banded kernels' copy of an S x S ``matrix`` on ``device``: the
    (S, S) int32 table and the (S,) uint8 SSE validity of each code
    (``valid_code_mask``). Kept per (matrix, device), so a launch copies
    nothing to the card."""
    table = torch.tensor(matrix, dtype=torch.int32)
    valid = torch.from_numpy(valid_code_mask(matrix).astype(np.uint8))
    return table.to(device), valid.to(device)


#: Pairs per block (one warp each) and the shared memory a block may take
#: on an H100 (csrc/banded.cuh kWarps; 227 KB).
WARPS_PER_BLOCK = 4
SHARED_LIMIT = 232448
SMEM_TABLE_BYTES = 48 << 10   # csrc/common.cuh kSmemTableBytes
#: The row layout of csrc/banded.cuh: words per slot row (lanes -1 .. 32,
#: kSlot), the columns a lane holds in registers (kChunk), the shared bytes
#: of the DNA table (kDnaWords), and the bytes the kernels may read past a
#: pair's ref (a lane's last pointer word), which the wrapper pads.
SLOT_WORDS = 34
CHUNK_COLS = 32
DNA_TABLE_BYTES = 4 * 2 * 5 * 256
REF_PAD = 16


def lane_cols(band: int) -> int:
    """Band columns per lane: the band over 32 lanes, rounded up to whole
    pointer words of 8 codes."""
    return -(-(-(-band // 32)) // BAND_PACK) * BAND_PACK


def row_word(lane: int, slot: int) -> int:
    """The word of a row that holds lane ``lane``'s column ``slot``, 0 ..
    cols (csrc/banded.cuh word_of): lane -1's slot cols-1 is the boundary,
    lane 32 reads -inf, and slot cols repeats lane + 1's slot 0."""
    return slot * SLOT_WORDS + lane + 1


def read_word(lane: int, t: int, s: int, cols: int) -> int:
    """The word lane ``lane`` reads for P(t), band column lane*cols + s - 1
    + t of the row above, on a row of step ``s`` (csrc/banded.cuh Step)."""
    q, r = divmod(s - 1, cols)
    wrap = 1 if s == 0 else cols - r + 1
    if t < wrap:
        return row_word(min(lane + q, 32), r + t)
    return row_word(min(lane + q + 1, 32), r + t - cols)


def t_in_registers(band: int) -> bool:
    """Whether a lane's columns fit the registers of one pass (cols <=
    CHUNK_COLS, band <= 1024); wider bands compute each chunk's first pass
    again in the second."""
    return lane_cols(band) <= CHUNK_COLS


def _row_words(cols: int, affine: bool) -> int:
    return (4 if affine else 2) * SLOT_WORDS * (cols + 1)


def _table_bytes(params: AlignmentParameters) -> int:
    """Shared bytes in front of the rows (csrc/banded.cuh table_words_of):
    the DNA table, a matrix copied there, or 0 for a matrix read through the
    read-only cache."""
    if params.matrix is None:
        return DNA_TABLE_BYTES
    s = params.sub_size
    return (4 * s * s + s + 15) // 16 * 16 if 4 * s * s + s <= SMEM_TABLE_BYTES else 0


def rows_in_shared(band: int, params: AlignmentParameters) -> bool:
    """Whether a block's rows (and a matrix of up to 48 KB) fit its shared
    memory; wider bands keep their rows in device memory."""
    rows = 4 * WARPS_PER_BLOCK * _row_words(lane_cols(band), params.affine)
    return _table_bytes(params) + rows <= SHARED_LIMIT


def shared_bytes(band: int, params: AlignmentParameters) -> int:
    """Dynamic shared memory of one block of a launch (csrc/banded.cuh
    shared_bytes)."""
    rows = 4 * WARPS_PER_BLOCK * _row_words(lane_cols(band), params.affine)
    return _table_bytes(params) + (rows if rows_in_shared(band, params) else 0)


def banded_mem_plan(m: int, n: int, band: int, batch: int,
                    params: AlignmentParameters, kind: str = "align") -> int:
    """Device bytes one launch of ``batch`` pairs of m x n allocates:
    the codes, the padded copy of the refs, the band starts, the rows when
    they do not fit shared memory, and the outputs: scores (``kind``
    "score"), or the pointer words, SW best, NW keep and mrp ("align"),
    with what the walk that follows adds: its records (4 bytes a row), its
    three start outputs and mxp."""
    rows = 0 if rows_in_shared(band, params) else 4 * _row_words(lane_cols(band),
                                                                 params.affine)
    per_pair = m + 2 * n + rows
    if kind == "score":
        per_pair += 4
    else:
        per_pair += 4 * m * -(-band // BAND_PACK) + 16 + 4 * band + 4 + 4 * m + 16
    return batch * per_pair + 4 * m + REF_PAD


def _common_args(reads, refs, offsets, band, params, dev):
    """Device copies and launch arguments shared by both kernels: the refs
    copied with REF_PAD bytes after them."""
    b, m = reads.shape
    n = refs.shape[1]
    offs = torch.as_tensor(np.asarray(offsets, dtype=np.int32)).to(dev)
    scratch = None
    if not rows_in_shared(band, params):
        scratch = torch.empty((b, _row_words(lane_cols(band), params.affine)),
                              dtype=torch.int32, device=dev)
    table = valid = None
    if params.matrix is not None:
        table, valid = matrix_tables(params.matrix, dev)
    padded = torch.zeros(b * n + REF_PAD, dtype=torch.uint8, device=dev)
    padded[:b * n] = refs.reshape(-1)
    ptrs = (reads.contiguous(), padded, offs, scratch, table, valid)
    ints = (b, m, n, band, lane_cols(band), params.sub_size, params.score_match,
            params.score_mismatch, params.score_gap_read, params.score_gap_ref,
            params.gap_open_read, params.gap_open_ref)
    return ptrs, ints


def _addr(x):
    return None if x is None else x.data_ptr()


def _check(reads, refs, offsets, band):
    check_codes(reads, refs)
    m, n = reads.shape[1], refs.shape[1]
    if m == 0 or not 1 <= band <= n:
        raise ValueError(f"banded kernels need m >= 1 and 1 <= band <= n; got m={m}, "
                         f"n={n}, band={band}")
    if len(offsets) != m:
        raise ValueError(f"{len(offsets)} band starts for {m} rows")


def score(reads: torch.Tensor, refs: torch.Tensor, offsets: np.ndarray,
          params: AlignmentParameters, algorithm: Algorithm, band: int) -> torch.Tensor:
    """Banded best score per pair on the codes' device: (B,) int32 (see
    ``plain_banded.banded_score``)."""
    _check(reads, refs, offsets, band)
    if reads.device.type == "cpu":
        return plain_banded.banded_score(reads, refs, offsets, params, algorithm, band)
    b, m = reads.shape
    check_banded_budget(banded_mem_plan(m, refs.shape[1], band, b, params, "score"),
                        reads.device)
    out = torch.empty(b, dtype=torch.int32, device=reads.device)
    if b == 0:
        return out
    ptrs, ints = _common_args(reads, refs, offsets, band, params, reads.device)
    BANDED_SCORE_KERNEL.launch(
        *map(_addr, ptrs), out.data_ptr(), *ints,
        int(Algorithm(algorithm) == Algorithm.SMITH_WATERMAN), int(params.affine),
        torch.cuda.current_stream(reads.device).cuda_stream)
    return out


def fill(reads: torch.Tensor, refs: torch.Tensor, offsets: np.ndarray,
         mrp: torch.Tensor, params: AlignmentParameters, algorithm: Algorithm,
         tie: TieBreak, band: int):
    """Banded pointer fill on the codes' device: ``(ptr (B, m, ceil(band/8)),
    best (B, 4) or None, keep (B, band) or None)``, all int32 (see
    ``plain_banded.banded_fill``)."""
    _check(reads, refs, offsets, band)
    if mrp.shape != (reads.shape[0],) or mrp.dtype != torch.int32 \
            or mrp.device != reads.device:
        raise ValueError("mrp must be (B,) int32 on the codes' device")
    if reads.device.type == "cpu":
        return plain_banded.banded_fill(reads, refs, offsets, mrp, params, algorithm, tie,
                                        band)
    b, m = reads.shape
    dev = reads.device
    local = Algorithm(algorithm) == Algorithm.SMITH_WATERMAN
    check_banded_budget(banded_mem_plan(m, refs.shape[1], band, b, params), dev)
    ptr = torch.empty((b, m, -(-band // BAND_PACK)), dtype=torch.int32, device=dev)
    best = torch.empty((b, 4), dtype=torch.int32, device=dev) if local else None
    keep = None if local else torch.empty((b, band), dtype=torch.int32, device=dev)
    if b == 0:
        return ptr, best, keep
    ptrs, ints = _common_args(reads, refs, offsets, band, params, dev)
    r, f, offs, scratch, table, valid = ptrs
    BANDED_ALIGN_KERNEL.launch(
        r.data_ptr(), f.data_ptr(), offs.data_ptr(), mrp.contiguous().data_ptr(),
        _addr(scratch), _addr(table), _addr(valid), ptr.data_ptr(), _addr(best),
        _addr(keep), *ints, int(local), int(params.affine),
        int(TieBreak(tie) == TieBreak.DIAG_UP_LEFT),
        torch.cuda.current_stream(dev).cuda_stream)
    return ptr, best, keep


#: Pointer bytes per device round of ``banded_align_batch``, and the most
#: each of the two page-locked host buffers keeps between calls. 2.25 GiB
#: is 589 pairs of 16 kbp at band 512 (4.1 MB each), so that a round there
#: holds a whole wave; longer pairs get fewer per round (94 at 100 kbp),
#: never more bytes.
CHUNK_PTR_BYTES = 9 << 28
#: Pointer bytes per round when the walk runs on the device: the words then
#: never leave it, so a round is held by device memory alone. 16 GiB is
#: 3696 pairs of 16 kbp at band 512 (seven waves) and a wave of 528 at 100
#: kbp (25.6 MB each), where the page-locked cap leaves 94.
WALK_CHUNK_PTR_BYTES = 1 << 34
#: A wave of the fill: one warp per pair and one warp per SM partition. A
#: launch takes the time of one wave up to this many pairs per SM, and one
#: more wave for each part of a wave past it.
WAVE_PAIRS_PER_SM = 4


def chunk_pairs_for(m: int, band: int, sm_count: int,
                    ptr_bytes: int = CHUNK_PTR_BYTES) -> int:
    """Pairs per device round: as many as ``ptr_bytes`` of pointer words
    hold (:data:`CHUNK_PTR_BYTES`, or :data:`WALK_CHUNK_PTR_BYTES` with the
    walk on the device), at least one, and where that is a wave
    (:data:`WAVE_PAIRS_PER_SM` per SM, 528 on an H100) or more, a whole
    number of waves."""
    per_pair = 4 * m * -(-band // BAND_PACK)
    pairs = max(1, ptr_bytes // max(per_pair, 1))
    wave = WAVE_PAIRS_PER_SM * sm_count
    return pairs // wave * wave if pairs >= wave else pairs


class PinnedPair:
    """Two page-locked host buffers that the rounds of a banded alignment
    take in turn: the copy of round k+1 lands in one while the host decodes
    round k from the other. A buffer of up to ``limit`` bytes is kept for
    the next call, since pinning gigabytes takes longer than the copy it
    speeds up; a larger one (a caller's own ``chunk_pairs``) serves its call
    only. :meth:`release` gives the kept buffers back."""

    def __init__(self, limit: int):
        self.limit = limit
        self._bufs: list[torch.Tensor | None] = [None, None]

    def take(self, slot: int, shape: tuple, dtype=torch.int32) -> torch.Tensor:
        nbytes = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        buf = self._bufs[slot]
        if buf is None or buf.numel() < nbytes:
            self._bufs[slot] = None   # free the smaller buffer first
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
            if nbytes <= self.limit:
                self._bufs[slot] = buf
        return buf[:nbytes].view(dtype).view(shape)

    def release(self) -> None:
        self._bufs = [None, None]


#: The pair of page-locked buffers the banded alignment path reuses, each
#: kept up to one round's pointer bytes.
PINNED = PinnedPair(CHUNK_PTR_BYTES)
