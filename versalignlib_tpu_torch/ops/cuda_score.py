"""Batched scoring through ``csrc/score.cu`` — the counterpart of
``versalignlib_tpu/ops/pallas_score.py`` (``score_batch_device``,
``PallasScorer``): linear or affine gaps, default DNA scoring or an S x S
matrix.

The kernel runs the one-vs-many kernel's step loop on each pair's own
codes (16 lanes a pair, the DP rows in registers). :func:`launch_plan`
chooses what a launch runs: the ref columns a lane owns
(``cuda_search.search_cols``), where the scoring table lives, the shared
memory of a block, and whether the boundary columns leave it
(:func:`edge_in_shared`); :func:`score_tables` builds the tables.

A tensor on the CPU goes to :func:`plain.score_batch`; a CUDA tensor
launches the kernel or raises. :class:`CudaScorer` feeds the kernel from
numpy codes through a reused page-locked ring, in chunks of whole waves of
the kernel (:func:`chunk_plan`, :func:`wave_pairs`) whose copies overlap the
launches of the chunks before them.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from versalignlib_tpu_torch.io.staging import PinnedBuffers
from versalignlib_tpu_torch.ops import cuda_search, plain
from versalignlib_tpu_torch.ops._build import CudaKernel
from versalignlib_tpu_torch.ops.cuda_search import (LANES, PAIRS_PER_BLOCK, SMEM_BYTES,
                                                    dna_byte_tables, dna_fits_bytes,
                                                    kernel_table)
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm
from versalignlib_tpu_torch.utils.profiling import annotate, count

_P, _I = ctypes.c_void_p, ctypes.c_int

#: The score kernel; ``SCORE_KERNEL.launches`` counts its launches.
SCORE_KERNEL = CudaKernel("score.cu", "val_score_launch", [_P] * 6 + [_I] * 13 + [_P])
#: The blocks of a score launch's instantiation that one SM holds at once.
SCORE_OCCUPANCY = CudaKernel("score.cu", "val_score_occupancy",
                             [_I] * 5 + [ctypes.POINTER(ctypes.c_int)])


def check_codes(reads: torch.Tensor, refs: torch.Tensor) -> None:
    """The kernels take (B, m) and (B, n) uint8 codes on one device."""
    if reads.dim() != 2 or refs.dim() != 2 or reads.shape[0] != refs.shape[0]:
        raise ValueError(f"expected (B, m) and (B, n) codes, got "
                         f"{tuple(reads.shape)} and {tuple(refs.shape)}")
    if reads.dtype != torch.uint8 or refs.dtype != torch.uint8:
        raise TypeError(f"codes must be uint8, got {reads.dtype} and {refs.dtype}")
    if reads.device != refs.device:
        raise ValueError(f"reads on {reads.device}, refs on {refs.device}")
    if reads.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {reads.device}")


def edge_in_shared(m: int, affine: bool) -> bool:
    """Whether a block's boundary columns (m int32 a pair, 2m affine, for
    its 8 pairs) fit shared memory."""
    return 4 * PAIRS_PER_BLOCK * m * (2 if affine else 1) <= SMEM_BYTES


class LaunchPlan(NamedTuple):
    """What one launch of ``csrc/score.cu`` runs (:func:`launch_plan`)."""
    cols: int              #: ref columns a lane owns, 32 or 40
    stripes: int           #: stripes of 16 * cols columns
    sub: int               #: 0 DNA byte tables; S x S table 1 in shared memory, 2 past it
    smem: int              #: dynamic shared memory of a block, bytes
    edge_in_device: bool   #: the boundary columns leave shared memory


def launch_plan(m: int, n: int, affine: bool, table_size: int | None = None) -> LaunchPlan:
    """The score launch for pairs of m x n: ``table_size`` is S of its S x S
    table, None for the DNA byte tables. A block's shared memory holds the
    table (sub 1) while it fits beside the boundary columns, else the table
    is read through the read-only cache (sub 2); the boundary columns (m
    int32 a pair, 2m affine, for 8 pairs) are needed only past one stripe
    and live in device memory where they alone do not fit
    (:func:`edge_in_shared`)."""
    cols = cuda_search.search_cols(m, n)
    stripes = -(-n // (LANES * cols))
    in_device = stripes > 1 and not edge_in_shared(m, affine)
    edge = (4 * PAIRS_PER_BLOCK * m * (2 if affine else 1)
            if stripes > 1 and not in_device else 0)
    if table_size is None:
        return LaunchPlan(cols, stripes, 0, edge, in_device)
    table = 4 * table_size ** 2
    if table + edge <= SMEM_BYTES:
        return LaunchPlan(cols, stripes, 1, table + edge, in_device)
    return LaunchPlan(cols, stripes, 2, edge, in_device)


def score_mem_plan(m: int, n: int, batch: int, affine: bool = False) -> int:
    """Device bytes the score path holds for ``batch`` pairs of m x n: the
    (B, m) and (B, n) codes, the (B,) int32 scores and, where the boundary
    columns leave shared memory (:func:`launch_plan`), m int32 (2m affine)
    a pair of boundary column in device memory for every slot of the
    launch's blocks of 8. No DP row leaves the registers."""
    edge = 0
    if launch_plan(m, n, affine).edge_in_device:
        edge = -(-batch // PAIRS_PER_BLOCK) * PAIRS_PER_BLOCK * 4 * m * (2 if affine else 1)
    return batch * (m + n + 4) + edge


def score_tables(params: AlignmentParameters, device: torch.device):
    """What the kernel scores a cell with, on ``device``: (table, byte
    tables, S). Default DNA scores that fit a signed byte go in the (8, 2)
    int32 byte tables (:func:`cuda_search.dna_fits_bytes`), table None and
    S 6; any other scoring in the (S, S) int32 table
    (:func:`cuda_search.kernel_table`: DNA scores past a byte as their
    6 x 6 matrix), byte tables None."""
    if dna_fits_bytes(params):
        return None, dna_byte_tables(params, device), 6
    table = kernel_table(params, device)
    return table, None, table.shape[0]


def score_batch_device(reads: torch.Tensor, refs: torch.Tensor,
                       params: AlignmentParameters,
                       algorithm: Algorithm,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """Best score per pair: (B, m), (B, n) uint8 codes -> (B,) int32 on the
    same device. An empty read or ref axis gives zeros. On the card the
    kernel writes into ``out`` where it is given, a (B,) int32 tensor there.

    On the card, 16 lanes score each pair (``csrc/score.cu``) on the codes
    as they are, pair-major. Default DNA scores that fit a signed byte go
    in byte tables, other scoring as an S x S table (:func:`score_tables`)."""
    check_codes(reads, refs)
    b, m = reads.shape
    n = refs.shape[1]
    count("cells.score", b * m * n)
    with annotate("score.launch"):
        if m == 0 or n == 0:
            return torch.zeros(b, dtype=torch.int32, device=reads.device)
        if reads.device.type == "cpu":
            return plain.score_batch(reads, refs, params, algorithm)
        if b == 0:
            return torch.zeros(0, dtype=torch.int32, device=reads.device)
        dev = reads.device
        reads = reads.contiguous()
        refs = refs.contiguous()
        table, tables, s = score_tables(params, dev)
        plan = launch_plan(m, n, params.affine, None if table is None else s)
        edge = None
        if plan.edge_in_device:
            slots = -(-b // PAIRS_PER_BLOCK) * PAIRS_PER_BLOCK
            edge = torch.empty((slots, m, 2 if params.affine else 1), dtype=torch.int32,
                               device=dev)
        if out is None:
            out = torch.empty(b, dtype=torch.int32, device=dev)
        elif out.shape != (b,) or out.dtype != torch.int32 or out.device != dev \
                or not out.is_contiguous():
            raise ValueError(f"out must be ({b},) int32 on {dev}, got {tuple(out.shape)} "
                             f"{out.dtype} on {out.device}")

        def ptr(t):
            return None if t is None else t.data_ptr()

        SCORE_KERNEL.launch(
            reads.data_ptr(), refs.data_ptr(), ptr(table), ptr(tables), ptr(edge),
            out.data_ptr(), b, m, n, s, params.score_gap_read, params.score_gap_ref,
            params.gap_open_read, params.gap_open_ref,
            int(Algorithm(algorithm) == Algorithm.SMITH_WATERMAN), int(params.affine),
            plan.cols, plan.sub, plan.smem, torch.cuda.current_stream(dev).cuda_stream)
        return out


def wave_pairs(m: int, n: int, params: AlignmentParameters, algorithm: Algorithm,
               device: torch.device) -> int:
    """The pairs of m x n that one launch of ``csrc/score.cu`` under
    ``params`` and ``algorithm`` keeps resident on every SM of ``device``
    at once: 8 pairs a block, times the blocks an SM holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` for the launch's
    instantiation and shared memory, :func:`launch_plan`), times the SMs."""
    table, _, s = score_tables(params, device)
    plan = launch_plan(m, n, params.affine, None if table is None else s)
    local = Algorithm(algorithm) == Algorithm.SMITH_WATERMAN
    return PAIRS_PER_BLOCK * _resident_blocks(device, local, params.affine, plan.cols,
                                              plan.sub, plan.smem)


@functools.lru_cache(maxsize=None)
def _resident_blocks(device: torch.device, local: bool, affine: bool, cols: int, sub: int,
                     smem: int) -> int:
    """Blocks of the instantiation resident on the whole card at once."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        SCORE_OCCUPANCY.call(int(local), int(affine), cols, sub, smem, ctypes.byref(blocks))
    return max(1, blocks.value) * torch.cuda.get_device_properties(device).multi_processor_count


def chunk_plan(b: int, wave: int) -> list[tuple[int, int]]:
    """The row ranges [lo, hi) in which :class:`CudaScorer` copies and
    scores a batch of ``b`` pairs, in order: one a wave of ``wave`` pairs
    (:func:`wave_pairs`), the last a wave and the rest, whose blocks run in
    that wave's tail as they would in one launch of the whole batch (a
    launch of the rest alone left most SMs idle: B1 took 7-10% longer). A
    batch below two waves is one range, so no range holds 2 * wave pairs
    or more, whatever ``b``."""
    if b == 0:
        return []
    edges = [c * wave for c in range(max(1, b // wave))] + [b]
    return list(zip(edges[:-1], edges[1:]))


#: Slots of :class:`CudaScorer`'s page-locked ring: the host fills one while
#: the other's chunk crosses to the card.
RING_SLOTS = 2


class CudaScorer:
    """Host wrapper: numpy codes in, numpy scores out, computed on
    ``device``.

    On a card a call runs in the chunks of :func:`chunk_plan`. For each, the
    host copies the chunk's read and ref codes (on torch's intra-op
    threads) into a slot of a page-locked ring that the scorer keeps across
    calls, waiting first for that slot's last copy to the card; the slot
    goes to the card on a side stream, and the caller's current stream
    waits for it and launches the kernel on the chunk's rows, so chunk
    c + 1 crosses while chunk c is scored. One copy of the scores into a
    kept page-locked buffer ends the call, which returns them as a new
    array. A lock makes each call whole: threads that share a scorer never
    share a slot. On the CPU the codes go to :func:`score_batch_device` as
    they are."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._lock = threading.Lock()
        # The ring's slots, then the scores' buffer.
        self._pinned = PinnedBuffers(RING_SLOTS + 1)
        self._side: torch.cuda.Stream | None = None
        self._copied: list[torch.cuda.Event] = []

    def __call__(self, reads: np.ndarray, refs: np.ndarray,
                 params: AlignmentParameters, algorithm: Algorithm) -> np.ndarray:
        reads = np.ascontiguousarray(reads, np.uint8)
        refs = np.ascontiguousarray(refs, np.uint8)
        if self.device.type == "cuda":
            with self._lock:
                return self._score_on_card(reads, refs, params, Algorithm(algorithm))
        with annotate("score.h2d"):
            reads_dev = torch.from_numpy(reads).to(self.device)
            refs_dev = torch.from_numpy(refs).to(self.device)
        out = score_batch_device(reads_dev, refs_dev, params, Algorithm(algorithm))
        with annotate("score.d2h"):
            return out.cpu().numpy()

    def _score_on_card(self, reads: np.ndarray, refs: np.ndarray,
                       params: AlignmentParameters, algorithm: Algorithm) -> np.ndarray:
        src_reads, src_refs = torch.from_numpy(reads), torch.from_numpy(refs)
        check_codes(src_reads, src_refs)
        (b, m), n = reads.shape, refs.shape[1]
        if b == 0 or m == 0 or n == 0:
            return np.zeros(b, np.int32)
        dev = self.device
        if self._side is None:
            self._side = torch.cuda.Stream(dev)
            self._copied = [torch.cuda.Event() for _ in range(RING_SLOTS)]
        chunks = chunk_plan(b, wave_pairs(m, n, params, algorithm, dev))
        count("score.chunks", len(chunks))
        compute, side = torch.cuda.current_stream(dev), self._side
        # Chunk c's codes are bytes lo * (m + n) to hi * (m + n): its reads, then its refs.
        codes = torch.empty(b * (m + n), dtype=torch.uint8, device=dev)
        out = torch.empty(b, dtype=torch.int32, device=dev)
        codes.record_stream(side)
        side.wait_stream(compute)       # what the compute stream did with the memory first
        for c, (lo, hi) in enumerate(chunks):
            slot, rows = c % RING_SLOTS, hi - lo
            with annotate("score.h2d"):
                self._copied[slot].synchronize()
                host = self._pinned.take(slot, (rows * (m + n),), torch.uint8)
                host[:rows * m].view(rows, m).copy_(src_reads[lo:hi])
                host[rows * m:].view(rows, n).copy_(src_refs[lo:hi])
                chunk = codes[lo * (m + n):hi * (m + n)]
                with torch.cuda.stream(side):
                    chunk.copy_(host, non_blocking=True)
                    self._copied[slot].record(side)
                count("h2d_bytes", host.numel())
            compute.wait_event(self._copied[slot])
            score_batch_device(chunk[:rows * m].view(rows, m), chunk[rows * m:].view(rows, n),
                               params, algorithm, out=out[lo:hi])
        with annotate("score.d2h"):
            scores = self._pinned.take(RING_SLOTS, (b,), torch.int32)
            scores.copy_(out, non_blocking=True)
            compute.synchronize()
            return scores.numpy().copy()
