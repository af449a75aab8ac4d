"""One-vs-many scoring through ``csrc/search.cu`` — the counterpart of
``versalignlib_tpu/ops/pallas_search.py`` (``cross_scores_device``,
``search_vmem_plan``) and of ``versalignlib_tpu/ops/pssm.py``'s
``pssm_scores_device``.

The kernel scores K queries against a pool of R sequences without a cross
product of pair codes in device memory: 16 lanes per pair, the DP rows in
registers. Scoring reaches it as the default DNA scores in byte tables
(:func:`dna_byte_tables`), as an S x S matrix (:func:`kernel_table`: the
parameters' matrix, or the DNA scores' 6 x 6 matrix where they do not fit
a byte) looked up by both codes, or as PSSMs as they are.

A tensor on the CPU goes to the plain version (:func:`plain.cross_scores`,
:func:`plain.profile_scores`); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from versalignlib_tpu_torch.alphabet import base_score_matrix
from versalignlib_tpu_torch.ops import plain
from versalignlib_tpu_torch.ops._build import CudaKernel
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm
from versalignlib_tpu_torch.utils.profiling import count

_P, _I = ctypes.c_void_p, ctypes.c_int

#: The one-vs-many kernel; ``SEARCH_KERNEL.launches`` counts its launches.
SEARCH_KERNEL = CudaKernel(
    "search.cu", "val_search_launch", [_P] * 8 + [_I] * 15 + [_P])

#: The kernel's geometry (csrc/search.cu): lanes per pair, pairs per block
#: of 128 threads, the ref columns a lane may own (a stripe is LANES times
#: that), and the shared memory a block may hold.
LANES, PAIRS_PER_BLOCK, COLS_CHOICES = 16, 8, (32, 40)
SMEM_BYTES = (227 << 10) - 64
#: The queries of one launch round (the grid's y limit).
MAX_GRID_Y = 65535


def search_cols(m: int, n: int) -> int:
    """The ref columns per lane for pairs of m x n: the choice of
    COLS_CHOICES with the fewest lane-column slots per pair, stripes times
    (m + busy lanes - 1) steps of ``cols`` cells (the smaller on a tie)."""
    def slots(cols: int) -> int:
        full, rest = divmod(n, LANES * cols)
        steps = full * (m + LANES - 1) + (m + -(-rest // cols) - 1 if rest else 0)
        return steps * cols

    return min(COLS_CHOICES, key=lambda c: (slots(c), c))


def edge_in_shared(m: int, n: int, affine: bool) -> bool:
    """Whether a block's boundary columns (m int32 a pair, 2m affine) fit
    shared memory beside the query's codes (at most max(m, n) bytes)."""
    return 4 * PAIRS_PER_BLOCK * m * (2 if affine else 1) + max(m, n) <= SMEM_BYTES


def search_mem_plan(n: int, pairs: int, affine: bool, m: int) -> int:
    """Device bytes that one launch of ``pairs`` (query, pool sequence)
    pairs of m x n allocates: three (pairs,) int32 outputs (score, end_row,
    end_col), and, where n spans more than one stripe and a block's
    boundary columns do not fit shared memory (:func:`edge_in_shared`), m
    int32 (2m affine) a pair of boundary column in device memory. No DP
    row leaves the registers."""
    stripes = -(-n // (LANES * search_cols(m, n)))
    edge = 0 if stripes < 2 or edge_in_shared(m, n, affine) else 4 * m * (2 if affine else 1)
    return pairs * (12 + edge)


def dna_fits_bytes(params: AlignmentParameters) -> bool:
    """Whether default DNA scores fit the kernel's signed byte tables."""
    return params.matrix is None and all(
        -128 <= v <= 127 for v in (params.score_match, params.score_mismatch))


def dna_byte_table_words(match: int, mismatch: int) -> np.ndarray:
    """(8, 2) int32: read code c's scores against ref codes 0..7 as 8
    bytes, word 0 bytes 0-3 (ref codes 0-3) and word 1 byte 0 (ref code 4);
    A/C/G/T are 1..4, every other code and every byte past 4 scores 0. A
    cell reads byte f of its row's table (f the ref code, 0 past 1..4),
    sign-extended by one prmt."""
    out = np.zeros((8, 2), dtype=np.uint32)
    mm, mt = mismatch & 0xFF, match & 0xFF
    for code in range(1, 5):
        scores = [0] + [mt if f == code else mm for f in range(1, 5)]
        out[code, 0] = sum(v << (8 * f) for f, v in enumerate(scores[:4]))
        out[code, 1] = scores[4]
    return out.view(np.int32)


@functools.lru_cache(maxsize=None)
def dna_byte_tables(params: AlignmentParameters, device: torch.device) -> torch.Tensor:
    """:func:`dna_byte_table_words` of the parameters, on ``device``."""
    words = dna_byte_table_words(params.score_match, params.score_mismatch)
    if device.type == "cuda":
        count("h2d_bytes", words.nbytes)
    return torch.from_numpy(words).to(device)


@functools.lru_cache(maxsize=None)
def kernel_table(params: AlignmentParameters, device: torch.device) -> torch.Tensor:
    """The (S, S) int32 substitution table [read code][ref code] on
    ``device``: the reference's 6 x 6 DNA table, or ``params.matrix``. A
    code outside [0, S) reads as code 0."""
    table = (base_score_matrix(params.score_match, params.score_mismatch)
             if params.matrix is None else params.matrix)
    table = torch.tensor(table, dtype=torch.int32)
    if device.type == "cuda":
        count("h2d_bytes", table.nbytes)
    return table.to(device)


def _check_pool(pool: torch.Tensor) -> None:
    if pool.dim() != 2 or pool.dtype != torch.uint8:
        raise ValueError(f"expected (R, n) uint8 codes, got {tuple(pool.shape)} {pool.dtype}")
    if pool.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {pool.device}")


def _launch(pool: torch.Tensor, query: torch.Tensor | None, table: torch.Tensor | None,
            k: int, m: int, n: int, query_is_read: bool, params: AlignmentParameters,
            local: bool, coords: bool):
    """Allocate the outputs (and, where they do not fit shared memory, the
    boundary columns) of one launch and launch the kernel: K queries (rows
    of ``query`` codes, or of ``table`` when it is a (K, m, S) PSSM)
    against the R rows of ``pool``, pair-major. A 2-D ``table`` is the
    S x S matrix; None scores default DNA through byte tables. Returns
    (scores, end_row, end_col), each (K, R) int32, the last two None without
    ``coords``."""
    r = pool.shape[0]
    dev = pool.device
    pool = pool.contiguous()
    pssm = query is None
    tables = None
    if table is None:
        tables = dna_byte_tables(params, dev)
        s = 6
    else:
        table = table.to(torch.int32).contiguous()
        s = table.shape[-1]
    cols = search_cols(m, n)
    if coords:
        # A key is value << 6 | column (csrc/search.cu): the best score must
        # stay below 2**25. A path has at most m + n steps.
        step = max(int(table.max().item()) if table is not None else params.score_match,
                   params.score_gap_read, params.score_gap_ref,
                   params.score_gap_read + params.gap_open_read,
                   params.score_gap_ref + params.gap_open_ref, 0)
        if (m + n) * step >= 1 << 25:
            raise ValueError("scores too large for the kernel's argmax keys")
    stripes = -(-n // (LANES * cols))
    edge = None
    if stripes > 1 and not edge_in_shared(m, n, params.affine):
        rows = min(k, MAX_GRID_Y) * -(-r // PAIRS_PER_BLOCK) * PAIRS_PER_BLOCK
        edge = torch.empty((rows, m, 2 if params.affine else 1), dtype=torch.int32, device=dev)
    out = torch.empty((k, r), dtype=torch.int32, device=dev)
    end_row = torch.empty((k, r), dtype=torch.int32, device=dev) if coords else None
    end_col = torch.empty((k, r), dtype=torch.int32, device=dev) if coords else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    SEARCH_KERNEL.launch(
        pool.data_ptr(), ptr(query), ptr(table), ptr(tables), ptr(edge),
        out.data_ptr(), ptr(end_row), ptr(end_col),
        k, r, m, n, s, int(query_is_read), int(pssm), params.score_gap_read,
        params.score_gap_ref, params.gap_open_read, params.gap_open_ref,
        int(local), int(params.affine), int(coords), cols,
        torch.cuda.current_stream(dev).cuda_stream)
    return out, end_row, end_col


def cross_scores_device(reads: torch.Tensor, refs: torch.Tensor,
                        params: AlignmentParameters,
                        algorithm: Algorithm) -> torch.Tensor:
    """(B, m) x (R, n) uint8 codes -> (B, R) int32 scores on their device.

    The larger side is the pool, 16 lanes per pool sequence, and the
    smaller side the queries (``query_is_read = R >= B``, as
    pallas_search.py:370 chooses). The same scores as the pairwise kernel on
    the cross product.
    """
    _check_pool(reads)
    _check_pool(refs)
    if reads.device != refs.device:
        raise ValueError(f"reads on {reads.device}, refs on {refs.device}")
    b, m = reads.shape
    r, n = refs.shape
    if b == 0 or r == 0 or m == 0 or n == 0:
        return torch.zeros((b, r), dtype=torch.int32, device=reads.device)
    if reads.device.type == "cpu":
        return plain.cross_scores(reads, refs, params, algorithm)
    local = Algorithm(algorithm) == Algorithm.SMITH_WATERMAN
    table = None if dna_fits_bytes(params) else kernel_table(params, reads.device)
    if r >= b:                                   # the reads are the queries
        out, _, _ = _launch(refs, reads.contiguous(), table, b, m, n, True, params,
                            local, False)
        return out
    out, _, _ = _launch(reads, refs.contiguous(), table, r, m, n, False, params, local,
                        False)
    return out.t().contiguous()


def pssm_scores_device(table: torch.Tensor, pool: torch.Tensor,
                       params: AlignmentParameters, algorithm: Algorithm,
                       with_coords: bool = False):
    """An (m, S) or (K, m, S) int32 profile table against (R, n) uint8 pool
    codes -> (R,) or (K, R) int32 scores, on their device; a code outside
    [0, S) scores 0 (column 0 of a valid PSSM is 0). A profile is always the
    read side.

    ``with_coords`` (SW only): returns (scores, end_rows, end_cols), the
    argmax DP cell of each (profile, entry) pair by the row-major strict
    first-win rule: 0-based profile position and pool column of the hit's
    last aligned pair, (0, 0) where the best score is 0.
    """
    _check_pool(pool)
    if table.dim() not in (2, 3) or table.shape[-1] < 1:
        raise ValueError(f"expected an (m, S) or (K, m, S) table, got {tuple(table.shape)}")
    if table.device != pool.device:
        raise ValueError(f"table on {table.device}, pool on {pool.device}")
    local = Algorithm(algorithm) == Algorithm.SMITH_WATERMAN
    if with_coords and not local:
        raise ValueError("profile coordinates are SW-only (NW end cells are "
                         "not a single argmax)")
    if table.numel() and bool((table[..., 0] != 0).any()):
        # The kernel reads a code past S as code 0 (ops/pssm.validate_pssm).
        raise ValueError("profile column 0 must be zero (code 0 is padding)")
    if pool.device.type == "cpu":
        return plain.profile_scores(table, pool, params, algorithm, with_coords)
    multi = table.dim() == 3
    prof = table if multi else table[None]
    k, m = prof.shape[0], prof.shape[1]
    r, n = pool.shape
    if r == 0 or m == 0 or n == 0:
        outs = [torch.zeros((k, r), dtype=torch.int32, device=pool.device)] * 3
    else:
        outs = _launch(pool, None, prof, k, m, n, True, params, local, with_coords)
    outs = [o if multi or o is None else o[0] for o in outs]
    return tuple(outs) if with_coords else outs[0]
