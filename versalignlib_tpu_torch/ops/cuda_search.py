"""One-vs-many scoring through ``csrc/search.cu`` — the counterpart of
``versalignlib_tpu/ops/pallas_search.py`` (``cross_scores_device``,
``search_vmem_plan``) and of ``versalignlib_tpu/ops/pssm.py``'s
``pssm_scores_device``.

The kernel scores K queries against a pool of R sequences without a cross
product of pair codes in device memory. Every kind of scoring reaches it as
a query profile, one (Lq, S) int32 table per query (:func:`query_profile`):
the default DNA table or an S x S matrix looked up by the query's codes, or
a PSSM as it is.

A tensor on the CPU goes to the plain version (:func:`plain.cross_scores`,
:func:`plain.profile_scores`); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from versalignlib_tpu_torch.alphabet import base_score_matrix
from versalignlib_tpu_torch.ops import plain
from versalignlib_tpu_torch.ops._build import CudaKernel
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm

_P, _I = ctypes.c_void_p, ctypes.c_int

#: The one-vs-many kernel; ``SEARCH_KERNEL.launches`` counts its launches.
SEARCH_KERNEL = CudaKernel(
    "search.cu", "val_search_launch", [_P] * 7 + [_I] * 13 + [_P])


def search_mem_plan(n: int, pairs: int, affine: bool = False) -> int:
    """Device bytes of the kernel's own scratch and outputs for one launch
    of ``pairs`` (query, pool sequence) pairs with n ref columns: the (n,
    pairs) int32 H row (and F row when affine) and three (pairs,) int32
    outputs (score, end_row, end_col). The read length costs no scratch:
    read rows sweep through registers."""
    return pairs * (4 * n * (2 if affine else 1) + 12)


@functools.lru_cache(maxsize=None)
def _sub_table(params: AlignmentParameters, device: torch.device) -> torch.Tensor:
    """The (S, S) int32 substitution table [read code][ref code] on
    ``device``: the reference's 6 x 6 DNA table, or ``params.matrix``."""
    table = (base_score_matrix(params.score_match, params.score_mismatch)
             if params.matrix is None else params.matrix)
    return torch.tensor(table, dtype=torch.int32).to(device)


def query_profile(query: torch.Tensor, params: AlignmentParameters,
                  query_is_read: bool) -> torch.Tensor:
    """(K, Lq) query codes -> (K, Lq, S) int32 query profiles, on the codes'
    device: ``prof[k, q, c]`` is the substitution score of query position q
    against pool code c, read against ref when ``query_is_read``, else ref
    against read. Codes outside [0, S) on either side read as code 0, whose
    row and column are 0."""
    table = _sub_table(params, query.device)
    s = table.shape[0]
    codes = query.to(torch.int64)
    codes = torch.where(codes < s, codes, 0)
    return (table if query_is_read else table.t())[codes].contiguous()


def _check_pool(pool: torch.Tensor) -> None:
    if pool.dim() != 2 or pool.dtype != torch.uint8:
        raise ValueError(f"expected (R, n) uint8 codes, got {tuple(pool.shape)} {pool.dtype}")
    if pool.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {pool.device}")


def _launch(pool: torch.Tensor, prof: torch.Tensor, m: int, n: int,
            query_is_read: bool, params: AlignmentParameters, local: bool,
            coords: bool):
    """Allocate the outputs and scratch of one launch and launch the kernel:
    K = prof.shape[0] queries against the R rows of ``pool``. Returns
    (scores, end_row, end_col), each (K, R) int32, the last two None without
    ``coords``."""
    k, s = prof.shape[0], prof.shape[2]
    r = pool.shape[0]
    dev = pool.device
    pool_t = pool.t().contiguous()
    prof = prof.to(torch.int32).contiguous()
    pairs = k * r
    h = torch.empty((n, pairs), dtype=torch.int32, device=dev)
    f = torch.empty((n, pairs), dtype=torch.int32, device=dev) if params.affine else None
    out = torch.empty((k, r), dtype=torch.int32, device=dev)
    end_row = torch.empty((k, r), dtype=torch.int32, device=dev) if coords else None
    end_col = torch.empty((k, r), dtype=torch.int32, device=dev) if coords else None
    SEARCH_KERNEL.launch(
        pool_t.data_ptr(), prof.data_ptr(), h.data_ptr(),
        None if f is None else f.data_ptr(), out.data_ptr(),
        None if end_row is None else end_row.data_ptr(),
        None if end_col is None else end_col.data_ptr(),
        k, r, m, n, s, int(query_is_read), params.score_gap_read,
        params.score_gap_ref, params.gap_open_read, params.gap_open_ref,
        int(local), int(params.affine), int(coords),
        torch.cuda.current_stream(dev).cuda_stream)
    return out, end_row, end_col


def cross_scores_device(reads: torch.Tensor, refs: torch.Tensor,
                        params: AlignmentParameters,
                        algorithm: Algorithm) -> torch.Tensor:
    """(B, m) x (R, n) uint8 codes -> (B, R) int32 scores on their device.

    The larger side is the pool, one thread per pool sequence, and the
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
    query_is_read = r >= b
    if query_is_read:
        out, _, _ = _launch(refs, query_profile(reads, params, True), m, n, True,
                            params, local, False)
        return out
    out, _, _ = _launch(reads, query_profile(refs, params, False), m, n, False,
                        params, local, False)
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
        outs = _launch(pool, prof, m, n, True, params, local, with_coords)
    outs = [o if multi or o is None else o[0] for o in outs]
    return tuple(outs) if with_coords else outs[0]
