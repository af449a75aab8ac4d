"""Batched scoring through ``csrc/score.cu`` — the counterpart of
``versalignlib_tpu/ops/pallas_score.py`` (``score_batch_device``,
``PallasScorer``): linear or affine gaps, default DNA scoring or an S x S
matrix.

A tensor on the CPU goes to :func:`plain.score_batch`; a CUDA tensor
launches the kernel or raises. Nothing else is chosen here.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from versalignlib_tpu_torch.alphabet import valid_code_mask
from versalignlib_tpu_torch.ops import plain
from versalignlib_tpu_torch.ops._build import CudaKernel
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm

_P, _I = ctypes.c_void_p, ctypes.c_int

#: The score kernel; ``SCORE_KERNEL.launches`` counts its launches.
SCORE_KERNEL = CudaKernel(
    "score.cu", "val_score_launch",
    [_P, _P, _P, _P, _P, _P] + [_I] * 12 + [_P])


@functools.lru_cache(maxsize=None)
def matrix_tables(matrix: tuple, shift: int, device: torch.device):
    """The kernels' copy of an S x S ``matrix`` on ``device``: the (S, S)
    int32 table, pre-shifted by ``shift`` bits for the kernels that run in
    the shifted (value << 2) domain, and the (S,) uint8 SSE validity of each
    code (``valid_code_mask``). Kept per (matrix, shift, device), so a launch
    copies nothing to the card."""
    table = torch.tensor(matrix, dtype=torch.int32) << shift
    valid = torch.from_numpy(valid_code_mask(matrix).astype(np.uint8))
    return table.to(device), valid.to(device)


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


def score_mem_plan(m: int, n: int, batch: int, affine: bool = False) -> int:
    """Device bytes the score path allocates for ``batch`` pairs of m x n:
    the codes and their pair-interleaved copies, the (n, B) int32 H row (and
    F row when affine) and the (B,) scores."""
    return batch * (2 * (m + n) + 4 * n * (2 if affine else 1) + 4)


def score_batch_device(reads: torch.Tensor, refs: torch.Tensor,
                       params: AlignmentParameters,
                       algorithm: Algorithm) -> torch.Tensor:
    """Best score per pair: (B, m), (B, n) uint8 codes -> (B,) int32 on the
    same device. An empty read or ref axis gives zeros."""
    check_codes(reads, refs)
    b, m = reads.shape
    n = refs.shape[1]
    if m == 0 or n == 0:
        return torch.zeros(b, dtype=torch.int32, device=reads.device)
    if reads.device.type == "cpu":
        return plain.score_batch(reads, refs, params, algorithm)
    if b == 0:
        return torch.zeros(0, dtype=torch.int32, device=reads.device)
    reads_t = reads.t().contiguous()
    refs_t = refs.t().contiguous()
    h = torch.empty((n, b), dtype=torch.int32, device=reads.device)
    f = torch.empty((n, b), dtype=torch.int32, device=reads.device) if params.affine else None
    table = None
    if params.matrix is not None:
        table, _ = matrix_tables(params.matrix, 0, reads.device)
    out = torch.empty(b, dtype=torch.int32, device=reads.device)
    SCORE_KERNEL.launch(
        reads_t.data_ptr(), refs_t.data_ptr(), h.data_ptr(),
        None if f is None else f.data_ptr(), out.data_ptr(),
        None if table is None else table.data_ptr(),
        b, m, n, params.sub_size, params.score_match, params.score_mismatch,
        params.score_gap_read, params.score_gap_ref,
        params.gap_open_read, params.gap_open_ref,
        int(Algorithm(algorithm) == Algorithm.SMITH_WATERMAN), int(params.affine),
        torch.cuda.current_stream(reads.device).cuda_stream)
    return out


class CudaScorer:
    """Host wrapper: numpy codes in, numpy scores out, computed on
    ``device``."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)

    def __call__(self, reads: np.ndarray, refs: np.ndarray,
                 params: AlignmentParameters, algorithm: Algorithm) -> np.ndarray:
        out = score_batch_device(
            torch.from_numpy(np.ascontiguousarray(reads, np.uint8)).to(self.device),
            torch.from_numpy(np.ascontiguousarray(refs, np.uint8)).to(self.device),
            params, Algorithm(algorithm))
        return out.cpu().numpy()
