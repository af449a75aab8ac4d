"""Debug introspection: full DP matrix dumps (the port's counterpart of
``versalignlib_tpu/debug.py``).

The reference's only deep-debug tool is Debug-build logging that prints full
score/pointer matrices and backtrack steps (``#ifndef NDEBUG`` blocks, e.g.
DefaultKernel.cpp:95-135, SSEKernel.cpp:745-765). Here the same
introspection is an API over the numpy oracles (``ops/oracle.py``,
``ops/gotoh.py``): exact H / E / F / pointer matrices for any pair, and a
pretty-printer. They run on the host, for semantics, not speed.
"""

from __future__ import annotations

import numpy as np

from versalignlib_tpu_torch.alphabet import is_valid_base, substitution_scores
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm, TieBreak

_PTR_CHARS = {0: ".", 1: "^", 2: "<", 3: "\\"}


def dump_matrices(
    read: np.ndarray,
    ref: np.ndarray,
    params: AlignmentParameters,
    algorithm: Algorithm,
    tie: TieBreak = TieBreak.DIAG_UP_LEFT,
    variant: str = "traceback",
):
    """(H, ptr) matrices, shape (m+1, n+1), exactly as the kernels compute.

    ``variant``: "traceback" uses the align path's boundary conditions (NW
    column-0 penalty); "score" the score-only boundaries (the NW
    score/traceback asymmetry). Affine parameters return (H, E, F, ptr) with
    the 4-bit affine codes.
    """
    from versalignlib_tpu_torch.ops import gotoh, oracle

    read = np.asarray(read, dtype=np.int32)
    ref = np.asarray(ref, dtype=np.int32)
    local = Algorithm(algorithm) == Algorithm.SMITH_WATERMAN
    col0 = (not local) and variant == "traceback"
    sub = substitution_scores(read[:, None], ref[None, :],
                              params.score_match, params.score_mismatch)

    if params.affine:
        h, e, f = gotoh._fill_affine(read, ref, params, local=local,
                                     col0_penalty=col0)
        ptr = gotoh._affine_pointers(h, e, f, sub, params, local=local)
        return h, e, f, ptr

    h = oracle._fill_matrix(read, ref, params, local=local, col0_penalty=col0)
    valid = is_valid_base(read)[:, None] & is_valid_base(ref)[None, :]
    ptr = oracle._pointers(h, sub, valid, params, local=local, tie=tie)
    return h, ptr


def format_matrix(h: np.ndarray, ptr: np.ndarray | None = None,
                  width: int = 5) -> str:
    """Human-readable rendering (pointer glyphs: \\\\=diag ^=up <=left
    .=start), the equivalent of the reference's per-row matrix_line
    logging."""
    lines = []
    for i in range(h.shape[0]):
        cells = []
        for j in range(h.shape[1]):
            v = int(h[i, j])
            s = str(v) if abs(v) < 10**6 else "-inf"
            if ptr is not None:
                s = _PTR_CHARS.get(int(ptr[i, j]) & 3, "?") + s
            cells.append(s.rjust(width))
        lines.append(" ".join(cells))
    return "\n".join(lines)
