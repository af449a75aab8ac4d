"""Operations, bytes and ceilings of the kernels' rooflines.

A cell's operations are those of the cell function, counted as
``chip_smoke.py`` counts each branch (its ``ops_per_cell`` and ``bound``):
the substitution (a compare, a select and a mask for the default DNA table,
one index add for a matrix or a query profile) plus the recurrence (linear
gaps: diag + s, two gap adds, two maxes, and SW's zero clamp and running
best; affine gaps four more). The one-vs-many kernel counts every scoring as
one lookup, and two more where the entry asks for coordinates.

Cells are counted over what the inputs need: for each pair the read's
length times the ref's, trailing padding (code 0) excluded. Padding is an
invalid base that scores 0, so a kernel that proves its answers unchanged
may skip it, and the count stays the same whichever kernel computes it.

The ceiling is packed 16-bit cells: two a 32-bit lane, 2 x 66.9 T = 133.8 T
cell-operations/s on an H100 SXM (2 operations x 128 lanes x 132 SMs x
1.98 GHz is the published 67 TFLOP/s non-tensor rate, at a power limit of
700 W). The semantics allow 16-bit cells wherever overflow is proven, so no
faithful kernel can read above 100% of this bound.
"""

from __future__ import annotations

import numpy as np

from vbench.gen import lengths

#: int32 operations an H100 SXM issues a second: 2 x 128 lanes x 132 SMs x 1.98 GHz.
INT32_OPS_PER_S = 2 * 128 * 132 * 1.98e9
#: Cell operations a second with two 16-bit cells packed in each lane.
CELL_OPS_PER_S = 2 * INT32_OPS_PER_S
#: HBM3 bandwidth of an H100 SXM (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12

#: Operations of the recurrence, (SW, NW).
RECURRENCE_OPS = {"linear": (7, 5), "affine": (11, 9)}
#: Operations of the substitution.
SUBSTITUTION_OPS = {"dna": 3, "matrix": 1, "profile": 1}
#: What coordinates add to the one-vs-many kernel's SW cell.
SEARCH_COORDS_OPS = 2


def ops_per_cell(kind: str, affine: bool, matrix: bool = False, local: bool = True,
                 coords: bool = False) -> int:
    """Operations of one cell of ``kind``: "score" (B1) or "search" (B4)."""
    if kind not in ("score", "search"):
        raise ValueError(f"no operation count for kernel kind {kind!r}")
    sw, nw = RECURRENCE_OPS["affine" if affine else "linear"]
    if kind == "search":
        sub = SUBSTITUTION_OPS["profile"]
        extra = SEARCH_COORDS_OPS if coords and local else 0
    else:
        sub = SUBSTITUTION_OPS["matrix" if matrix else "dna"]
        extra = 0
    return sub + (sw if local else nw) + extra


def pair_cells(reads: np.ndarray, refs: np.ndarray) -> int:
    """Cells that (read, ref) row pairs need."""
    return int((lengths(reads) * lengths(refs)).sum())


def cross_cells(queries: np.ndarray, pool: np.ndarray) -> int:
    """Cells that every query against every pool entry needs."""
    return int(lengths(queries).sum()) * int(lengths(pool).sum())


def bound_seconds(ops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    over :data:`CELL_OPS_PER_S` and the bytes over :data:`HBM_BYTES_PER_S`."""
    return max(ops / CELL_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def share_pct(ops: float, nbytes: float, seconds: float) -> float | None:
    """The bound's share of ``seconds`` in percent; None where nothing ran."""
    if seconds <= 0 or ops <= 0:
        return None
    return 100.0 * bound_seconds(ops, nbytes) / seconds
