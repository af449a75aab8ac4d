"""The roofline's operations, cells and ceiling, on known shapes."""

import numpy as np
import pytest

from vbench import roofline


def test_operations_per_cell():
    assert roofline.ops_per_cell("score", affine=False) == 10      # 3 + 7
    assert roofline.ops_per_cell("score", affine=True) == 14       # 3 + 11
    assert roofline.ops_per_cell("score", affine=False, matrix=True, local=False) == 6
    assert roofline.ops_per_cell("search", affine=True) == 12      # 1 + 11
    assert roofline.ops_per_cell("search", affine=True, coords=True) == 14
    assert roofline.ops_per_cell("search", affine=False, local=False, coords=True) == 6
    with pytest.raises(ValueError):
        roofline.ops_per_cell("align", affine=False)


def test_cells_leave_out_trailing_padding_only():
    reads = np.array([[1, 2, 0, 0], [5, 0, 3, 0], [0, 0, 0, 0]], np.uint8)
    refs = np.array([[1, 1, 1, 1], [2, 2, 0, 0], [3, 0, 0, 0]], np.uint8)
    assert list(roofline.lengths(reads)) == [2, 3, 0]
    assert roofline.pair_cells(reads, refs) == 2 * 4 + 3 * 2 + 0
    assert roofline.cross_cells(reads, refs) == 5 * 7


def test_ceiling_and_share():
    assert roofline.INT32_OPS_PER_S == pytest.approx(66.9e12, rel=1e-3)
    assert roofline.CELL_OPS_PER_S == pytest.approx(133.8e12, rel=1e-3)
    # 16384 pairs of 320 x 320 at 10 operations: 0.1254 ms at the ceiling.
    ops = 16384 * 320 * 320 * 10
    assert roofline.bound_seconds(ops, 0) == pytest.approx(ops / 133.816e12, rel=1e-4)
    assert roofline.share_pct(ops, 0, 2 * roofline.bound_seconds(ops, 0)) == pytest.approx(50)
    assert roofline.bound_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.share_pct(ops, 0, 0.0) is None and roofline.share_pct(0, 0, 1.0) is None
