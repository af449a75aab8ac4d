"""The banded kernels' row layout (``csrc/banded.cuh``) through its Python
mirror in ``ops/cuda_banded.py``: every row access of a warp falls in 32
distinct banks of shared memory, stays inside the warp's row and touches a
word of its own; a lane reads the band column it needs; and the plans that
follow from the layout (shared memory, device memory, registers)."""

import re

import pytest

from versalignlib_tpu_torch.ops import _build, cuda_banded
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.alphabet import blosum62

LANES = 32
COLS = range(8, 72, 8)


def _row_values(cols: int) -> dict:
    """A row as the kernels leave it, word -> band column it holds: every
    lane's slots, the repeat of lane + 1's slot 0 in slot cols, band column
    -1 (the boundary) in lane -1's slot cols-1; None (-inf) in lane 32."""
    row = {}
    for lane in range(LANES + 1):
        for slot in range(cols + 1):
            g = lane * cols + slot
            row[cuda_banded.row_word(lane, slot)] = g if lane < LANES and g < LANES * cols \
                else None
    row[cuda_banded.row_word(-1, cols - 1)] = -1
    return row


def test_mirror_is_the_source_layout():
    src = (_build.CSRC / "banded.cuh").read_text()
    assert re.search(r"constexpr int kSlot = (\d+);", src).group(1) == \
        str(cuda_banded.SLOT_WORDS)
    assert re.search(r"constexpr int kChunk = (\d+);", src).group(1) == \
        str(cuda_banded.CHUNK_COLS)
    assert "return slot * kSlot + lane + 1;" in src
    assert "return kSlot * (cols + 1);" in src
    assert "a = word_of(min(lane + q, 32), r);" in src
    assert "b = word_of(min(lane + q + 1, 32), r - cols);" in src
    assert "wrap = s == 0 ? 1 : cols - r + 1;" in src


@pytest.mark.parametrize("cols", COLS)
@pytest.mark.parametrize("s", range(5))
def test_reads_of_the_row_above_hit_32_banks(cols, s):
    row = cuda_banded.SLOT_WORDS * (cols + 1)
    for t in range(cols + 1):
        words = [cuda_banded.read_word(lane, t, s, cols) for lane in range(LANES)]
        assert all(0 <= w < row for w in words)
        assert len(set(words)) == LANES
        assert len({w % 32 for w in words}) == LANES


@pytest.mark.parametrize("cols", COLS)
def test_stores_hit_32_banks_in_neighbouring_words(cols):
    row = cuda_banded.SLOT_WORDS * (cols + 1)
    for j in range(cols + 1):   # slot cols: the repeats of the lanes' slot 0
        words = [cuda_banded.row_word(lane, j) for lane in range(LANES)]
        assert all(0 <= w < row for w in words)
        assert words == list(range(words[0], words[0] + LANES))
        assert len({w % 32 for w in words}) == LANES
    every = {cuda_banded.row_word(lane, j) for lane in range(-1, LANES + 1)
             for j in range(cols + 1)}
    assert every == set(range(row))


@pytest.mark.parametrize("cols", (8, 16, 24, 32, 40))
def test_a_lane_reads_the_column_it_needs(cols):
    row = _row_values(cols)
    # Steps past a lane's columns too (m much shorter than n).
    for s in list(range(2 * cols + 3)) + [5 * cols + 1]:
        for lane in range(LANES):
            for t in range(cols + 1):
                g = lane * cols + s - 1 + t
                want = g if g < LANES * cols else None
                assert row[cuda_banded.read_word(lane, t, s, cols)] == want


@pytest.mark.parametrize("cols", COLS)
def test_steps_0_and_1_read_each_word_from_one_base(cols):
    # A pointer word's 8 reads above (t = 8w+1 .. 8w+8) are one lane's
    # slots, kSlot words apart, so one base pointer serves them.
    for s in (0, 1):
        for lane in range(LANES):
            for w in range(cols // 8):
                words = [cuda_banded.read_word(lane, t, s, cols)
                         for t in range(8 * w + 1, 8 * w + 9)]
                assert words == [words[0] + cuda_banded.SLOT_WORDS * k for k in range(8)]


def test_plans_at_the_layout_boundaries():
    dna, aff = AlignmentParameters(), AlignmentParameters(gap_open_read=-6, gap_open_ref=-6)
    blosum = AlignmentParameters(score_gap_read=-11, score_gap_ref=-11, matrix=blosum62())
    # Four warps' rows of 34 words a slot and cols + 1 slots: 1088 bytes a
    # slot with linear gaps, 2176 affine; the DNA table (10 KB) or the
    # matrix in front; 232448 bytes a block.
    assert cuda_banded.DNA_TABLE_BYTES == 10240
    assert cuda_banded.lane_cols(6400) == 200 and cuda_banded.lane_cols(6401) == 208
    assert cuda_banded.rows_in_shared(6400, dna) and not cuda_banded.rows_in_shared(6401, dna)
    assert cuda_banded.rows_in_shared(3072, aff) and not cuda_banded.rows_in_shared(3073, aff)
    table = (4 * blosum.sub_size ** 2 + blosum.sub_size + 15) // 16 * 16
    last = max(b for b in range(8, 7000, 8)
               if table + 1088 * (cuda_banded.lane_cols(b) + 1) <= cuda_banded.SHARED_LIMIT)
    assert cuda_banded.rows_in_shared(last, blosum)
    assert not cuda_banded.rows_in_shared(last + 1, blosum)
    assert cuda_banded.shared_bytes(512, dna) == 1088 * 17 + 10240
    assert cuda_banded.shared_bytes(512, aff) == 2176 * 17 + 10240
    assert cuda_banded.shared_bytes(512, blosum) == 1088 * 17 + table
    assert cuda_banded.shared_bytes(6401, dna) == 10240
    # T in registers up to 32 columns a lane.
    assert cuda_banded.t_in_registers(1024) and not cuda_banded.t_in_registers(1025)
    assert cuda_banded.t_in_registers(512) and cuda_banded.t_in_registers(8)
    # Device memory: codes, the padded refs, rows past shared memory.
    assert cuda_banded.banded_mem_plan(100, 7000, 6401, 10, dna, "score") == \
        10 * (100 + 2 * 7000 + 4 * 2 * 34 * 209 + 4) + 400 + cuda_banded.REF_PAD
    assert cuda_banded.banded_mem_plan(100, 7000, 6400, 10, dna, "score") == \
        10 * (100 + 2 * 7000 + 4) + 400 + cuda_banded.REF_PAD
