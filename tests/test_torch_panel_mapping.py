"""``search.map_reads`` on the CPU against two witnesses, field by field
with tolerance 0: the JAX package's ``map_reads`` (``impl="xla"``) and the
benchmark's plain panel reference (``benchmark/vbench/panel.py``), on
seeded 16S-like panels of 6-12 entries of 40-80 bp and reads of 16-24 bp:
linear and BWA-MEM affine scoring, one chunk and three or more, V4 twins
across a chunk boundary, a read whose strands tie, a one-entry panel; and
the counters ``search.chunks`` and ``cells.search``."""

import pathlib
import sys

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from versalignlib_tpu import search as jax_search
from versalignlib_tpu.params import AlignmentParameters as JaxParams
from versalignlib_tpu_torch import search
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.utils import profiling

sys.path.append(str(pathlib.Path(__file__).resolve().parent.parent / "benchmark"))

from vbench import gen, panel, reference  # noqa: E402

SCORING = {
    "linear": {"score_match": 2, "score_mismatch": -1, "score_gap_read": -3,
               "score_gap_ref": -3},
    "bwa_mem": {"score_match": 1, "score_mismatch": -4, "score_gap_read": -1,
                "score_gap_ref": -1, "gap_open_read": -6, "gap_open_ref": -6},
}
FIELDS = ("read", "ref", "score", "cigar", "read_start", "read_end", "ref_start", "ref_end",
          "buffer_start", "buffer_end")
V4 = [10, 38]


def _panel(seed, entries, twin_every=4, divergence=(0.3, 0.4)):
    spec = {"entries": entries, "length_min": 40, "length_max": 80,
            "divergence_min": divergence[0], "divergence_max": divergence[1],
            "v4_twin_every": twin_every}
    return panel.make_panel(gen.rng_for(seed, gen.REFERENCE, panel.STREAM), spec, V4)


def _reads(seed, entries, count):
    """Reads of 24 from V4, cut to 16-24 at their 3' end."""
    spec = {"length": 24, "v4": V4, "sub_rate": 0.05, "n_rate": 0.02, "reverse_rate": 0.5}
    rng = gen.rng_for(seed, gen.READS)
    reads = panel.make_reads(rng, spec, entries, count)["reads"]
    return gen.pad_tail(reads, rng.integers(16, 25, size=count))


def _fields(alignments):
    return [tuple(getattr(a, f) for f in FIELDS) for a in alignments]


def _check(reads, entries, name, max_pairs=1 << 20):
    """The port's answer, held to the JAX package's and to the plain
    reference's; returns the port's and the reference's."""
    got = search.map_reads(reads, entries, AlignmentParameters(**SCORING[name]), device="cpu",
                           max_pairs=max_pairs)
    jax = jax_search.map_reads(reads, entries, JaxParams(**SCORING[name]), impl="xla",
                               max_pairs=max_pairs, backend="oracle")
    want = panel.map_panel(reads, entries, reference.Scoring.from_config(SCORING[name]))
    for field in ("index", "score", "strand", "mapq"):
        mine = getattr(got, field).astype(np.int64)
        np.testing.assert_array_equal(mine, np.asarray(getattr(jax, field)).astype(np.int64),
                                      err_msg=f"{field} against the JAX package")
        np.testing.assert_array_equal(mine, want[field], err_msg=field)
    assert _fields(got.alignments) == _fields(jax.alignments)
    assert _fields(got.alignments) == _fields(want["alignments"])
    return got, want


@pytest.mark.parametrize("name", sorted(SCORING))
@pytest.mark.parametrize("chunks", [1, 3, 4])
@pytest.mark.parametrize("seed", [5, 2 ** 33 + 1])
def test_map_reads_equals_the_panel_reference(name, chunks, seed):
    count = 10 + seed % 3
    # Four chunks at the configuration's divergence: entries often tie.
    divergence = (0.015, 0.10) if chunks == 4 else (0.3, 0.4)
    entries = _panel(seed, 6 + seed % 7, divergence=divergence)
    reads = _reads(seed, entries, count)
    chunk = -(-entries.shape[0] // chunks)
    _check(reads, entries, name, max_pairs=count * chunk)


@pytest.mark.parametrize("name", sorted(SCORING))
@pytest.mark.parametrize("reverse", [False, True])
def test_v4_twins_across_a_chunk_boundary_give_the_lower_index_and_mapq_0(name, reverse):
    entries = _panel(7, 8)                      # entry 4 holds entry 3's V4
    assert np.array_equal(entries[4, V4[0]:V4[1]], entries[3, V4[0]:V4[1]])
    reads = np.stack([entries[4, 12:32], entries[3, 14:34], entries[6, 11:31]])
    if reverse:
        reads = gen.reverse_complement(reads)
    got, _ = _check(reads, entries, name, max_pairs=4 * reads.shape[0])   # chunks of 4
    assert list(got.index[:2]) == [3, 3] and list(got.mapq[:2]) == [0, 0]
    assert list(got.strand[:2]) == [int(reverse)] * 2


@pytest.mark.parametrize("name", sorted(SCORING))
def test_a_read_whose_strands_tie_maps_forward(name):
    entries = _panel(8, 9)
    half = entries[5, 12:22]
    palindrome = np.concatenate([half, gen.reverse_complement(half[None])[0]])
    reads = np.stack([palindrome, entries[2, 15:35]])
    assert np.array_equal(gen.reverse_complement(reads[:1])[0], palindrome)
    got, _ = _check(reads, entries, name, max_pairs=2 * 3)                # chunks of 3
    assert got.strand[0] == 0 and got.mapq[0] == 0


@pytest.mark.parametrize("name", sorted(SCORING))
def test_a_one_entry_panel_gives_mapq_60(name):
    entries = _panel(9, 1)
    reads = np.stack([entries[0, 10:34], gen.reverse_complement(entries[:1, 14:38])[0]])
    got, _ = _check(reads, entries, name)
    assert list(got.index) == [0, 0] and list(got.strand) == [0, 1]
    assert list(got.mapq) == [60, 60]


def test_counters_count_the_chunks_and_cells_of_both_strands():
    entries = _panel(10, 11)
    reads = _reads(10, entries, 6)
    chunk = 4                                  # 11 entries: chunks of 4, 4, 3
    profiling.reset_counters()
    search.map_reads(reads, entries, device="cpu", max_pairs=6 * chunk)
    assert profiling.counters() == {}          # no profiler: nothing counted
    with profile(activities=[ProfilerActivity.CPU]):
        search.map_reads(reads, entries, device="cpu", max_pairs=6 * chunk)
    got = profiling.counters()
    assert got["search.chunks"] == 2 * 3
    b, m = reads.shape
    r, n = entries.shape
    assert got["cells.search"] == 2 * b * r * m * n
    search.map_reads(reads, entries, device="cpu", max_pairs=6 * chunk)
    assert profiling.counters() == got         # off again: nothing added
