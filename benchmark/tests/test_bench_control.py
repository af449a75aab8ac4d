"""The comparison fails what it must: the control (the reference in 8-bit
cells in the program's place) and an answer altered where the program
produces it, each cell at a size where right scores pass 127."""

import time

import numpy as np
import pytest
import torch
from conftest import WIDE

from vbench.cell import run_cell
from vbench.spec import Spec

CELLS = sorted(WIDE)


def _run(cell, **kw):
    return run_cell(Spec(), cell, 2 ** 31 + 21, 0.0, False, torch.device("cpu"),
                    time.perf_counter(), overrides=WIDE[cell], **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_pass_at_this_size(cell):
    assert _run(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell):
    out = _run(cell, program=lambda entry: entry.control, min_calls=2)
    assert not out["correct"]
    assert max(c["value"] - c["limit"] for c in out["checks"].values()) >= 1


def _altered_scores(monkeypatch, module):
    real = module.score_batch_device

    def altered(*args, **kw):
        out = real(*args, **kw).clone()
        out[0] += 1
        return out

    monkeypatch.setattr(module, "score_batch_device", altered)


def _altered_search(monkeypatch):
    from versalignlib_tpu_torch.ops import cuda_search

    real = cuda_search.cross_scores_device

    def altered(reads, pool, *args, **kw):
        out = real(reads, pool, *args, **kw).clone()
        out[:, -1] += 1000          # the last entry of each chunk wins
        return out

    monkeypatch.setattr(cuda_search, "cross_scores_device", altered)


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced_fails(cell, monkeypatch):
    from versalignlib_tpu_torch.ops import cuda_score

    if cell == "ref512.score":
        _altered_scores(monkeypatch, cuda_score)
    else:
        _altered_search(monkeypatch)
    out = _run(cell)
    assert not out["correct"]
    assert out["checks"]["calls_failed"]["value"] == 0


def test_an_altered_alignment_fails(monkeypatch):
    """A hit right and its alignment wrong: only the alignments' number
    catches it."""
    import dataclasses

    from versalignlib_tpu_torch import refmap

    real = refmap._align_pairs

    def altered(*args, **kw):
        alns = real(*args, **kw)
        return [dataclasses.replace(alns[0], cigar=alns[0].cigar + "1M")] + alns[1:]

    monkeypatch.setattr(refmap, "_align_pairs", altered)
    out = _run("illumina150.genome")
    assert out["checks"]["hits_wrong"]["value"] == 0
    assert out["checks"]["hit_scores_wrong"]["value"] == 0
    assert out["checks"]["alignments_wrong"]["value"] >= 1 and not out["correct"]


@pytest.mark.parametrize("field", ["score", "pos", "strand"])
def test_a_hit_altered_outside_the_sample_fails(field, monkeypatch):
    """One read of each call altered where the answer is made, and a sample
    that leaves that read out: every read's hit score is still compared."""
    import dataclasses

    from versalignlib_tpu_torch import refmap

    from vbench import gen

    seed = 2 ** 31 + 22
    row = (int(gen.rng_for(seed, gen.SAMPLE).choice(3, size=1)[0]) + 1) % 3
    real = refmap.map_to_reference

    def altered(*args, **kw):
        hits = real(*args, **kw)
        value = getattr(hits, field).copy()
        value[row] = 1 - value[row] if field == "strand" else value[row] + 320
        return dataclasses.replace(hits, **{field: value})

    monkeypatch.setattr(refmap, "map_to_reference", altered)
    sizes = WIDE["illumina150.genome"] | {"traffic": {"reads_per_call": 3, "pool": 1,
                                                      "check_reads": 1}}
    out = run_cell(Spec(), "illumina150.genome", seed, 0.0, False, torch.device("cpu"),
                   time.perf_counter(), overrides=sizes)
    checks = out["checks"]
    assert checks["hit_scores_wrong"]["value"] >= 1 and not out["correct"]
    assert checks["hits_wrong"]["value"] == 0 and checks["calls_failed"]["value"] == 0


def test_control_scores_saturate_at_127():
    from vbench import gen, reference

    reads, refs = gen.make_pairs(gen.rng_for(1, gen.PAIRS), WIDE["ref512.score"]["pairs"]
                                 | {"n_rate": 0.02, "sub_rate": 0.02}, 32)
    sc = reference.Scoring(2, -1, -3, -3)
    full = reference.pair_scores(reads, refs, sc)
    narrow = reference.pair_scores(reads, refs, sc, cell_bits=8)
    assert narrow.max() == 127 and (full > 127).any()
    assert np.array_equal(narrow, np.minimum(full, 127))
