"""The cell ``illumina150.panel`` on the CPU at small sizes: a sound run is
correct with every number 0; the control, a score block altered where it
is produced, a hit altered outside the sample and an altered CIGAR each
fail it; the cell's readers give None where they have nothing to read; the
panel generator."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from vbench import gen, panel, trace
from vbench.cell import Run, run_cell
from vbench.spec import Spec, problems

CELL = "illumina150.panel"
#: The cell cut to a size the CPU runs in a second.
SMALL = {"traffic": {"reads_per_call": 6, "pool": 2, "check_reads": 4},
         "reads": {"length": 20, "v4": [10, 38]},
         "panel": {"entries": 10, "length_min": 40, "length_max": 80, "v4_twin_every": 4}}
#: A size where right scores pass what 8-bit cells hold (reads of 150).
WIDE = {"traffic": {"reads_per_call": 3, "pool": 1, "check_reads": 3},
        "panel": {"entries": 5, "length_min": 220, "length_max": 260, "v4_twin_every": 2},
        "reads": {"v4": [20, 200]}}
#: The per-layer metrics of the cell: five the genome cell reports too, and
#: the readers of the counters ``cells.search`` and ``search.chunks``.
METRICS = ("b4_roofline_pct", "search_merge_ms_per_call", "align_ms_per_call",
           "align_decode_ms_per_call", "device_idle_pct.map", "b4_useful_cells_pct",
           "search_chunks_per_call")


def _run(sizes, seed=2 ** 31 + 21, **kw):
    return run_cell(Spec(), CELL, seed, kw.pop("seconds", 0.0), False, torch.device("cpu"),
                    time.perf_counter(), overrides=sizes, **kw)


def test_the_cell_is_correct_at_small_size():
    out = _run(SMALL, 2 ** 31 + 11, seconds=0.3)
    assert out["correct"] and out["attempted"] >= 2 and out["failed"] == 0
    assert set(out["metrics"]) == {"reads_per_s", "setup_s"}
    assert all(c["value"] == 0 and c["limit"] == 0 for c in out["checks"].values())


def test_a_sound_run_passes_where_scores_pass_127():
    out = _run(WIDE)
    assert out["correct"], out["checks"]


def test_the_control_fails():
    out = _run(WIDE, program=lambda entry: entry.control, min_calls=1)
    assert not out["correct"]
    assert out["checks"]["hits_wrong"]["value"] + out["checks"]["hit_scores_wrong"]["value"] >= 1


def test_the_last_entry_of_each_chunk_winning_fails(monkeypatch):
    from versalignlib_tpu_torch.ops import cuda_search

    real = cuda_search.cross_scores_device

    def altered(reads, pool, *args, **kw):
        out = real(reads, pool, *args, **kw).clone()
        out[:, -1] += 1000
        return out

    monkeypatch.setattr(cuda_search, "cross_scores_device", altered)
    out = _run(WIDE)
    assert not out["correct"] and out["checks"]["calls_failed"]["value"] == 0


@pytest.mark.parametrize("field", ["score", "index", "strand"])
def test_a_hit_altered_outside_the_sample_fails(field, monkeypatch):
    """One read of each call altered where the answer is made, and a sample
    that leaves that read out: every read's hit score is still compared."""
    from versalignlib_tpu_torch import search

    seed = 2 ** 31 + 22
    row = (int(gen.rng_for(seed, gen.SAMPLE).choice(3, size=1)[0]) + 1) % 3
    real = search.map_reads

    def altered(*args, **kw):
        hits = real(*args, **kw)
        value = getattr(hits, field).copy()
        if field == "strand":
            value[row] = 1 - value[row]
        elif field == "index":
            value[row] = (value[row] + 2) % 5       # past its V4 twin
        else:
            value[row] += 7
        return dataclasses.replace(hits, **{field: value})

    monkeypatch.setattr(search, "map_reads", altered)
    out = _run(WIDE | {"traffic": {"reads_per_call": 3, "pool": 1, "check_reads": 1}}, seed)
    checks = out["checks"]
    assert checks["hit_scores_wrong"]["value"] >= 1 and not out["correct"]
    assert checks["hits_wrong"]["value"] == 0 and checks["calls_failed"]["value"] == 0


def test_an_altered_cigar_fails_the_alignments_alone(monkeypatch):
    from versalignlib_tpu_torch import search

    real = search._align_pairs

    def altered(*args, **kw):
        alns = real(*args, **kw)
        return [dataclasses.replace(alns[0], cigar=alns[0].cigar + "1M")] + alns[1:]

    monkeypatch.setattr(search, "_align_pairs", altered)
    checks = _run(SMALL)["checks"]
    assert checks["alignments_wrong"]["value"] >= 1
    assert all(c["value"] == 0 for k, c in checks.items() if k != "alignments_wrong")


def test_benchmark_json_keeps_the_rules():
    assert problems(Spec()) == []
    assert {m["name"] for m in Spec().per_layer(CELL)} == set(METRICS)


def test_the_readers_read_none_without_a_trace_or_counters(monkeypatch):
    from versalignlib_tpu_torch.utils import profiling

    spec = Spec()
    units = {"calls": 3, "reads": 6144, "b4_cells": 10 ** 9, "b4_bytes": 10 ** 6}
    untraced = Run(spec.cell(CELL), spec.config("emp16s_v4_gg97"), {}, 1.0, 1.0, units)
    window = {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0,
              "dur": 1000}
    empty = dataclasses.replace(untraced, trace=trace.Trace([window], {}))
    monkeypatch.setattr(profiling, "counters", lambda: {})
    for name in METRICS:
        assert spec.metric(name).read(untraced) is None, name
        if name != "device_idle_pct.map":       # an empty window is all idle
            assert spec.metric(name).read(empty) is None, name
    assert spec.metric("device_idle_pct.map").read(empty) == 100.0


def test_the_counter_readers_read_the_window_s_counters(monkeypatch):
    from versalignlib_tpu_torch.utils import profiling

    spec = Spec()
    units = {"calls": 3, "reads": 6144, "b4_cells": 9 * 10 ** 8, "b4_bytes": 10 ** 6}
    window = {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0,
              "dur": 1000}
    run = Run(spec.cell(CELL), spec.config("emp16s_v4_gg97"), {}, 1.0, 1.0, units,
              trace.Trace([window], {}))
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"search.chunks": 12, "cells.search": 10 ** 9})
    assert spec.metric("search_chunks_per_call").read(run) == 4.0
    assert spec.metric("b4_useful_cells_pct").read(run) == 90.0


def test_the_generator_follows_the_seed_and_twins_every_16th_v4():
    cfg = Spec().config("emp16s_v4_gg97")
    spec = cfg["panel"] | {"entries": 40}
    start, end = cfg["reads"]["v4"]
    one, two, other = (panel.make_panel(gen.rng_for(s, gen.REFERENCE, panel.STREAM), spec,
                                        cfg["reads"]["v4"]) for s in (5, 5, 2 ** 40 + 5))
    assert np.array_equal(one, two) and not np.array_equal(one, other)
    lens = gen.lengths(one)
    assert lens.min() >= spec["length_min"] and lens.max() <= spec["length_max"]
    for i in range(one.shape[0]):
        same = np.array_equal(one[i, start:end], one[i - 1, start:end]) if i else False
        assert same == (i > 0 and i % 16 == 0), i
    reads = [panel.make_reads(gen.rng_for(s, gen.READS, 0), cfg["reads"], one, 64)
             for s in (5, 5, 6)]
    assert np.array_equal(reads[0]["reads"], reads[1]["reads"])
    assert not np.array_equal(reads[0]["reads"], reads[2]["reads"])
    got = reads[0]
    assert got["reads"].shape == (64, 150) and 0 < got["reverse"].sum() < 64
    fwd = ~got["reverse"]
    exact = one[got["entry"][fwd, None], start + np.arange(150)]
    assert (got["reads"][fwd] == exact).mean() > 0.95
