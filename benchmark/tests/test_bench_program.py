"""The readers of the program's own spans and counters (vbench/program.py
and the metrics that use it), on a synthetic trace and run, and what they
give where the program opens no span or keeps no counter."""

import pytest

from vbench import trace
from vbench.cell import Run
from vbench.spec import Spec


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    _x("user_annotation", trace.WINDOW, 1000, 1000),
    _x("user_annotation", "score.h2d", 900, 50),               # before the window
    _x("user_annotation", trace.CALL, 1000, 490),
    _x("user_annotation", "engine.score_alignments", 1005, 480),
    _x("user_annotation", "score.h2d", 1010, 120),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1030, 60),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1095, 20),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1300, 10),
    _x("user_annotation", "search.merge", 1200, 30),
    _x("user_annotation", "refmap.rank", 1240, 40),
    _x("user_annotation", "align.batch", 1300, 150),
    _x("user_annotation", "align.decode", 1350, 90),
    _x("user_annotation", "refmap.shift", 1460, 10),
    _x("user_annotation", trace.CALL, 1500, 490),
    _x("user_annotation", "score.h2d", 1510, 80),
    _x("user_annotation", "search.merge", 1600, 50),
    _x("user_annotation", "align.batch", 1700, 250),
    _x("user_annotation", "align.decode", 1800, 110),
    _x("user_annotation", "score.h2d", 1990, 30),              # ends past the window
    _x("user_annotation", "search.merge", 2100, 50),           # past the window
]

#: Host microseconds inside the window, by span: the readers' sums.
WANT_US = {"score_h2d_host_ms_per_call": 120 + 80 + 30, "search_merge_ms_per_call": 30 + 50,
           "map_host_ms_per_call": 40 + 10, "align_ms_per_call": 150 + 250,
           "align_decode_ms_per_call": 90 + 110}


@pytest.fixture
def counted(monkeypatch):
    """The program's counters, patched."""
    from versalignlib_tpu_torch.utils import profiling

    values = {"h2d_bytes": 4_000_000, "cells.score": 2_000_000}
    monkeypatch.setattr(profiling, "counters", lambda: dict(values))
    return values


def _run(parsed, units=None):
    units = {"calls": 2, "b1_cells": 780_000} if units is None else units
    return Run({}, Spec().config("ref512_dna"), {}, 1.0, 1e-3, units, parsed)


@pytest.fixture
def parsed():
    return trace.Trace(EVENTS, {})


@pytest.mark.parametrize("name", sorted(WANT_US))
def test_span_readers_sum_the_window_s_spans_a_call(name, parsed):
    assert Spec().metric(name).read(_run(parsed)) == pytest.approx(WANT_US[name] / 1e3 / 2)


def test_counter_readers(parsed, counted):
    spec = Spec()
    # 4e6 bytes over the 80 us of host-to-device copies in the window.
    assert spec.metric("h2d_gbps").read(_run(parsed)) == pytest.approx(4e6 / 80e-6 / 1e9)
    assert spec.metric("b1_useful_cells_pct").read(_run(parsed)) == pytest.approx(39.0)


NEW = sorted(WANT_US) + ["h2d_gbps", "b1_useful_cells_pct"]


@pytest.mark.parametrize("name", NEW)
def test_readers_give_none_without_a_trace_or_calls(name, parsed, counted):
    read = Spec().metric(name).read
    assert read(_run(None)) is None
    assert read(_run(parsed, {"calls": 0, "b1_cells": 0})) is None


@pytest.mark.parametrize("name", NEW)
def test_readers_give_none_where_the_program_has_nothing_to_read(name, monkeypatch):
    """A program without the spans and counters (the parent of this
    benchmark's readers) gives None, not an error."""
    from versalignlib_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "counters", raising=False)
    bare = trace.Trace([e for e in EVENTS if e["name"] in (trace.WINDOW, trace.CALL)
                        or e["cat"] == "gpu_memcpy"], {})
    assert Spec().metric(name).read(_run(bare)) is None


def test_spec_takes_the_new_metrics():
    spec = Spec()
    layer = {m["name"]: m for m in spec.data["per_layer"]}
    cells = {"ref512.score": {"score_h2d_host_ms_per_call", "h2d_gbps", "b1_useful_cells_pct"},
             "illumina150.genome": {"search_merge_ms_per_call", "map_host_ms_per_call",
                                    "align_ms_per_call", "align_decode_ms_per_call"}}
    for cell, names in cells.items():
        assert names <= {m["name"] for m in spec.per_layer(cell)}
        reported = {m["name"] for m in spec.end_to_end(cell)}
        for name in names:
            m = layer[name]
            assert m["workloads"] == [cell] and m["moves"] in reported
            assert m["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
            assert hasattr(spec.metric(name), "read")
