"""Reading a Chrome trace: the window, busy time, device time by kernel
source, the breakdown's lists, and the readers that take them."""

import pytest

from vbench import trace
from vbench.cell import Run
from vbench.spec import Spec


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    _x("user_annotation", trace.WINDOW, 1000, 1000),
    _x("user_annotation", trace.CALL, 1000, 490),
    _x("cpu_op", "aten::copy_", 1010, 100),
    _x("cuda_runtime", "cudaMemcpyAsync", 1020, 80),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1030, 60),
    _x("kernel", "void val::(anonymous namespace)::score_kernel<3, true>(ScoreArgs)", 1100, 200),
    _x("kernel", "void at::native::topk_kernel<int>(int*)", 1250, 100),   # overlaps B1
    _x("cpu_op", "aten::to", 1400, 80),
    _x("user_annotation", trace.CALL, 1500, 500),
    _x("kernel", "void val::(anonymous namespace)::score_kernel<3, true>(ScoreArgs)", 1600, 300),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1950, 100),      # past the window
    _x("kernel", "before_the_window", 500, 100),
    _x("gpu_user_annotation", trace.WINDOW, 1000, 1000),
    {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 1100},
]


@pytest.fixture
def parsed(tmp_path):
    (tmp_path / "score.cu").write_text(
        "__global__ void __launch_bounds__(kThreads) score_kernel(ScoreArgs a) {}\n")
    (tmp_path / "fill.cu").write_text("__global__ void\n    align_kernel(fill::Args a) {}\n")
    sources = trace.kernel_sources(tmp_path)
    assert sources == {"score_kernel": "score.cu", "align_kernel": "fill.cu"}
    return trace.Trace(EVENTS, sources)


def test_window_busy_and_device_time(parsed):
    assert parsed.window_s == pytest.approx(1e-3)
    # Device intervals in the window: 1030-1090, 1100-1350, 1600-1900, 1950-2000.
    assert parsed.busy_s == pytest.approx((60 + 250 + 300 + 50) / 1e6)
    assert parsed.seconds("score.cu") == pytest.approx(500 / 1e6)
    assert parsed.seconds(cat="gpu_memcpy") == pytest.approx(110 / 1e6)
    ops = dict(parsed.device_ops())
    assert ops["score.cu"] == pytest.approx(5e-4)
    assert ops["at::native::topk_kernel<int>"] == pytest.approx(1e-4)


def test_idle_gaps_by_what_the_host_was_doing(parsed):
    gaps = dict(parsed.idle_gaps())
    assert gaps["aten::copy_"] == pytest.approx(30 / 1e6)              # 1000-1030
    assert gaps["cudaMemcpyAsync"] == pytest.approx(10 / 1e6)          # 1090-1100
    assert gaps["aten::to"] == pytest.approx(250 / 1e6)                # 1350-1600
    assert gaps[f"{trace.CALL} (host between operations)"] == pytest.approx(50 / 1e6)
    assert sum(gaps.values()) == pytest.approx(1e-3 - 660 / 1e6)


def test_device_readers(parsed):
    spec = Spec()
    cfg = spec.config("ref512_dna")
    run = Run({}, cfg, {}, 1.0, 1e-3, {"calls": 2, "b1_cells": 10 ** 6,
                                           "b1_bytes": 10 ** 3}, parsed)
    idle = spec.metric("device_idle_pct.score").read(run)
    assert idle == pytest.approx(100 * (1 - 0.66))
    assert spec.metric("device_idle_pct.map").read(run) == idle
    h2d = spec.metric("h2d_ms_per_call").read(run)
    assert h2d == pytest.approx(60 / 1e3 / 2)
    b1 = spec.metric("b1_roofline_pct").read(run)
    assert b1 == pytest.approx(100 * 10 ** 7 / 133.816e12 / 5e-4, rel=1e-4)
    assert spec.metric("b4_roofline_pct").read(run) is None     # no B4 in the trace
    no_trace = Run({}, cfg, {}, 1.0, 1.0, {"calls": 2}, None)
    for name in ("device_idle_pct.score", "h2d_ms_per_call", "b1_roofline_pct"):
        assert spec.metric(name).read(no_trace) is None


def test_the_port_defines_the_kernels_the_readers_name():
    from vbench.cell import CSRC

    sources = trace.kernel_sources(CSRC)
    assert sources["score_kernel"] == "score.cu" and sources["search_kernel"] == "search.cu"
    assert {"align_kernel", "affine_kernel", "walk_kernel"} <= set(sources)


def test_spans_time_and_restore():
    import types

    mod = types.ModuleType("fake_mod_for_spans")
    mod.work = lambda x: x + 1
    import sys
    sys.modules["fake_mod_for_spans"] = mod
    original = mod.work
    with trace.Spans({"s": [("fake_mod_for_spans", "work", False)]}) as spans:
        assert mod.work(1) == 2 and mod.work(2) == 3
    assert mod.work is original and len(spans.seconds["s"]) == 2
