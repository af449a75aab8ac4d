"""The port's spans and counters (``utils/profiling.py``): off, nothing is
built or counted; under a ``torch.profiler`` the score, align and mapping
paths open their spans, each inside its parent on the caller's thread, and
the counters count what was scored and copied. Imports no JAX.

The card case runs on a host with a CUDA device:

    python -m pytest tests/test_torch_tracing.py -m card --noconftest -p no:cacheprovider
"""

import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from versalignlib_tpu_torch import refmap, search
from versalignlib_tpu_torch.dispatch import AlignmentEngine
from versalignlib_tpu_torch.ops import cuda_align
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm
from versalignlib_tpu_torch.utils import profiling

SW = Algorithm.SMITH_WATERMAN
AFFINE = AlignmentParameters(score_match=1, score_mismatch=-4, score_gap_read=-1,
                             score_gap_ref=-1, gap_open_read=-6, gap_open_ref=-6)


def _pairs(seed, b, m, n):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, 5, size=(b, m)).astype(np.uint8),
            rng.integers(1, 5, size=(b, n)).astype(np.uint8))


def _genome_and_reads(seed=3, length=2400, reads=6, m=40):
    rng = np.random.default_rng(seed)
    genome = rng.integers(1, 5, size=length).astype(np.uint8)
    at = rng.integers(0, length - m, size=reads)
    return genome, genome[at[:, None] + np.arange(m)]


def _score(device="cpu"):
    AlignmentEngine(backend="cuda", device=device).score_alignments(SW, *_pairs(0, 5, 24, 30))


def _align():
    reads, refs = _pairs(1, 7, 20, 26)
    cuda_align.align_batch(reads, refs, AFFINE, SW, device="cpu", chunk_pairs=3)


def _map():
    genome, reads = _genome_and_reads()
    # 256-bp windows every 128: 18 windows, 2 a chunk at 12 pairs.
    hits = refmap.map_to_reference(reads, [genome], AFFINE, window=256, stride=128,
                                   device="cpu", max_pairs=12)
    assert len(hits) == reads.shape[0]


def _map_reads():
    genome, reads = _genome_and_reads(4, 600, 5, 30)
    search.map_reads(reads, genome[:576].reshape(9, 64), device="cpu", max_pairs=15)


def _best_hits():
    genome, reads = _genome_and_reads(4, 600, 5, 30)
    search.best_hits(reads, genome[:576].reshape(9, 64), device="cpu", max_pairs=15)


#: Each path, the spans it opens on the CPU and each span's parent.
PATHS = {
    "score": (_score, {"engine.score_alignments": None,
                       "score.h2d": "engine.score_alignments",
                       "score.launch": "engine.score_alignments",
                       "score.d2h": "engine.score_alignments"}),
    "align": (_align, {"align.batch": None, "align.dispatch": "align.batch",
                       "align.decode": "align.batch"}),
    "map_to_reference": (_map, {"refmap.map_to_reference": None,
                                "search.budget": "refmap.map_to_reference",
                                "refmap.search": "refmap.map_to_reference",
                                "search.stage": "refmap.search",
                                "search.scores": "refmap.search",
                                "search.merge": "refmap.search",
                                "refmap.rank": "refmap.map_to_reference",
                                "align.batch": "refmap.map_to_reference",
                                "align.dispatch": "align.batch",
                                "align.decode": "align.batch",
                                "refmap.shift": "refmap.map_to_reference"}),
    "map_reads": (_map_reads, {"search.map_reads": None,
                               "search.budget": "search.map_reads",
                               "search.stream": "search.map_reads",
                               "search.stage": "search.stream",
                               "search.scores": "search.stream",
                               "search.merge": "search.stream",
                               "align.batch": "search.map_reads"}),
    "best_hits": (_best_hits, {"search.budget": None,
                               "search.stream": None,
                               "search.stage": "search.stream",
                               "search.scores": "search.stream",
                               "search.merge": "search.stream",
                               "align.batch": None}),
}


def _span_parent(event, names):
    """The nearest enclosing span (a name of ``names``) of ``event``."""
    up = event.cpu_parent
    while up is not None and up.name not in names:
        up = up.cpu_parent
    return up


@pytest.mark.parametrize("path", sorted(PATHS))
def test_no_profiler_builds_no_span_and_counts_nothing(path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span was built with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    before = profiling.counters()
    PATHS[path][0]()
    assert profiling.counters() == before
    assert profiling.annotate("a") is profiling.annotate("b")


@pytest.mark.parametrize("path", sorted(PATHS))
def test_spans_nest_inside_their_parents(path):
    run, want = PATHS[path]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    spans = [e for e in prof.events() if e.name in want]
    assert {e.name for e in spans} == set(want)
    for event in spans:
        parent = _span_parent(event, want)
        assert (parent.name if parent else None) == want[event.name], event.name
        if parent is not None:
            assert parent.thread == event.thread
            assert parent.time_range.start <= event.time_range.start
            assert event.time_range.end <= parent.time_range.end
    if path == "map_to_reference":
        # Both strands, at least two chunks each: a fold after every chunk.
        assert sum(e.name == "refmap.search" for e in spans) == 2
        assert sum(e.name == "search.scores" for e in spans) >= 4
        assert sum(e.name == "search.merge" for e in spans) >= 4
    if path in ("map_reads", "best_hits"):
        # One stream a call over every strand (map_reads: both), three
        # chunks a strand (9 entries, 3 a chunk), each searched and folded.
        strands = 2 if path == "map_reads" else 1
        assert sum(e.name == "search.stream" for e in spans) == 1
        assert sum(e.name == "search.scores" for e in spans) == 3 * strands
        assert sum(e.name == "search.merge" for e in spans) == 3 * strands


def test_counters_count_the_cells_scored_and_no_copy_on_the_cpu():
    engine = AlignmentEngine(backend="cuda", device="cpu")
    shapes = [(5, 24, 30), (3, 17, 40), (0, 8, 8), (2, 0, 9)]
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        for k, shape in enumerate(shapes):
            engine.score_alignments(SW, *_pairs(k, *shape))
        _map()
    got = profiling.counters()
    assert got["cells.score"] == sum(b * m * n for b, m, n in shapes)
    assert got.get("h2d_bytes", 0) == 0
    engine.score_alignments(SW, *_pairs(9, 4, 10, 10))
    assert profiling.counters() == got          # off again: nothing added


def test_trace_resets_and_writes_the_counters(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("stale", 5)
    with profiling.trace(str(tmp_path)):
        _score()
    traces = list(tmp_path.glob("trace_*.json"))
    files = list(tmp_path.glob("counters_*.json"))
    assert len(traces) == 1 and len(files) == 1
    assert files[0].name.removeprefix("counters_") == traces[0].name.removeprefix("trace_")
    assert json.loads(files[0].read_text()) == {"cells.score": 5 * 24 * 30}
    assert profiling.counters() == {"cells.score": 5 * 24 * 30}


def test_counts_from_many_threads_add_up():
    """Every thread counts while the profiler runs in the main one (a mesh
    launches from a thread a card), and no add is lost."""
    threads, adds = 16, 2000
    switch = sys.getswitchinterval()
    profiling.reset_counters()
    try:
        sys.setswitchinterval(1e-6)
        with profile(activities=[ProfilerActivity.CPU]):
            workers = [threading.Thread(target=lambda: [profiling.count("n", 3)
                                                        for _ in range(adds)])
                       for _ in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
            assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(switch)
    assert profiling.counters() == {"n": 3 * adds * threads}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_h2d_bytes_equal_the_traced_copies(card, tmp_path):
    """One score call on the card: ``h2d_bytes`` equals the bytes of the
    host-to-device copies in the profiler's Chrome trace."""
    _score(card)                                # builds the kernel
    with profiling.trace(str(tmp_path)):
        _score(card)
        torch.cuda.synchronize(card)
    (path,) = tmp_path.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    copied = sum(int(e["args"]["bytes"]) for e in events
                 if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""))
    assert copied > 0
    assert profiling.counters()["h2d_bytes"] == copied
    assert profiling.counters()["cells.score"] == 5 * 24 * 30


@pytest.mark.card
def test_score_chunks_count_the_plan(card, tmp_path):
    """A batch of several waves: ``score.chunks`` equals the chunks of the
    scorer's plan, and ``h2d_bytes`` the codes of the batch."""
    from versalignlib_tpu_torch.ops import cuda_score

    engine = AlignmentEngine(backend="cuda", device=card)
    m, n = 24, 30
    wave = cuda_score.wave_pairs(m, n, engine.params, SW, card)
    b = 3 * wave + 11
    reads, refs = _pairs(5, b, m, n)
    engine.score_alignments(SW, reads[:7], refs[:7])         # builds the kernel
    with profiling.trace(str(tmp_path)):
        engine.score_alignments(SW, reads, refs)
    chunks = len(cuda_score.chunk_plan(b, wave))
    assert chunks == 3
    assert profiling.counters()["score.chunks"] == chunks
    assert profiling.counters()["h2d_bytes"] == b * (m + n)
