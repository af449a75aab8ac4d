"""Profiling hooks: torch.profiler traces, the program's spans and
counters, and GCUPS accounting (the port's counterpart of
``versalignlib_tpu/utils/profiling.py``).

Tracing is on exactly while a ``torch.profiler`` runs (:func:`trace`, or
any profiler a caller starts). Then :func:`annotate` opens a
``record_function`` range, which lands in the profiler's trace beside the
card's kernels and copies, on the same clock, and :func:`count` adds to a
named counter. With no profiler running a span is a shared null context
and a count one check: nothing is built or added.

Spans are named ``<layer>.<step>`` (``engine.score_alignments``,
``score.h2d``, ``search.merge``, ``align.decode``, ...); a span's parent is
the span that encloses it on its thread. Counters: ``h2d_bytes`` (bytes
of host arrays copied to a card), ``cells.score`` (B x m x n of every
batch the score path scores), ``score.chunks`` (the chunks in which
``CudaScorer`` copied and scored its batches on a card), ``cells.search``
(B x R x m x n of every one-vs-many score block, padded shapes) and
``search.chunks`` (the panel chunks ``search`` folds into its running
top-2).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
import threading
import time
from typing import Iterator

import torch

from versalignlib_tpu_torch.utils.logging import get_logger

_log = get_logger("profiling")


_OFF = contextlib.nullcontext()
#: ``_profiler._is_profiler_enabled`` is the process's flag that every
#: ``torch.profiler`` sets while it runs: one attribute read when off.
_profiler = torch.autograd.profiler
#: Whether the running profiler records this thread's ranges.
_thread_profiled = torch.autograd._profiler_enabled
_counts: dict[str, int] = {}
_counts_lock = threading.Lock()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where a card
    is present), which turns the spans and counters on, and write into
    ``log_dir`` a Chrome trace (``trace_<pid>_<ns>.json``) and the block's
    counters (``counters_<pid>_<ns>.json``). Yields the profiler, whose
    ``key_averages()`` sum the block's time by kernel and span."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    reset_counters()
    with profile(activities=activities) as prof:
        yield prof
    stem = f"{os.getpid()}_{time.time_ns()}"
    path = out / f"trace_{stem}.json"
    prof.export_chrome_trace(str(path))
    (out / f"counters_{stem}.json").write_text(json.dumps(counters(), indent=1, sort_keys=True))
    _log.info("profiler trace and counters written to %s", out)


def annotate(name: str) -> contextlib.AbstractContextManager:
    """A named span in profiler timelines: ``record_function(name)`` while a
    profiler runs and records this thread, else one shared null context."""
    if not (_profiler._is_profiler_enabled and _thread_profiled()):
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler runs in the
    process (a mesh's thread a card counts too); else nothing."""
    if not _profiler._is_profiler_enabled:
        return
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> dict[str, int]:
    """A copy of the counters."""
    with _counts_lock:
        return dict(_counts)


def reset_counters() -> None:
    """Set every counter back to nothing."""
    with _counts_lock:
        _counts.clear()


@dataclasses.dataclass
class GcupsMeter:
    """Accumulates DP cell updates / wall time across calls.

    cells = sum over batches of read_len * ref_len * pairs (padded lengths,
    the same accounting the reference's harness implies — BASELINE.md).
    """

    cells: int = 0
    seconds: float = 0.0
    calls: int = 0

    @contextlib.contextmanager
    def measure(self, cells: int) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        self.seconds += time.perf_counter() - t0
        self.cells += cells
        self.calls += 1

    @property
    def gcups(self) -> float:
        return self.cells / self.seconds / 1e9 if self.seconds else 0.0

    def report(self) -> str:
        return (
            f"{self.cells:.3e} cells in {self.seconds:.3f}s over "
            f"{self.calls} calls = {self.gcups:.2f} GCUPS"
        )
