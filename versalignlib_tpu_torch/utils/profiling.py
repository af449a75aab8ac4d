"""Profiling hooks: torch.profiler traces and GCUPS accounting (the port's
counterpart of ``versalignlib_tpu/utils/profiling.py``)."""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pathlib
import time
from typing import Iterator

import torch

from versalignlib_tpu_torch.utils.logging import get_logger

_log = get_logger("profiling")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where a card
    is present) and write a Chrome trace into ``log_dir``. Yields the
    profiler, whose ``key_averages()`` sum the block's time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = out / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    _log.info("profiler trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in profiler timelines."""
    with torch.profiler.record_function(name):
        yield


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
