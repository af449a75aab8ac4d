"""Wall timers and the GCUPS arithmetic (the port's counterpart of
``versalignlib_tpu/utils/timers.py``).

Replaces the reference's third-party µs ``Timer``
(src/util/versalignUtil.h:115-144) and the TSV benchmark rows printed by
``time_kernel`` (src/impl/main.cpp:240-295). The
throughput metric is GCUPS: 1e9 DP cell updates a second, with cells =
sum_i read_len_i * ref_len_i over the batch (padded lengths).

Kernel launches return before the card has finished, so a call timed on the
card passes ``sync=lambda _: torch.cuda.synchronize()``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable


class Timer:
    """Microsecond wall timer with start/stop, reference-Timer-shaped API."""

    def __init__(self) -> None:
        self._start = 0.0
        self._stop = 0.0
        self._running = False

    def start(self) -> None:
        self._running = True
        self._start = time.perf_counter()

    def stop(self) -> None:
        self._stop = time.perf_counter()
        self._running = False

    def elapsed_seconds(self) -> float:
        end = time.perf_counter() if self._running else self._stop
        return end - self._start

    def elapsed_micros(self) -> float:
        return self.elapsed_seconds() * 1e6


@dataclasses.dataclass
class BenchResult:
    seconds_per_call: float
    cells_per_call: int
    pairs_per_call: int

    @property
    def gcups(self) -> float:
        return self.cells_per_call / self.seconds_per_call / 1e9

    @property
    def pairs_per_second(self) -> float:
        return self.pairs_per_call / self.seconds_per_call


def time_batched_call(
    fn: Callable[[], object],
    *,
    cells_per_call: int,
    pairs_per_call: int,
    warmup: int = 2,
    iters: int = 10,
    sync: Callable[[object], object] | None = None,
) -> BenchResult:
    """Time ``fn`` like the reference's time_kernel loop (mean over iters,
    main.cpp:268-292); ``sync(out)`` waits for the device after each call
    (on the card: ``lambda _: torch.cuda.synchronize()``)."""
    for _ in range(warmup):
        out = fn()
        if sync is not None:
            sync(out)
    t = Timer()
    t.start()
    for _ in range(iters):
        out = fn()
        if sync is not None:
            sync(out)
    t.stop()
    return BenchResult(
        seconds_per_call=t.elapsed_seconds() / iters,
        cells_per_call=cells_per_call,
        pairs_per_call=pairs_per_call,
    )
