"""What every entry (``vbench/entries/<name>.py``) does for a cell: make
its inputs from the seed, build and warm up the program's state, make the
timed calls, free the state, and judge the answers against the plain
reference."""

from __future__ import annotations

import contextlib
import time
from typing import Callable, NamedTuple

import torch

from vbench import trace


class Record(NamedTuple):
    """One call of the window: its index, host times, answer, or the error
    it raised."""

    k: int
    t0: float
    t1: float
    answer: object
    error: str | None


class Check(NamedTuple):
    """One number compared, with its limit: correct while value <= limit."""

    name: str
    value: float
    limit: float


class Entry:
    """One entry point of the program, driven by one caller in a closed
    loop: a call is issued when the last one has returned."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device, chips: int = 1):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.chips = device, chips

    def setup(self) -> None:
        """Inputs from the seed, the program's state, one warm-up call of
        every shape the window uses."""
        raise NotImplementedError

    def call(self, k: int):
        """The program's answer to call ``k``, on the host."""
        raise NotImplementedError

    def control(self, k: int):
        """Call ``k`` answered by the plain reference in the control's
        precision (:meth:`check` reads it as it reads the program's)."""
        raise NotImplementedError

    def units(self, records: list[Record]) -> dict:
        """Counts of the work the answered calls did."""
        raise NotImplementedError

    def release(self) -> None:
        """Drop the program's state, so that the reference finds the card
        free."""

    def check(self, records: list[Record]) -> list[Check]:
        """The numbers that decide ``correct``, each beside its limit."""
        raise NotImplementedError

    def run(self, stop: Callable[[int], bool], traced: bool) -> list[Record]:
        """Calls until ``stop(calls made)``: each call's index, times and
        answer (an error is kept and counted as failed)."""
        records = []
        while not stop(len(records)):
            k = len(records)
            span = torch.profiler.record_function(trace.CALL) if traced else contextlib.nullcontext()
            t0 = time.perf_counter()
            answer, error = None, None
            with span:
                try:
                    answer = self.call(k)
                except Exception as exc:  # a failed call counts, the run goes on
                    error = f"{type(exc).__name__}: {exc}"
            records.append(Record(k, t0, time.perf_counter(), answer, error))
        return records


def failed_check(records: list[Record]) -> Check:
    """Calls that raised: none may."""
    return Check("calls_failed", sum(r.error is not None for r in records), 0)
