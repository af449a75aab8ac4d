"""Readers of the program's own spans and counters in a traced run.

The port (``versalignlib_tpu_torch.utils.profiling``) opens its spans as
``record_function`` ranges while a profiler runs, so they are host events
of the window's trace, named ``<layer>.<step>``; its counters count only
while a profiler runs, and the profiler runs over the window alone, so
after the window they hold the window's calls. A program that opens no
such span or keeps no such counter gives None, never an error.
"""

from __future__ import annotations


def span_ms_per_call(run, names: set[str]) -> float | None:
    """Host milliseconds a call in the spans named ``names`` that start
    inside the window; None without a trace, calls, or any such span."""
    if run.trace is None or not run.units.get("calls"):
        return None
    t = run.trace
    spans = [end - start for start, end, name in t.host
             if name in names and t.w0 <= start < t.w1]
    if not spans:
        return None
    return sum(spans) / 1e3 / run.units["calls"]


def counter(name: str) -> int | None:
    """The program's counter ``name`` as the window left it; None where the
    program keeps no counters or has not counted ``name``."""
    from versalignlib_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    return None if counters is None else counters().get(name)
