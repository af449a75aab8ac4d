"""The traced run: ``torch.profiler`` over the measured window, read back
from its Chrome trace, and host spans around the program's functions.

Device time is that of the trace's kernel, copy and memset events inside
the window (the host annotation :data:`WINDOW`); busy time is their union.
A kernel of the program is named by the source that defines it (its
``__global__`` function found in ``versalignlib_tpu_torch/csrc/*.cu``).
An idle gap is labelled by the innermost host event open at its middle.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import pathlib
import re
import tempfile
import threading
import time

import torch

#: The host annotation that spans the measured window.
WINDOW = "bench.window"
#: The host annotation of one call of an entry.
CALL = "bench.call"
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"})
#: Entries kept in each list of ``breakdown``.
TOP = 10

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")


def kernel_sources(csrc: pathlib.Path) -> dict[str, str]:
    """Each ``__global__`` function of ``csrc/*.cu`` -> its source's name."""
    out = {}
    for path in sorted(csrc.glob("*.cu")):
        for symbol in _GLOBAL.findall(path.read_text(errors="replace")):
            out[symbol] = path.name
    return out


def _label(name: str, cat: str, sources: dict[str, str], symbols: re.Pattern | None) -> str:
    if cat == "kernel":
        found = symbols.search(name) if symbols is not None else None
        if found:
            return sources[found.group(1)]
        name = name.removeprefix("void ")
        return name.split("(")[0][:80]
    return name


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


class Trace:
    """The device and host events of one traced window; times in seconds."""

    def __init__(self, events: list[dict], sources: dict[str, str]):
        windows = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
                   and e.get("cat") == "user_annotation"]
        if len(windows) != 1:
            raise RuntimeError(f"the trace holds {len(windows)} '{WINDOW}' annotations, not one")
        w0 = float(windows[0]["ts"])
        w1 = w0 + float(windows[0]["dur"])
        self.window_s = (w1 - w0) / 1e6
        symbols = (re.compile(r"\b(" + "|".join(map(re.escape, sorted(sources))) + r")\b")
                   if sources else None)
        self.device: list[tuple[float, float, str, str]] = []
        self.host: list[tuple[float, float, str]] = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            start = float(e["ts"])
            end = start + float(e["dur"])
            if cat in DEVICE_CATS:
                start, end = max(start, w0), min(end, w1)
                if end > start:
                    self.device.append((start, end, _label(e["name"], cat, sources, symbols), cat))
            elif cat in HOST_CATS:
                self.host.append((start, end, e["name"]))
        self.host.sort()
        self._host_starts = [h[0] for h in self.host]
        self.busy = _union([(s, t) for s, t, _, _ in self.device])
        self.busy_s = sum(t - s for s, t in self.busy) / 1e6
        self.w0, self.w1 = w0, w1

    def seconds(self, label: str | None = None, cat: str | None = None) -> float:
        """Device seconds of the events named ``label`` and of category
        ``cat`` (either may be None for any)."""
        return sum(t - s for s, t, name, c in self.device
                   if (label is None or name == label) and (cat is None or c == cat)) / 1e6

    def device_ops(self, top: int = TOP) -> list[list]:
        """The device operations that took most time: [label, seconds]."""
        acc: dict[str, float] = collections.defaultdict(float)
        for s, t, name, _ in self.device:
            acc[name] += (t - s) / 1e6
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]

    def _host_at(self, when: float) -> str:
        """The innermost host event open at ``when``."""
        i = bisect.bisect_right(self._host_starts, when) - 1
        best = None
        for k in range(i, max(-1, i - 50_000), -1):
            start, end, name = self.host[k]
            if end >= when:
                best = name
                break
        if best in (None, WINDOW, CALL):
            return f"{best or 'no host event'} (host between operations)"
        return best

    def idle_gaps(self, top: int = TOP) -> list[list]:
        """The window's idle time by what the host was doing: [label,
        seconds] summed over the gaps, longest first."""
        acc: dict[str, float] = collections.defaultdict(float)
        edge = self.w0
        for s, t in self.busy + [(self.w1, self.w1)]:
            if s > edge:
                acc[self._host_at((edge + s) / 2)] += (s - edge) / 1e6
            edge = max(edge, t)
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]


@contextlib.contextmanager
def profiled(csrc: pathlib.Path, out: dict):
    """Profile the block (host and device) and set ``out["trace"]`` to its
    :class:`Trace`; the Chrome trace is written under ``TMPDIR`` and
    removed once read."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out["trace"] = Trace(events, kernel_sources(csrc))


def idle_pct(run) -> float | None:
    """The share of a traced run's window in which no kernel, copy or memset
    ran on the card (the readers of ``device_idle_pct.*``)."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


class Spans:
    """Host spans around program functions: while active, each function
    named in ``targets`` (span name -> [(module, attribute, sync)]) is
    wrapped so that every call adds its seconds to ``seconds[span]`` and
    appears in the profiler under the span's name; ``sync`` waits for the
    card before the span closes."""

    def __init__(self, targets: dict[str, list]):
        self.targets = targets
        self.seconds: dict[str, list[float]] = {name: [] for name in targets}
        self._saved: list[tuple] = []
        self._lock = threading.Lock()

    def _wrap(self, fn, name: str, sync: bool):
        acc = self.seconds[name]
        lock = self._lock

        def timed(*args, **kw):
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                try:
                    return fn(*args, **kw)
                finally:
                    if sync and torch.cuda.is_available():
                        torch.cuda.synchronize()
                    with lock:
                        acc.append(time.perf_counter() - t0)

        return timed

    def __enter__(self):
        import importlib

        for name, where in self.targets.items():
            for module_name, attr, sync in where:
                module = importlib.import_module(module_name)
                fn = getattr(module, attr)
                self._saved.append((module, attr, fn))
                setattr(module, attr, self._wrap(fn, name, sync))
        return self

    def __exit__(self, *exc):
        for module, attr, fn in reversed(self._saved):
            setattr(module, attr, fn)
        self._saved.clear()
