"""Run one cell once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the kernels' first build, inputs from the seed, the
program's state, a warm-up call) runs first and is ``setup_s``; then the
entry's calls run for ``--seconds`` in a closed loop; the window ends when
the last call returns. With ``--trace 1`` the same window runs under
``torch.profiler`` with the host spans the cell's per-layer readers ask
for, and the line carries those metrics and a ``breakdown``; with
``--trace 0`` it carries the end-to-end metrics. After the window the
device's peak memory is read, the program's state is freed and the plain
reference judges the answers. Each number compared is printed beside its
limit, last on standard error and last in the line.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

from vbench.spec import ROOT, Spec

#: Top-level modules that no process of the benchmark may hold: JAX and the
#: JAX package that the port was made from (compared whole, since the
#: port's own name begins with the latter's).
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "versalignlib_tpu"})
CSRC = ROOT / "versalignlib_tpu_torch" / "csrc"


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & FORBIDDEN)


@dataclasses.dataclass
class Run:
    """What the metric readers read: the window, the work and, in a traced
    run, the trace and the host spans."""

    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    units: dict
    trace: object = None
    spans: dict = dataclasses.field(default_factory=dict)


def _stop_after(seconds: float, min_calls: int):
    start = time.perf_counter()
    return lambda n: n >= min_calls and time.perf_counter() - start >= seconds


def run_cell(spec: Spec, name: str, seed: int, seconds: float, traced: bool, device,
             t_start: float, overrides: dict | None = None, program=None,
             min_calls: int = 1) -> dict:
    """Set up, time and judge cell ``name``; returns the result's fields.

    ``overrides`` replaces keys of the traffic mix (``"traffic"``) and of
    the configuration's blocks (``"<block>"``), for small runs on the CPU.
    ``program(entry)`` returns the function that answers call k in the
    program's place (the control, and the faults of the tests)."""
    import torch

    from vbench import trace

    t_run = time.perf_counter()
    cell = spec.cell(name)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    for key, value in (overrides or {}).items():
        (traffic if key == "traffic" else cfg.setdefault(key, {})).update(value)
    entry = spec.entry(traffic["entry"])(cfg, traffic, seed, device, cell["chips"])
    entry.setup()
    t_setup = time.perf_counter()
    if program is not None:
        entry.call = program(entry)
    readers = spec.per_layer(name) if traced else spec.end_to_end(name)
    modules = {m["name"]: spec.metric(m["name"]) for m in readers}
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    captured: dict = {}
    targets: dict = {}
    for module in modules.values():
        for span, where in getattr(module, "SPANS", {}).items():
            targets.setdefault(span, [])
            targets[span] += [w for w in where if w not in targets[span]]
    spans = trace.Spans(targets if traced else {})
    t_window = time.perf_counter()
    profiler = trace.profiled(CSRC, captured) if traced and cuda else contextlib.nullcontext()
    with profiler, spans:
        with torch.profiler.record_function(trace.WINDOW) if traced else contextlib.nullcontext():
            records = entry.run(_stop_after(seconds, min_calls), traced)
            if cuda:
                torch.cuda.synchronize(device)
        t_end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    ok = [r for r in records if r.error is None]
    run = Run(cell, cfg, traffic, t_window - t_start, t_end - t_window, entry.units(ok),
              captured.get("trace"), dict(spans.seconds))
    entry.release()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = entry.check(records)
    timing = {"imports_s": t_run - t_start, "entry_setup_s": t_setup - t_run,
              "window_s": t_end - t_window, "check_s": time.perf_counter() - t_check}
    metrics = {}
    for m in readers:
        value = modules[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": all(c.value <= c.limit for c in checks), "attempted": len(records),
           "failed": sum(r.error is not None for r in records), "metrics": metrics,
           "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    out["errors"] = sorted({r.error for r in records if r.error})[:5]
    out["timing"] = timing
    return out


def _power_line() -> str:
    try:
        got = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return got.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def emit(result: dict) -> None:
    """Each number compared beside its limit as the last lines of standard
    error, then the result as the last line of standard output, with the
    numbers compared under ``checks``, its last key."""
    errors = result.pop("errors", [])
    timing = result.pop("timing", {})
    checks = result.pop("checks")
    print("timing " + " ".join(f"{k} {v:.3f}" for k, v in timing.items()), file=sys.stderr)
    for err in errors:
        print(f"error in a call: {err}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    result["checks"] = checks
    print(json.dumps(result), flush=True)


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = Spec()
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_start)
    print(f"card: {_power_line()}; seed {args.seed}; pid {os.getpid()}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"the process holds forbidden modules: {', '.join(bad)}", file=sys.stderr)
        return 3
    emit(result)
    return 0
