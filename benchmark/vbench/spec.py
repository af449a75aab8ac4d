"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The configuration's file is the one its entry names; a traffic mix is
``traffic/<name>.json`` beside this package; the traffic names the entry
point it drives, ``vbench/entries/<entry>.py``; every metric is read by
``metrics/<name>.py``. Adding a cell, a configuration, a traffic mix or a
metric therefore adds files and entries and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent.parent
ROOT = HERE.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def _module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Spec:
    """The benchmark as ``BENCHMARK.json`` at ``root`` describes it."""

    def __init__(self, root: pathlib.Path = ROOT):
        self.root = pathlib.Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def _named(self, key: str, name: str) -> dict:
        for item in self.data[key]:
            if item["name"] == name:
                return item
        raise KeyError(f"no {key} entry named {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, name: str) -> dict:
        return json.loads((self.root / self._named("configs", name)["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((HERE / "traffic" / f"{name}.json").read_text())

    def entry(self, name: str):
        """The class ``Entry`` of ``vbench/entries/<name>.py``."""
        return importlib.import_module(f"vbench.entries.{name}").Entry

    def metric(self, name: str):
        """The reader module of ``metrics/<name>.py``: ``read(run)`` and,
        where it reads host spans, ``SPANS``."""
        return _module(HERE / "metrics" / f"{name}.py", f"vbench_metric_{name}")

    def end_to_end(self, cell: str) -> list[dict]:
        """The end-to-end metrics ``cell`` reports."""
        return [m for m in self.data["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics ``cell`` reports in its traced run."""
        return [m for m in self.data["per_layer"] if cell in m["workloads"]]


def problems(spec: Spec) -> list[str]:
    """Where ``BENCHMARK.json`` and its files break the benchmark's rules
    that can be read from the files alone."""
    d = spec.data
    out = []
    if set(d) != TOP_KEYS:
        out.append(f"top-level keys {sorted(d)}")
    names = {}
    for key, keys in (("configs", CONFIG_KEYS), ("workloads", CELL_KEYS),
                      ("end_to_end", E2E_KEYS), ("per_layer", LAYER_KEYS)):
        for item in d[key]:
            optional = {"workloads"} if key == "end_to_end" else set()
            if not keys <= set(item) <= keys | optional:
                out.append(f"{key} {item.get('name')}: keys {sorted(item)}")
            if not NAME.fullmatch(str(item.get("name", ""))):
                out.append(f"{key}: bad name {item.get('name')!r}")
            group = "metric" if key in ("end_to_end", "per_layer") else key
            if (group, item["name"]) in names:
                out.append(f"{key}: {item['name']} twice")
            names[(group, item["name"])] = item
            if "unit" in item and not UNIT.fullmatch(item["unit"]):
                out.append(f"{item['name']}: bad unit {item['unit']!r}")
            if item.get("better", "lower") not in ("lower", "higher"):
                out.append(f"{item['name']}: better {item['better']!r}")
    cells = {c["name"]: c for c in d["workloads"]}
    configs = {c["name"] for c in d["configs"]}
    used = {c["config"] for c in cells.values()}
    if configs != used:
        out.append(f"configs without a cell: {sorted(configs - used)}")
    for c in cells.values():
        if c["config"] not in configs:
            out.append(f"{c['name']}: no configuration {c['config']}")
        if not (HERE / "traffic" / f"{c['traffic']}.json").exists():
            out.append(f"{c['name']}: no traffic file {c['traffic']}")
        if c["chips"] not in (1, 4):
            out.append(f"{c['name']}: chips {c['chips']}")
        e2e = spec.end_to_end(c["name"])
        if "setup_s" not in {m["name"] for m in e2e} or len(e2e) < 2:
            out.append(f"{c['name']}: end-to-end metrics {[m['name'] for m in e2e]}")
        if not spec.per_layer(c["name"]):
            out.append(f"{c['name']}: no per-layer metric")
    e2e_names = {m["name"]: m for m in d["end_to_end"]}
    for m in d["end_to_end"]:
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"{m['name']}: source {m['source']}")
        if not 0 < m["bound"] <= 0.25:
            out.append(f"{m['name']}: bound {m['bound']}")
    for m in d["per_layer"]:
        if m["source"] not in ("device_trace", "program_span", "program_counter", "host_clock"):
            out.append(f"{m['name']}: source {m['source']}")
        if m["moves"] not in e2e_names:
            out.append(f"{m['name']}: moves {m['moves']}, no such metric")
        for cell in m["workloads"]:
            if cell not in cells or m["moves"] not in {x["name"] for x in spec.end_to_end(cell)}:
                out.append(f"{m['name']}: cell {cell} does not report {m['moves']}")
    for m in d["end_to_end"] + d["per_layer"]:
        if not (HERE / "metrics" / f"{m['name']}.py").exists():
            out.append(f"{m['name']}: no reader")
    if "setup_s" not in e2e_names:
        out.append("no setup_s")
    return out
