"""BENCHMARK.json, and finding a cell, a configuration, a traffic mix and a
metric by name; a new cell needs new files and entries only."""

import json
import shutil
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

from vbench.spec import Spec, problems


def test_benchmark_json_keeps_the_rules():
    assert problems(Spec()) == []


def test_finds_each_part_by_name():
    spec = Spec()
    cell = spec.cell("illumina150.genome")
    assert spec.config(cell["config"])["scoring"]["gap_open_read"] == -6
    assert spec.traffic(cell["traffic"])["entry"] == "map_to_reference"
    assert spec.entry("map_to_reference").__module__ == "vbench.entries.map_to_reference"
    assert hasattr(spec.metric("device_idle_pct.map"), "read")
    assert [m["name"] for m in spec.end_to_end("ref512.score")] == \
        ["score_gcups", "setup_s"]
    assert {m["name"] for m in spec.per_layer("ref512.score")} == \
        {"b1_roofline_pct", "h2d_ms_per_call", "device_idle_pct.score"}
    with pytest.raises(KeyError):
        spec.cell("no.such.cell")


def test_every_per_layer_metric_names_a_layer_and_an_end_to_end_metric():
    d = Spec().data
    moves = {m["name"] for m in d["end_to_end"]}
    for m in d["per_layer"]:
        assert m["moves"] in moves and "\n" not in m["layer"]


def test_a_new_cell_needs_only_new_files_and_entries(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    metric and a cell by new files and entries alone, and runs the cell."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "ref512_dna.json").read_text())
    cfg.update(name="ref64_dna", pairs={"pad_to": 64, "length_min": 8, "length_max": 64,
                                        "n_rate": 0.0, "sub_rate": 0.1})
    (tmp_path / "benchmark" / "configs" / "ref64_dna.json").write_text(json.dumps(cfg))
    (tmp_path / "benchmark" / "traffic" / "tiny.json").write_text(json.dumps(
        {"entry": "score_alignments", "pairs_per_call": 8, "pool": 3}))
    (tmp_path / "benchmark" / "metrics" / "pairs_per_call.py").write_text(
        "def read(run):\n    return run.units['pairs'] / run.units['calls']\n")
    data["configs"].append({"name": "ref64_dna", "source": "test", "file":
                            "benchmark/configs/ref64_dna.json", "reduced": [], "why": "test"})
    data["workloads"].append({"name": "ref64.tiny", "config": "ref64_dna", "traffic": "tiny",
                              "chips": 1, "why": "test"})
    data["end_to_end"][0]["workloads"].append("ref64.tiny")
    data["per_layer"].append({"name": "pairs_per_call", "unit": "pairs", "better": "higher",
                              "source": "program_counter", "layer": "test",
                              "moves": "score_gcups", "workloads": ["ref64.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    script = (
        "import sys, time, json, torch\n"
        f"sys.path[:0] = [{str(tmp_path / 'benchmark')!r}, {str(ROOT)!r}]\n"
        "from vbench.spec import Spec, problems\n"
        "from vbench.cell import run_cell\n"
        f"spec = Spec({str(tmp_path)!r})\n"
        "assert problems(spec) == [], problems(spec)\n"
        "for traced in (False, True):\n"
        "    out = run_cell(spec, 'ref64.tiny', 3, 0.2, traced, torch.device('cpu'),\n"
        "                   time.perf_counter())\n"
        "    print(json.dumps(out))\n")
    got = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300)
    assert got.returncode == 0, got.stderr
    plain, traced = (json.loads(line) for line in got.stdout.strip().splitlines()[-2:])
    assert plain["correct"] and set(plain["metrics"]) == {"score_gcups", "setup_s"}
    assert traced["correct"] and traced["metrics"] == {"pairs_per_call":
                                                       {"value": 8.0, "unit": "pairs"}}
