"""Whole runs of each cell on the CPU at small sizes: the result line, the
numbers compared, and that the reference agrees with the port's CPU
path."""

import io
import json
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch
from conftest import SMALL

from vbench.cell import emit, run_cell
from vbench.spec import Spec

CELLS = sorted(SMALL)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_agrees_with_the_reference(cell):
    out = run_cell(Spec(), cell, 2 ** 31 + 11, 0.3, False, torch.device("cpu"),
                   time.perf_counter(), overrides=SMALL[cell])
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in Spec().end_to_end(cell)}
    assert all(c["value"] == 0 and c["limit"] == 0 for c in out["checks"].values())


def test_the_result_line_and_the_checks_come_last():
    out = run_cell(Spec(), "ref512.score", 5, 0.2, False, torch.device("cpu"),
                   time.perf_counter(), overrides=SMALL["ref512.score"])
    stdout, stderr = io.StringIO(), io.StringIO()
    with redirect_stdout(stdout), redirect_stderr(stderr):
        emit(out)
    line = json.loads(stdout.getvalue().strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for value in line["metrics"].values():
        assert set(value) == {"value", "unit"}
    tail = stderr.getvalue().strip().splitlines()[-len(line["checks"]):]
    assert tail == [f"check {k} {v['value']} limit {v['limit']}"
                    for k, v in line["checks"].items()]


def test_traced_mapping_run_reads_the_align_path_span():
    out = run_cell(Spec(), "illumina150.genome", 9, 0.2, True, torch.device("cpu"),
                   time.perf_counter(), overrides=SMALL["illumina150.genome"])
    assert out["correct"]
    # On the CPU there is no trace and no replay of walk records: only the
    # align path's span has something to read.
    assert set(out["metrics"]) == {"align_path_ms_per_call"}
    assert "breakdown" not in out


def test_same_seed_same_answers_and_work():
    runs = [run_cell(Spec(), "illumina150.genome", 77, 0.0, False, torch.device("cpu"),
                     time.perf_counter(), overrides=SMALL["illumina150.genome"], min_calls=2)
            for _ in range(2)]
    assert runs[0]["attempted"] == runs[1]["attempted"] == 2
    assert runs[0]["checks"] == runs[1]["checks"]
