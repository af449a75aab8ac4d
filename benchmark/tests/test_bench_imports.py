"""Nothing the benchmark runs imports JAX or the JAX package, by top-level
name compared whole (the port's name begins with the JAX package's); the
reference imports nothing of the port. The command fails, printing no
result, where it finds no card."""

import json
import subprocess
import sys

from conftest import BENCH, ROOT, SMALL

from vbench.cell import FORBIDDEN, forbidden_modules


def test_names_are_compared_whole():
    assert forbidden_modules(["versalignlib_tpu_torch", "versalignlib_tpu_torch.ops",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["versalignlib_tpu.ops.oracle", "jax.numpy", "jaxlib", "flax"]) \
        == sorted(FORBIDDEN)


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)


def test_every_module_the_benchmark_loads_leaves_jax_out():
    """Each cell's whole run on the CPU, every reader and entry loaded, in a
    fresh process: no forbidden module in it afterwards."""
    code = (
        "import sys, time, json, glob, pathlib, torch\n"
        f"sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n"
        "from vbench.spec import Spec\n"
        "from vbench.cell import run_cell, forbidden_modules\n"
        "spec = Spec()\n"
        f"small = {SMALL!r}\n"
        "for cell in small:\n"
        "    for traced in (False, True):\n"
        "        run_cell(spec, cell, 1, 0.0, traced, torch.device('cpu'), time.perf_counter(),\n"
        "                 overrides=small[cell])\n"
        "for m in spec.data['end_to_end'] + spec.data['per_layer']:\n"
        "    spec.metric(m['name'])\n"
        "for path in glob.glob(f'{spec.root}/benchmark/vbench/entries/*.py'):\n"
        "    __import__('vbench.entries.' + pathlib.Path(path).stem)\n"
        "import vbench.trace\n"
        "print(json.dumps({'forbidden': forbidden_modules(),\n"
        "                  'port': 'versalignlib_tpu_torch' in sys.modules}))\n")
    got = _python(code)
    assert got.returncode == 0, got.stderr
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert out == {"forbidden": [], "port": True}


def test_the_reference_imports_nothing_of_the_program():
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n"
        "import numpy as np\n"
        "import vbench.reference, vbench.gen, vbench.roofline\n"
        "from vbench import gen, reference\n"
        "r = gen.make_reference(gen.rng_for(1, 2), {'length': 900})\n"
        "reads = gen.make_reads(gen.rng_for(1, 3), {'length': 50, 'sub_rate': 0.01,\n"
        "    'n_rate': 0.02, 'reverse_rate': 0.5}, r, 3)['reads']\n"
        "reference.map_genome(reads, r, 256, 128, reference.Scoring(1, -4, -1, -1, -6, -6))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules}\n"
        "                        & {'versalignlib_tpu_torch', 'versalignlib_tpu', 'jax'})))\n")
    got = _python(code)
    assert got.returncode == 0, got.stderr
    assert json.loads(got.stdout.strip().splitlines()[-1]) == []


def test_the_command_fails_without_a_card_and_prints_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        return
    got = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ref512.score",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert got.returncode != 0 and got.stdout.strip() == ""
    assert "CUDA device" in got.stderr


def test_the_command_fails_where_only_the_benchmark_is(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files has
    no program to run."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    got = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ref512.score",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert got.returncode != 0 and got.stdout.strip() == ""
