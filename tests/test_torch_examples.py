"""Every example of ``examples/torch/`` runs on the CPU (``--device cpu``)
in a subprocess with ``jax`` and the JAX package blocked, and prints what it
should: something, and never ``MISS``, with no kernel launched.
``chip_smoke.phase_examples`` runs them on the card and holds the card's
output to this one."""

import pathlib

import pytest

from chip_smoke import example_launches, example_scripts, run_example

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = example_scripts()


def test_every_jax_example_but_the_multichip_one_has_a_twin():
    jax_examples = sorted(p.name for p in (ROOT / "examples").glob("*.py"))
    assert [p.name for p in EXAMPLES] == jax_examples
    assert all(p.parent == ROOT / "examples" / "torch" for p in EXAMPLES)


@pytest.mark.parametrize("script", EXAMPLES, ids=lambda p: p.name)
def test_example_runs_on_the_cpu_without_jax(script):
    out = run_example(script, "cpu", timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip(), "examples should print something"
    assert "MISS" not in out.stdout
    assert not any(example_launches(out).values()), "the CPU path launches no kernel"
