"""The port's command line against the JAX package's: every mode of
``chip_smoke.CLI_MODES``, on the same seeded FASTA/FASTQ inputs
(``chip_smoke.write_cli_inputs``), writes the same bytes (``--device cpu``
on the port's side, ``--backend oracle`` on the JAX side). Where the JAX
CLI would reach a Pallas kernel in interpret mode (``--band``, ``--long``,
the winners' alignment of ``--translated``), it runs that kernel's plain
reference instead, the definition its own tests hold the kernel to: the
JAX package's dense oracles, and the port's copies of its banded oracles
(each call's first pair held == the JAX package's). Also: the ``oracle`` backend against the JAX package's, and
the CLI's refusals."""

import contextlib
import dataclasses
import io
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import versalignlib_tpu.cli as jax_cli
from chip_smoke import CLI_MODES, cli_args, write_cli_inputs
from versalignlib_tpu.dispatch import get_backend as jax_get_backend
from versalignlib_tpu.ops import banded as jax_banded
from versalignlib_tpu.ops import gotoh as jax_gotoh
from versalignlib_tpu.ops import oracle as jax_oracle
from versalignlib_tpu.ops import pallas_align as jax_pallas_align
from versalignlib_tpu.params import AlignmentParameters as JaxParams
from versalignlib_tpu.types import Algorithm as JaxAlgorithm
from versalignlib_tpu.types import TieBreak as JaxTieBreak
from versalignlib_tpu_torch import AlignmentEngine, AlignmentParameters, cli, dispatch
from versalignlib_tpu_torch.alphabet import blosum62
from versalignlib_tpu_torch.models.base import AlignmentModel
from versalignlib_tpu_torch.ops.banded import banded_align_oracle, banded_score_oracle
from versalignlib_tpu_torch.types import Algorithm, TieBreak

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_inputs")
    write_cli_inputs(d, np.random.default_rng(0))
    return d


def _banded_score_oracle(reads, refs, params, algorithm, band=512, tile=256, interpret=None):
    """The port's ``banded_score_oracle`` over the batch; its first pair
    also == the JAX package's."""
    band = min(band, refs.shape[1])
    out = np.array([banded_score_oracle(r, f, params, band, algorithm)
                    for r, f in zip(reads, refs)], dtype=np.int32)
    assert out[0] == jax_banded.banded_score_oracle(reads[0], refs[0], params, band, algorithm)
    return out


def _banded_align_oracle(reads, refs, params, algorithm, band=512, tile=64, interpret=None,
                         raw=False, chunk_blocks=None, tie=None, device_walk=None):
    """The port's ``banded_align_oracle`` over the batch; its first pair
    also == the JAX package's."""
    band = min(band, refs.shape[1])
    out = [banded_align_oracle(r, f, params, band, algorithm, tie=tie)
           for r, f in zip(reads, refs)]
    assert dataclasses.asdict(out[0]) == dataclasses.asdict(
        jax_banded.banded_align_oracle(reads[0], refs[0], params, band, algorithm, tie=tie))
    return out


def _dense_align_oracle(reads, refs, params, algorithm, tie=JaxTieBreak.DIAG_UP_LEFT,
                        interpret=None, read_texts=None, ref_texts=None, **_):
    sw = JaxAlgorithm(algorithm) == JaxAlgorithm.SMITH_WATERMAN
    fn = ((jax_gotoh.sw_align_affine if sw else jax_gotoh.nw_align_affine) if params.affine
          else (jax_oracle.sw_align if sw else jax_oracle.nw_align))
    m, n = reads.shape[1], refs.shape[1]
    texts = zip(read_texts or [None] * len(reads), ref_texts or [None] * len(refs))
    return [fn(r, f, params, tie, rt and rt.ljust(m, "\0"), ft and ft.ljust(n, "\0"))
            for r, f, (rt, ft) in zip(reads, refs, texts)]


def _run(main, args):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = main(args)
    return rc, out.getvalue()


@pytest.mark.parametrize("mode", CLI_MODES)
def test_cli_mode_writes_the_jax_bytes(mode, inputs, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_banded, "banded_score_batch", _banded_score_oracle)
    monkeypatch.setattr(jax_banded, "banded_align_batch", _banded_align_oracle)
    monkeypatch.setattr(jax_pallas_align, "pallas_align_batch", _dense_align_oracle)
    args = cli_args(CLI_MODES[mode], inputs)
    want_dir, got_dir = tmp_path / "jax", tmp_path / "port"
    jax_args = args if "--backend" in args else args + ["--backend", "oracle"]
    assert _run(jax_cli.main, jax_args + ["--outdir", str(want_dir)])[0] == 0
    rc, out = _run(cli.main, args + ["--outdir", str(got_dir), "--device", "cpu"])
    assert rc == 0, out
    want = sorted(p.name for p in want_dir.iterdir())
    assert sorted(p.name for p in got_dir.iterdir()) == want
    assert len(want) >= 1 + (mode != "pssm" and mode != "translated")
    for name in want:
        assert (got_dir / name).read_bytes() == (want_dir / name).read_bytes(), name


def test_cli_bench_table_times_each_backend_on_the_device(tmp_path):
    rc, out = _run(cli.main, ["--selftest", "--bench", "--device", "cpu",
                              "--outdir", str(tmp_path)])
    assert rc == 0
    rows = [line.split("\t") for line in out.splitlines() if line.count("\t") == 3]
    assert rows[0] == ["backend", "mode", "seconds/call", "GCUPS"]
    assert [r[:2] for r in rows[1:]] == [["oracle", "score"], ["oracle", "align"],
                                         ["cuda", "score"], ["cuda", "align"]]
    assert all(float(r[2]) > 0 for r in rows[1:])


def test_cli_without_a_card_fails(tmp_path, monkeypatch):
    """No card and no ``--device cpu``: the engine's RuntimeError, no file
    written, and a non-zero exit from ``python -m``."""
    code = ("import sys, runpy, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            f"sys.argv = ['versalignlib_tpu_torch', '--selftest', '--outdir', {str(tmp_path)!r}]\n"
            "runpy.run_module('versalignlib_tpu_torch', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=ROOT)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--backend", "oracle"], ["--band", "16"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--selftest", "--outdir", str(tmp_path)] + extra)
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("args", [
    ["--selftest", "--bam"],
    ["--selftest", "--backend", "nope"],
    ["--selftest", "--panel", "p.fa", "--band", "8"],
    ["--selftest", "--window", "128"],
    ["--pssm-from", "m.fa"],
    ["--translated", "--reads", "r.fa", "--panel", "p.fa", "--sam"],
])
def test_cli_refuses_what_the_jax_cli_refuses(args, tmp_path):
    for main, extra in ((jax_cli.main, []), (cli.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
            main(args + ["--outdir", str(tmp_path)] + extra)


@pytest.mark.parametrize("args", [["--backend", "pallas", "--device", "cpu"],
                                  ["--backend", "xla", "--device", "cpu"],
                                  ["--device", "tpu"]])
def test_cli_refuses_backends_and_devices_the_port_lacks(args, tmp_path):
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        cli.main(["--selftest", "--outdir", str(tmp_path)] + args)
    assert list(tmp_path.iterdir()) == []


_PARAM_SETS = {
    "linear": AlignmentParameters(),
    "affine": AlignmentParameters(score_gap_read=-1, score_gap_ref=-1, gap_open_read=-4,
                                  gap_open_ref=-4),
    "blosum62_affine": AlignmentParameters(score_gap_read=-1, score_gap_ref=-1,
                                           gap_open_read=-11, gap_open_ref=-11,
                                           matrix=blosum62()),
}


@pytest.mark.parametrize("pset", _PARAM_SETS)
@pytest.mark.parametrize("algorithm", list(Algorithm))
def test_oracle_backend_matches_jax(pset, algorithm):
    params = _PARAM_SETS[pset]
    rng = np.random.default_rng(int(algorithm) * 7 + len(pset))
    hi = 6 if params.matrix is None else 24
    reads = rng.integers(0, hi, size=(12, 20)).astype(np.uint8)
    refs = rng.integers(0, hi, size=(12, 27)).astype(np.uint8)
    reads[0] = 0
    reads[1, 10:] = 0
    jp = JaxParams(**dataclasses.asdict(params))
    jalg = JaxAlgorithm(int(algorithm))
    want_backend = jax_get_backend("oracle")
    engine = AlignmentEngine(params, backend="oracle", device="cpu")
    assert engine.backend.name == "oracle"
    np.testing.assert_array_equal(engine.score_alignments(algorithm, reads, refs),
                                  want_backend.score_alignments(jalg, reads, refs, jp))
    for tie in TieBreak:
        engine = AlignmentEngine(params, backend="oracle", tie=tie, device="cpu")
        got = engine.compute_alignments(algorithm, reads, refs)
        want = want_backend.compute_alignments(jalg, reads, refs, jp, JaxTieBreak(int(tie)))
        assert [vars(a) for a in got] == [vars(a) for a in want]
        assert got == AlignmentEngine(params, tie=tie, device="cpu").compute_alignments(
            algorithm, reads, refs)


def test_oracle_backend_refusals():
    assert dispatch.available_backends("cpu") == ["oracle", "cuda"]
    reads = np.ones((2, 5), np.uint8)
    with pytest.raises(ValueError, match="cuda backend"):
        AlignmentEngine(backend="oracle", device="cpu").compute_alignments(
            Algorithm.SMITH_WATERMAN, reads, reads, raw=True)
    # The engine passes device_walk to the cuda backend only.
    alns = AlignmentEngine(backend="oracle", device="cpu", device_walk=True).compute_alignments(
        Algorithm.SMITH_WATERMAN, reads, reads)
    assert [a.cigar for a in alns] == ["5M", "5M"]
    model = AlignmentModel("m", Algorithm.SMITH_WATERMAN, device_walk=False)
    with pytest.raises(ValueError, match="device_walk"):
        model.align(reads, reads, backend="oracle", device="cpu")
    assert (AlignmentModel("m", Algorithm.SMITH_WATERMAN).align(
        reads, reads, backend="oracle", device="cpu") == alns)
