"""Rules of the port: it imports neither JAX nor the JAX package, its entry
points run on the card or raise, and what it has not ported raises instead
of computing something else, while what it has ported computes."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from versalignlib_tpu_torch import AlignmentEngine, AlignmentParameters
from versalignlib_tpu_torch.ops import _build, cuda_align, cuda_score, plain
from versalignlib_tpu_torch.params import DEFAULT_PARAMETERS
from versalignlib_tpu_torch.types import Algorithm, TieBreak

ROOT = pathlib.Path(__file__).resolve().parent.parent
_FORBIDDEN = {"jax", "jaxlib", "versalignlib_tpu"}


def _port_sources():
    files = sorted((ROOT / "versalignlib_tpu_torch").rglob("*.py"))
    return files + sorted((ROOT / "scripts").glob("torch_*.py")) + [ROOT / "chip_smoke.py"]


def test_no_jax_imports_anywhere_in_the_port():
    offenders = []
    files = _port_sources()
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in _FORBIDDEN:
                    offenders.append(f"{path.relative_to(ROOT)}:{node.lineno} {name}")
    assert not offenders, offenders


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['versalignlib_tpu'] = None\n"
        "import versalignlib_tpu_torch, versalignlib_tpu_torch.dispatch\n"
        "from versalignlib_tpu_torch.ops import cuda_backend, cuda_align, cuda_score, plain\n"
        "from versalignlib_tpu_torch.ops import cuda_search, gotoh, oracle, pssm\n"
        "from versalignlib_tpu_torch import refmap, search, stats, translate\n"
        "from versalignlib_tpu_torch.utils import capabilities, logging\n"
        "from versalignlib_tpu_torch import native\n"
        "from versalignlib_tpu_torch.ops import banded, cuda_banded, plain_banded\n"
        "from versalignlib_tpu_torch import longread, models, seed\n"
        "import chip_smoke\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_engine_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        AlignmentEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        AlignmentEngine(backend="auto", device="cuda:0")
    assert AlignmentEngine(device="cpu").backend.name == "cuda"


def test_chip_smoke_refuses_to_run_without_a_card():
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['chip_smoke.py']\n"
            "import chip_smoke\n"
            "sys.exit(chip_smoke.main())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "kernels" not in out.stdout


_AFFINE = AlignmentParameters(gap_open_read=-4, gap_open_ref=-4)
_MATRIX = AlignmentParameters(matrix=((0, 0, 0), (0, 1, -1), (0, -1, 1)))


def test_cuda_tensors_launch_or_raise_never_the_plain_version(monkeypatch):
    calls = []
    for name in ("score_batch", "align_batch", "align_affine_batch"):
        monkeypatch.setattr(plain, name, lambda *a: calls.append(a))
    reads = np.ones((2, 5), np.uint8)
    refs = np.ones((2, 6), np.uint8)
    cuda = torch.device("cuda")
    if not torch.cuda.is_available():
        for p in (DEFAULT_PARAMETERS, _AFFINE, _MATRIX):
            with pytest.raises((RuntimeError, AssertionError)):
                cuda_score.CudaScorer(cuda)(reads, refs, p, Algorithm.SMITH_WATERMAN)
            with pytest.raises((RuntimeError, AssertionError)):
                cuda_align.align_batch(reads, refs, p, Algorithm.SMITH_WATERMAN,
                                       device=cuda)
    assert calls == []


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    kernel = _build.CudaKernel("score.cu", "val_score_launch", [])
    with pytest.raises(RuntimeError, match="nvcc"):
        kernel.launch()
    assert kernel.launches == 0


def test_unported_modes_raise():
    """The device walk (ROADMAP A5), ported since as the affine and matrix
    parameters were, gives what the host walk gives; affine and matrix
    parameters compute what the JAX oracles compute."""
    import dataclasses

    from versalignlib_tpu.ops import gotoh, oracle
    from versalignlib_tpu.params import AlignmentParameters as JaxParams
    from versalignlib_tpu.types import Algorithm as JaxAlgorithm
    from versalignlib_tpu.types import TieBreak as JaxTieBreak

    reads = np.ones((2, 5), np.uint8)
    refs = np.ones((2, 6), np.uint8)
    for alg in Algorithm:
        walked = AlignmentEngine(device="cpu", device_walk=True).compute_alignments(
            alg, reads, refs)
        assert walked == AlignmentEngine(device="cpu", device_walk=False).compute_alignments(
            alg, reads, refs)
    reads = np.array([[1, 2, 1, 2, 0], [2, 2, 1, 1, 1]], np.uint8)
    refs = np.array([[2, 1, 2, 1, 1, 0], [1, 1, 2, 2, 1, 2]], np.uint8)
    for p, score, align in ((_AFFINE, gotoh.score_alignments_affine,
                             gotoh.compute_alignments_affine),
                            (_MATRIX, oracle.score_alignments,
                             oracle.compute_alignments)):
        jp = JaxParams(**dataclasses.asdict(p))
        for alg in Algorithm:
            jalg = JaxAlgorithm(int(alg))
            np.testing.assert_array_equal(
                AlignmentEngine(p, device="cpu").score_alignments(alg, reads, refs),
                score(jalg, reads, refs, jp))
            for tie in TieBreak:
                got = AlignmentEngine(p, tie=tie, device="cpu").compute_alignments(
                    alg, reads, refs, raw=True)
                want = align(jalg, reads, refs, jp, JaxTieBreak(int(tie)))
                np.testing.assert_array_equal(got.scores, [a.score for a in want])


def test_registry():
    from versalignlib_tpu_torch import dispatch

    assert dispatch.available_backends("cpu") == ["cuda"]
    assert dispatch.get_backend("auto", "cpu").name == "cuda"
    with pytest.raises(KeyError):
        dispatch.get_backend("pallas", "cpu")


def _search_entry_points(device):
    """Each search entry point of the port, called on ``device`` with tiny
    inputs."""
    from versalignlib_tpu_torch import (calibrate, map_read_pairs, map_reads,
                                        map_to_reference, profile_search, score_matrix,
                                        translated_search)
    from versalignlib_tpu_torch.ops.pssm import calibrate_profile
    from versalignlib_tpu_torch.search import best_hits

    reads = np.ones((3, 5), np.uint8)
    panel = np.ones((4, 6), np.uint8)
    table = np.zeros((3, 6), np.int32)
    table[:, 1] = 2
    return {
        "score_matrix": lambda: score_matrix(reads, panel, device=device),
        "best_hits": lambda: best_hits(reads, panel, device=device),
        "map_reads": lambda: map_reads(reads, panel, device=device),
        "map_read_pairs": lambda: map_read_pairs(reads, reads, panel, device=device),
        "map_to_reference": lambda: map_to_reference(reads, [np.ones(40, np.uint8)],
                                                     device=device),
        "profile_search": lambda: profile_search(table, panel, device=device),
        "calibrate_profile": lambda: calibrate_profile(table, samples=8, n=6, device=device),
        "translated_search": lambda: translated_search(["ACGTTTGCA"], ["MKV"], device=device),
        "calibrate": lambda: calibrate(DEFAULT_PARAMETERS, m=6, n=6, samples=8, device=device),
    }


def test_search_entry_points_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, call in _search_entry_points("cuda").items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    for name, call in _search_entry_points("cpu").items():
        call()


def test_search_kernel_launches_or_raises_never_the_plain_version(monkeypatch):
    """A tensor that is not on the CPU never reaches the plain versions: on
    the card the kernel launches; elsewhere (no card, or another device) the
    call raises."""
    from versalignlib_tpu_torch.ops import cuda_search

    calls = []
    for name in ("cross_scores", "profile_scores"):
        monkeypatch.setattr(plain, name, lambda *a: calls.append(a))
    reads = torch.ones((3, 5), dtype=torch.uint8)
    refs = torch.ones((4, 6), dtype=torch.uint8)
    table = torch.zeros((2, 3, 6), dtype=torch.int32)
    sw = Algorithm.SMITH_WATERMAN
    if torch.cuda.is_available():
        before = cuda_search.SEARCH_KERNEL.launches
        cuda_search.cross_scores_device(reads.cuda(), refs.cuda(), DEFAULT_PARAMETERS, sw)
        cuda_search.pssm_scores_device(table.cuda(), refs.cuda(), DEFAULT_PARAMETERS, sw, True)
        assert cuda_search.SEARCH_KERNEL.launches == before + 2
    else:
        meta = torch.device("meta")
        with pytest.raises(ValueError, match="device"):
            cuda_search.cross_scores_device(reads.to(meta), refs.to(meta), DEFAULT_PARAMETERS, sw)
        with pytest.raises(ValueError, match="device"):
            cuda_search.pssm_scores_device(table.to(meta), refs.to(meta), DEFAULT_PARAMETERS, sw)
        # Past the device gate, the entry points reach the card or raise.
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        for name, call in _search_entry_points("cuda").items():
            with pytest.raises((RuntimeError, AssertionError)):
                call()
    assert calls == []


def test_banded_paths_need_a_card_and_launch_or_raise(monkeypatch):
    """The banded entry points run on the card or raise without one; a
    tensor that is not on the CPU never reaches the plain banded versions."""
    from versalignlib_tpu_torch import (banded_align_batch, banded_score_batch,
                                        map_long_reads, models)
    from versalignlib_tpu_torch.ops import cuda_banded, plain_banded

    calls = []
    for name in ("banded_score", "banded_fill"):
        monkeypatch.setattr(plain_banded, name, lambda *a: calls.append(a))
    reads = np.ones((2, 20), np.uint8)
    refs = np.ones((2, 24), np.uint8)
    sw = Algorithm.SMITH_WATERMAN
    entry_points = {
        "banded_score_batch": lambda: banded_score_batch(reads, refs, DEFAULT_PARAMETERS, sw),
        "banded_align_batch": lambda: banded_align_batch(reads, refs, DEFAULT_PARAMETERS, sw),
        "model.score": lambda: models.banded_smith_waterman(band=8).score(reads, refs),
        "model.align": lambda: models.banded_needleman_wunsch(band=8).align(reads, refs),
        "map_long_reads": lambda: map_long_reads(["ACGT" * 20], ["ACGT" * 40]),
    }
    if torch.cuda.is_available():
        before = cuda_banded.BANDED_SCORE_KERNEL.launches
        entry_points["banded_score_batch"]()
        assert cuda_banded.BANDED_SCORE_KERNEL.launches == before + 1
    else:
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "is_available", lambda: False)
            for name, call in entry_points.items():
                with pytest.raises(RuntimeError, match="CUDA"):
                    call()
        meta = torch.device("meta")
        r, f = torch.from_numpy(reads).to(meta), torch.from_numpy(refs).to(meta)
        for p in (DEFAULT_PARAMETERS, _AFFINE, _MATRIX):
            with pytest.raises(ValueError, match="device"):
                cuda_banded.score(r, f, np.zeros(20, np.int32), p, sw, 8)
        # Past the device gate, the entry points reach the card or raise.
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "is_available", lambda: True)
            for name in ("banded_score_batch", "banded_align_batch", "model.score"):
                with pytest.raises((RuntimeError, AssertionError)):
                    entry_points[name]()
    assert calls == []
