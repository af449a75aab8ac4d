"""The port's multi-process layer on the CPU: two processes, spawned with
``jax`` and the JAX package blocked, meet over gloo and run
``scripts/torch_multihost_align.py`` on 23 pairs, each on a 2-shard CPU
mesh. The scores file, the merged alignment shards and the manifest are
held to the single-process engine and to the JAX writers' bytes on the JAX
oracles' results. Every check is ``==``."""

import json
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from versalignlib_tpu import AlignmentEngine as JaxEngine
from versalignlib_tpu.cli import _write_alignments as jax_write_alignments
from versalignlib_tpu.cli import _write_scores as jax_write_scores
from versalignlib_tpu.parallel import multihost as jax_multihost
from versalignlib_tpu.types import Algorithm as JaxAlgorithm
from versalignlib_tpu_torch import AlignmentEngine
from versalignlib_tpu_torch.io.fasta import write_fasta
from versalignlib_tpu_torch.parallel import multihost
from versalignlib_tpu_torch.types import Algorithm

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "torch_multihost_align.py"
#: Runs a script with ``jax`` and the JAX package blocked.
BLOCKED = ("import runpy, sys\n"
           "sys.modules['jax'] = None\n"
           "sys.modules['versalignlib_tpu'] = None\n"
           "sys.argv = sys.argv[1:]\n"
           "runpy.run_path(sys.argv[0], run_name='__main__')\n")
NAMES = {Algorithm.SMITH_WATERMAN: "smith_waterman",
         Algorithm.NEEDLEMAN_WUNSCH: "needleman_wunsch"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _random_seqs(rng, n, lo, hi):
    return ["".join(rng.choice(list("ACGTacgtN"), size=int(rng.integers(lo, hi + 1)),
                               p=[.22, .22, .22, .22, .025, .025, .025, .025, .02]))
            for _ in range(n)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One two-process run of the script, shared by the checks below."""
    rng = np.random.default_rng(11)
    tmp = tmp_path_factory.mktemp("torch_mh")
    b = 23                              # uneven process slices (11 + 12)
    reads = _random_seqs(rng, b, 18, 24)
    refs = _random_seqs(rng, b, 20, 30)
    write_fasta(tmp / "reads.fa", reads)
    write_fasta(tmp / "refs.fa", refs)
    port = _free_port()
    outdir = tmp / "out"
    procs = [subprocess.Popen(
        [sys.executable, "-c", BLOCKED, str(SCRIPT), "--reads", str(tmp / "reads.fa"),
         "--refs", str(tmp / "refs.fa"), "--outdir", str(outdir),
         "--coordinator", f"localhost:{port}", "--num-processes", "2",
         "--process-id", str(i), "--cpu-devices", "2"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    try:
        logs = [p.communicate(timeout=100)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return reads, refs, outdir, logs


@pytest.mark.parametrize("alg", list(Algorithm), ids=lambda a: a.name)
def test_scores_file_equals_the_engine_and_the_jax_writer(run, alg, tmp_path):
    reads, refs, outdir, _ = run
    got = (outdir / f"scores_{NAMES[alg]}.txt").read_text()
    scores = AlignmentEngine(device="cpu").score_alignments(alg, reads, refs)
    want = JaxEngine(backend="oracle").score_alignments(JaxAlgorithm(int(alg)), reads, refs)
    np.testing.assert_array_equal(scores, want)
    jax_write_scores(tmp_path / "want.txt", reads, refs, want)
    assert got == (tmp_path / "want.txt").read_text()


@pytest.mark.parametrize("alg", list(Algorithm), ids=lambda a: a.name)
def test_alignment_shards_merge_to_the_engine_and_the_jax_writer(run, alg, tmp_path):
    reads, refs, outdir, _ = run
    parts = sorted(outdir.glob(f"alignments_{NAMES[alg]}.part*-of002.txt"))
    assert [p.name[-17:] for p in parts] == ["part000-of002.txt", "part001-of002.txt"]
    merged = "".join(p.read_text() for p in parts)
    alns = AlignmentEngine(device="cpu").compute_alignments(alg, reads, refs)
    want = JaxEngine(backend="oracle").compute_alignments(JaxAlgorithm(int(alg)), reads, refs)
    jax_write_alignments(tmp_path / "want.txt", want)
    assert merged == (tmp_path / "want.txt").read_text()
    assert [(a.read, a.ref, a.score, a.cigar) for a in alns] == \
        [(a.read, a.ref, a.score, a.cigar) for a in want]


def test_manifest_tiles_the_batch_over_four_devices(run):
    reads, _, outdir, logs = run
    man = json.loads((outdir / "manifest.json").read_text())
    assert (man["pairs"], man["processes"], man["devices"]) == (len(reads), 2, 4)
    for name in NAMES.values():
        rows = [o["rows"] for o in man["outputs"] if isinstance(o, dict)
                and f"alignments_{name}" in o["file"]]
        assert rows == [[0, 11], [11, 23]]
        assert f"scores_{name}.txt" in man["outputs"]
    assert all("SMITH_WATERMAN: 23 pairs" in log for log in logs)


def test_process_slice_is_the_jax_arithmetic():
    for b in (0, 1, 5, 23, 1000):
        for n in (1, 2, 3, 7):
            got = [multihost.process_slice(b, p, n) for p in range(n)]
            assert got == [jax_multihost.process_slice(b, p, n) for p in range(n)]
            assert got[0][0] == 0 and got[-1][1] == b


def test_initialize_takes_an_explicit_backend(monkeypatch):
    import torch

    with pytest.raises(ValueError, match="backend"):
        multihost.initialize("localhost:1", 1, 0, backend="mpi")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="nccl"):
        multihost.initialize("localhost:1", 1, 0)


def test_local_mesh_deals_the_cards_among_torchrun_processes(monkeypatch):
    """Under ``torchrun`` each process's mesh is its own share of the
    node's cards (local rank r of L takes cards r, r + L, ...), so that no
    two NCCL ranks hold one card; without ``LOCAL_RANK`` it is every card
    the process sees. More processes than cards share them, under gloo
    only."""
    import torch

    cuda = [torch.device("cuda", i) for i in range(8)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert multihost.local_mesh().devices == tuple(cuda)
    assert multihost.local_mesh(2, device="cpu").devices == (torch.device("cpu"),) * 2
    for local, meshes in ((8, [(c,) for c in cuda]), (4, [(cuda[r], cuda[r + 4])
                                                          for r in range(4)]),
                          (1, [tuple(cuda)])):
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local))
        for rank, want in enumerate(meshes):
            monkeypatch.setenv("LOCAL_RANK", str(rank))
            assert multihost.local_mesh().devices == want
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert multihost.local_mesh(1).devices == (cuda[3],)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert multihost.local_mesh().devices == (cuda[1],)
    with pytest.raises(ValueError, match="share 2 card"):
        multihost.initialize("localhost:1", 4, 3, backend="nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.local_mesh()
