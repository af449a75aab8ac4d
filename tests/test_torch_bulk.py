"""The port's bulk pipelines (``scripts/torch_bulk_map.py``,
``scripts/torch_bulk_align.py``) on the CPU against the JAX package: the
mapping table equals the JAX ``map_reads(backend="oracle")``, the SAM
records equal the JAX ``write_sam`` records, the scores and alignments
equal the JAX oracles, the synthetic chunks are the JAX scripts' chunks, a
resume after a kill gives the same bytes, and the JAX checkpoint classes
read what the scripts wrote. The JAX scripts themselves are not run: they
would run Pallas kernels in interpret mode."""

import io
import json
import pathlib

import numpy as np
import pytest
import torch

from chip_smoke import load_script
from versalignlib_tpu import map_reads as jax_map_reads
from versalignlib_tpu.alphabet import reverse_complement as jax_rc
from versalignlib_tpu.io.fasta import write_fasta
from versalignlib_tpu.io.fastq import write_fastq
from versalignlib_tpu.io.sam import write_sam as jax_write_sam
from versalignlib_tpu.ops import oracle as jax_oracle
from versalignlib_tpu.params import AlignmentParameters as JaxParams
from versalignlib_tpu.types import Algorithm as JaxAlgorithm
from versalignlib_tpu.utils.checkpoint import ScoreCheckpoint as JaxScoreCheckpoint
from versalignlib_tpu.utils.checkpoint import TableCheckpoint as JaxTableCheckpoint

bulk_map = load_script("torch_bulk_map")
bulk_align = load_script("torch_bulk_align")
jax_bulk_map = load_script("bulk_map")
jax_bulk_align = load_script("bulk_align")


def _drop_chunk(ckpt: pathlib.Path, chunk: int) -> None:
    """A kill after ``chunk`` was written but before it was journaled."""
    journal = ckpt / "done.jsonl"
    lines = [json.loads(x) for x in journal.read_text().splitlines()]
    journal.write_text("\n".join(json.dumps(e) for e in lines if e["chunk"] != chunk) + "\n")


def _files(d: pathlib.Path, names) -> dict:
    return {n: (d / n).read_bytes() for n in names}


@pytest.fixture
def map_inputs(tmp_path, rng):
    """The inputs of tests/test_io_models_utils.py::test_bulk_map_pipeline_resumes."""
    bases = np.array(list("ACGT"))
    panel = ["".join(rng.choice(bases, size=40)) for _ in range(3)]
    reads = [panel[i % 3][5:30] for i in range(10)]
    reads[4] = jax_rc(reads[4])
    write_fasta(tmp_path / "panel.fa", panel)
    write_fastq(tmp_path / "reads.fastq", reads)
    return tmp_path, reads, panel


def test_bulk_map_table_equals_jax_and_resumes(map_inputs):
    d, reads, panel = map_inputs
    ck = d / "ckpt"
    argv = ["--reads", str(d / "reads.fastq"), "--panel", str(d / "panel.fa"),
            "--ckpt", str(ck), "--chunk", "4", "--device", "cpu"]
    assert bulk_map.main(argv) == 0
    table = np.load(ck / "table.npy")
    want = jax_map_reads(reads, panel, backend="oracle", align=False)
    np.testing.assert_array_equal(table, np.stack(
        [want.index, want.score, want.strand, want.mapq], axis=1).astype(np.int64))
    hits = (ck / "hits.tsv").read_text().splitlines()
    assert hits[0] == "read\thit_index\tscore\tstrand\tmapq"
    assert len(hits) == 11 and hits[5].startswith("read4\t")
    assert hits[5] == "read4\t" + "\t".join(str(v) for v in table[4])
    before = _files(ck, ("table.npy", "hits.tsv", "meta.json"))
    # Kill and resume: chunk 2 was written but not journaled; it runs again.
    np.load(ck / "table.npy", mmap_mode="r+")[8:] = -7
    _drop_chunk(ck, 2)
    assert bulk_map.main(argv) == 0
    assert _files(ck, before) == before
    # The JAX checkpoint reads the directory as complete, with the same rows.
    jck = JaxTableCheckpoint(ck, total=10, chunk=4, width=4, columns=bulk_map.COLUMNS,
                             fingerprint=json.loads((ck / "meta.json").read_text())["fingerprint"])
    assert jck.is_complete() and np.array_equal(jck.table(), table)


def test_bulk_map_sam_equals_jax_write_sam_and_resumes(map_inputs):
    d, reads, panel = map_inputs
    ck = d / "ckpt_sam"
    argv = ["--reads", str(d / "reads.fastq"), "--panel", str(d / "panel.fa"),
            "--ckpt", str(ck), "--chunk", "4", "--sam", "--device", "cpu"]
    assert bulk_map.main(argv) == 0
    sam = (ck / "alignments.sam").read_text()
    header = [line for line in sam.splitlines() if line.startswith("@")]
    assert header == ["@HD\tVN:1.6\tSO:unknown"] + [
        f"@SQ\tSN:seq{j}\tLN:40" for j in range(3)] + [
        "@PG\tID:versalignlib_tpu\tPN:versalignlib_tpu"]
    recs = [line for line in sam.splitlines() if not line.startswith("@")]
    direct = jax_map_reads(reads, panel, backend="oracle")
    oriented = [jax_rc(r) if s else r for r, s in zip(reads, direct.strand)]
    buf = io.StringIO()
    jax_write_sam(buf, direct.alignments, oriented, [panel[j] for j in direct.index],
                  read_names=[f"read{i}" for i in range(10)],
                  ref_names=[f"seq{j}" for j in direct.index],
                  strands=direct.strand, mapqs=direct.mapq)
    want = [line for line in buf.getvalue().splitlines() if not line.startswith("@")]
    assert recs == want and len(recs) == 10
    before = _files(ck, ("alignments.sam", "table.npy", "hits.tsv"))
    (ck / "sam_000001.part").write_text("stale\n")
    _drop_chunk(ck, 1)
    assert bulk_map.main(argv) == 0
    assert _files(ck, before) == before


def test_bulk_map_synthetic_reads_are_the_jax_scripts(tmp_path):
    from versalignlib_tpu_torch.alphabet import pad_and_encode

    rng = np.random.default_rng(4)
    panel = ["".join(rng.choice(list("ACGT"), size=int(n))) for n in (60, 52, 64, 58)]
    write_fasta(tmp_path / "panel.fa", panel)
    enc = pad_and_encode(panel)
    for c, n in ((0, 16), (3, 5)):
        np.testing.assert_array_equal(bulk_map.synthetic_chunk(9, c, n, enc),
                                      jax_bulk_map.synthetic_chunk(9, c, n, enc))
    ck = tmp_path / "syn"
    assert bulk_map.main(["--synthetic", "37", "--seed", "9", "--panel",
                          str(tmp_path / "panel.fa"), "--ckpt", str(ck), "--chunk", "16",
                          "--algorithm", "nw", "--single-strand", "--device", "cpu"]) == 0
    reads = np.concatenate([jax_bulk_map.synthetic_chunk(9, c, n, enc)
                            for c, n in ((0, 16), (1, 16), (2, 5))])
    want = jax_map_reads(reads, enc, algorithm=JaxAlgorithm.NEEDLEMAN_WUNSCH,
                         backend="oracle", align=False, both_strands=False)
    np.testing.assert_array_equal(np.load(ck / "table.npy"), np.stack(
        [want.index, want.score, want.strand, want.mapq], axis=1).astype(np.int64))


def _jax_chunks(seed, total, chunk, length):
    return [jax_bulk_align.synthetic_chunk(seed, c, min(chunk, total - lo), length)
            for c, lo in enumerate(range(0, total, chunk))]


@pytest.mark.parametrize("algorithm", ["sw", "nw"])
def test_bulk_align_scores_equal_jax_and_resume(tmp_path, algorithm):
    jalg = JaxAlgorithm.SMITH_WATERMAN if algorithm == "sw" else JaxAlgorithm.NEEDLEMAN_WUNSCH
    base = ["--pairs", "40", "--len", "24", "--chunk", "16", "--seed", "5",
            "--algorithm", algorithm, "--device", "cpu"]
    chunks = _jax_chunks(5, 40, 16, 24)
    for (r, f), (pr, pf) in zip(chunks, [bulk_align.synthetic_chunk(5, c, len(r), 24)
                                         for c, (r, _) in enumerate(chunks)]):
        assert np.array_equal(r, pr) and np.array_equal(f, pf)
    want = np.concatenate([jax_oracle.score_alignments(jalg, r, f, JaxParams())
                           for r, f in chunks]).astype(np.int32)
    staged, pageable = tmp_path / "staged", tmp_path / "pageable"
    assert bulk_align.main(base + ["--ckpt", str(staged)]) == 0
    assert bulk_align.main(base + ["--ckpt", str(pageable), "--no-prefetch"]) == 0
    np.testing.assert_array_equal(np.load(staged / "scores.npy"), want)
    before = _files(staged, ("scores.npy", "meta.json"))
    assert _files(pageable, before) == before
    np.load(staged / "scores.npy", mmap_mode="r+")[16:32] = -1
    _drop_chunk(staged, 1)
    assert bulk_align.main(base + ["--ckpt", str(staged)]) == 0
    assert _files(staged, before) == before
    jck = JaxScoreCheckpoint(staged, total=40, chunk=16)
    assert jck.is_complete() and np.array_equal(jck.scores(), want)


def test_bulk_align_alignments_equal_jax_and_resume(tmp_path):
    from versalignlib_tpu.types import TieBreak as JaxTieBreak

    base = ["--pairs", "20", "--len", "18", "--chunk", "8", "--seed", "2", "--mode", "align",
            "--device", "cpu"]
    ck = tmp_path / "align"
    assert bulk_align.main(base + ["--ckpt", str(ck)]) == 0
    chunks = _jax_chunks(2, 20, 8, 18)
    names = [f"alignments_{c:06d}.txt" for c in range(len(chunks))]
    scores = []
    for name, (r, f) in zip(names, chunks):
        alns = jax_oracle.compute_alignments(JaxAlgorithm.SMITH_WATERMAN, r, f, JaxParams(),
                                             JaxTieBreak.DIAG_UP_LEFT)
        assert (ck / name).read_text() == "".join(
            f"{a.read}\n{a.ref}\n{a.cigar}\t{a.score}\n" for a in alns)
        scores += [a.score for a in alns]
    np.testing.assert_array_equal(np.load(ck / "scores.npy"), scores)
    before = _files(ck, names + ["scores.npy"])
    (ck / names[1]).write_text("")
    _drop_chunk(ck, 1)
    assert bulk_align.main(base + ["--ckpt", str(ck)]) == 0
    assert _files(ck, before) == before


def test_bulk_scripts_need_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch, map_inputs):
    d, _, _ = map_inputs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bulk_align.main(["--pairs", "4", "--ckpt", str(tmp_path / "a")])
    with pytest.raises(RuntimeError, match="CUDA"):
        bulk_map.main(["--reads", str(d / "reads.fastq"), "--panel", str(d / "panel.fa"),
                       "--ckpt", str(tmp_path / "m")])
    assert not (tmp_path / "a").exists() and not (tmp_path / "m").exists()
