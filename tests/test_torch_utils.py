"""The port's utilities against the JAX package's: ``debug.dump_matrices``
and ``format_matrix`` (linear and affine, both variants, both tie
families), the checkpoints (a directory written by one package resumes in
the other, to the same arrays), ``run_scored_batch``, and the timers."""

import dataclasses
import json
import time

import numpy as np
import pytest

from versalignlib_tpu import debug as jax_debug
from versalignlib_tpu.params import AlignmentParameters as JaxParams
from versalignlib_tpu.types import Algorithm as JaxAlgorithm
from versalignlib_tpu.types import TieBreak as JaxTieBreak
from versalignlib_tpu.utils import checkpoint as jax_checkpoint
from versalignlib_tpu.utils import timers as jax_timers
from versalignlib_tpu_torch import debug
from versalignlib_tpu_torch.alphabet import encode
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm, TieBreak
from versalignlib_tpu_torch.utils import checkpoint, timers

_PARAMS = {
    "linear": AlignmentParameters(),
    "affine": AlignmentParameters(gap_open_read=-4, gap_open_ref=-5, score_gap_read=-1,
                                  score_gap_ref=-2),
    "linear_nondefault": AlignmentParameters(score_match=3, score_mismatch=-2,
                                             score_gap_read=-2, score_gap_ref=-4),
}
_PAIRS = (("ACGT", "ACGT"), ("ACGTTGCANNA", "TTACGATGCAAC"), ("GATTACA", "GCATGCT"),
          ("AAAA", "TTTTTTTT"), ("N", "ACG"))


@pytest.mark.parametrize("gaps", sorted(_PARAMS))
@pytest.mark.parametrize("algorithm", list(Algorithm), ids=lambda a: a.name)
def test_dump_matrices_equal_jax(gaps, algorithm):
    p = _PARAMS[gaps]
    jp = JaxParams(**dataclasses.asdict(p))
    for read, ref in _PAIRS:
        for variant in ("traceback", "score"):
            for tie in TieBreak:
                got = debug.dump_matrices(encode(read), encode(ref), p, algorithm, tie, variant)
                want = jax_debug.dump_matrices(encode(read), encode(ref), jp,
                                               JaxAlgorithm(int(algorithm)),
                                               JaxTieBreak(int(tie)), variant)
                assert len(got) == len(want) == (4 if p.affine else 2)
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)
                assert debug.format_matrix(got[0], got[-1]) == \
                    jax_debug.format_matrix(want[0], want[-1])
                assert debug.format_matrix(got[0], width=7) == \
                    jax_debug.format_matrix(want[0], width=7)


def test_dump_matrices_reads_as_the_reference_debug_log():
    h, ptr = debug.dump_matrices(encode("ACGT"), encode("ACGT"), AlignmentParameters(),
                                 Algorithm.SMITH_WATERMAN)
    assert h.shape == (5, 5) and int(h[4, 4]) == 8
    text = debug.format_matrix(h, ptr)
    assert "\\" in text and text.count("\n") == 4


def _packages():
    return {"port": checkpoint, "jax": jax_checkpoint}


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_score_checkpoint_resumes_across_packages(tmp_path, writer, reader):
    w, r = _packages()[writer], _packages()[reader]
    d = tmp_path / "scores"
    ck = w.ScoreCheckpoint(d, total=23, chunk=5)
    want = np.arange(23, dtype=np.int32) * 3 - 7
    for c, lo, hi in ck.pending_chunks():
        if c != 2:  # chunk 2 never committed: a kill
            ck.commit(c, lo, want[lo:hi])
    other = r.ScoreCheckpoint(d, total=23, chunk=5)
    assert other.pending_chunks() == [(2, 10, 15)] == ck.pending_chunks()
    other.commit(2, 10, want[10:15])
    assert other.is_complete()
    np.testing.assert_array_equal(other.scores(), want)
    np.testing.assert_array_equal(w.ScoreCheckpoint(d, total=23, chunk=5).scores(), want)
    assert sorted(p.name for p in d.iterdir()) == ["done.jsonl", "meta.json", "scores.npy"]
    with pytest.raises(ValueError, match="refusing"):
        r.ScoreCheckpoint(d, total=24, chunk=5)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_table_checkpoint_resumes_across_packages(tmp_path, writer, reader):
    w, r = _packages()[writer], _packages()[reader]
    d = tmp_path / "table"
    kw = dict(total=11, chunk=4, width=3, columns=("a", "b", "c"), fingerprint="in:1")
    ck = w.TableCheckpoint(d, **kw)
    want = np.arange(33, dtype=np.int64).reshape(11, 3) - 5
    for c, lo, hi in ck.pending_chunks():
        if c != 1:
            ck.commit(c, lo, want[lo:hi])
    other = r.TableCheckpoint(d, **kw)
    assert [c for c, _, _ in other.pending_chunks()] == [1]
    other.commit(1, 4, want[4:8])
    assert other.is_complete()
    np.testing.assert_array_equal(other.table(), want)
    np.testing.assert_array_equal(w.TableCheckpoint(d, **kw).table(), want)
    assert json.loads((d / "meta.json").read_text()) == {
        "total": 11, "chunk": 4, "width": 3, "columns": ["a", "b", "c"],
        "fingerprint": "in:1"}
    with pytest.raises(ValueError, match="refusing"):
        r.TableCheckpoint(d, **{**kw, "fingerprint": "other"})
    with pytest.raises(ValueError, match="refusing"):
        r.TableCheckpoint(d, **{**kw, "width": 2})


def test_table_checkpoint_reads_a_meta_without_fingerprint(tmp_path):
    d = tmp_path / "old"
    d.mkdir()
    (d / "meta.json").write_text(json.dumps({"total": 4, "chunk": 2, "width": 1,
                                             "columns": []}))
    assert checkpoint.TableCheckpoint(d, total=4, chunk=2, width=1).pending_chunks() == [
        (0, 0, 2), (1, 2, 4)]


def test_run_scored_batch_resumes(tmp_path, rng):
    from versalignlib_tpu_torch.ops import oracle

    reads = rng.integers(1, 5, size=(25, 12)).astype(np.uint8)
    refs = rng.integers(1, 5, size=(25, 15)).astype(np.uint8)
    calls = []

    def score_fn(r, f):
        calls.append(r.shape[0])
        return oracle.score_alignments(Algorithm.SMITH_WATERMAN, r, f, AlignmentParameters())

    want = oracle.score_alignments(Algorithm.SMITH_WATERMAN, reads, refs, AlignmentParameters())
    out = checkpoint.run_scored_batch(tmp_path / "ck", reads, refs, score_fn, chunk=10)
    np.testing.assert_array_equal(out, want)
    assert calls == [10, 10, 5]
    calls.clear()
    np.testing.assert_array_equal(
        checkpoint.run_scored_batch(tmp_path / "ck", reads, refs, score_fn, chunk=10), want)
    assert calls == []
    journal = tmp_path / "ck" / "done.jsonl"
    entries = [json.loads(x) for x in journal.read_text().splitlines()]
    assert entries == [{"chunk": c, "lo": 10 * c, "n": n} for c, n in ((0, 10), (1, 10), (2, 5))]
    journal.write_text("\n".join(json.dumps(e) for e in entries if e["chunk"] != 1) + "\n")
    np.testing.assert_array_equal(
        checkpoint.run_scored_batch(tmp_path / "ck", reads, refs, score_fn, chunk=10), want)
    assert calls == [10]
    # The JAX function resumes the port's directory to the same scores.
    np.testing.assert_array_equal(
        jax_checkpoint.run_scored_batch(tmp_path / "ck", reads, refs, score_fn, chunk=10), want)
    assert calls == [10]


def test_timer_and_bench_result():
    t = timers.Timer()
    t.start()
    time.sleep(0.01)
    assert t.elapsed_seconds() >= 0.01  # while running
    t.stop()
    stopped = t.elapsed_seconds()
    assert stopped >= 0.01 and t.elapsed_seconds() == stopped
    assert t.elapsed_micros() == pytest.approx(stopped * 1e6)
    r = timers.BenchResult(seconds_per_call=0.5, cells_per_call=4_000_000_000,
                           pairs_per_call=1000)
    j = jax_timers.BenchResult(seconds_per_call=0.5, cells_per_call=4_000_000_000,
                               pairs_per_call=1000)
    assert (r.gcups, r.pairs_per_second) == (j.gcups, j.pairs_per_second) == (8.0, 2000.0)
    calls, synced = [], []
    res = timers.time_batched_call(lambda: calls.append(1) or len(calls), cells_per_call=10,
                                   pairs_per_call=2, warmup=2, iters=5, sync=synced.append)
    assert len(calls) == 7 and synced == [1, 2, 3, 4, 5, 6, 7]
    assert res.seconds_per_call > 0 and res.cells_per_call == 10 and res.pairs_per_call == 2
    assert [f.name for f in dataclasses.fields(timers.BenchResult)] == \
        [f.name for f in dataclasses.fields(jax_timers.BenchResult)]
