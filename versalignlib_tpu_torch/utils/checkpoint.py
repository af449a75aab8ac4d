"""Streaming checkpoint/resume for huge batch runs (the port's counterpart of
``versalignlib_tpu/utils/checkpoint.py``, with the same files on disk, so
that a directory one package wrote resumes in the other).

The reference has nothing resumable: results stream to text files from its
example program (main.cpp:133-155) and a crash loses everything. Here results land in
a memmapped array (``scores.npy`` or ``table.npy``), chunk completion is
journaled (``done.jsonl``), the run's shape is recorded (``meta.json``), and
a resume skips finished chunks. A chunk is journaled only after its results
are flushed, so a crash leaves no journaled chunk unwritten.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

from versalignlib_tpu_torch.utils.logging import get_logger

_log = get_logger("checkpoint")


def _open_memmap(path: pathlib.Path, dtype, shape) -> np.memmap:
    return np.lib.format.open_memmap(path, mode="r+" if path.exists() else "w+",
                                     dtype=dtype, shape=shape)


def _journal(path: pathlib.Path, chunk_index: int, lo: int, n: int) -> None:
    with open(path, "a") as f:
        f.write(json.dumps({"chunk": chunk_index, "lo": lo, "n": n}) + "\n")


@dataclasses.dataclass
class ScoreCheckpoint:
    """Chunked score-run state rooted at ``directory``."""

    directory: pathlib.Path
    total: int
    chunk: int

    def __post_init__(self) -> None:
        self.directory = pathlib.Path(self.directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        meta_path = self.directory / "meta.json"
        if meta_path.exists():
            meta = json.loads(meta_path.read_text())
            if meta["total"] != self.total or meta["chunk"] != self.chunk:
                raise ValueError(
                    f"checkpoint {self.directory} was created with "
                    f"total={meta['total']} chunk={meta['chunk']}; refusing "
                    f"to resume with total={self.total} chunk={self.chunk}"
                )
        else:
            meta_path.write_text(json.dumps({"total": self.total, "chunk": self.chunk}))
        self._scores = _open_memmap(self.directory / "scores.npy", np.int32, (self.total,))
        self._journal = self.directory / "done.jsonl"

    def done_chunks(self) -> set[int]:
        if not self._journal.exists():
            return set()
        done = set()
        for line in self._journal.read_text().splitlines():
            if line.strip():
                done.add(json.loads(line)["chunk"])
        return done

    def pending_chunks(self) -> list[tuple[int, int, int]]:
        """[(chunk_index, lo, hi)] not yet completed."""
        done = self.done_chunks()
        n_chunks = -(-self.total // self.chunk)
        return [(c, c * self.chunk, min((c + 1) * self.chunk, self.total))
                for c in range(n_chunks) if c not in done]

    def commit(self, chunk_index: int, lo: int, scores: np.ndarray) -> None:
        """Write one chunk's scores, flush them, then journal the chunk."""
        self._scores[lo : lo + scores.shape[0]] = scores
        self._scores.flush()
        _journal(self._journal, chunk_index, lo, int(scores.shape[0]))

    def scores(self) -> np.ndarray:
        return np.asarray(self._scores)

    def is_complete(self) -> bool:
        return not self.pending_chunks()


@dataclasses.dataclass
class TableCheckpoint:
    """Journaled memmapped (total, width) int64 result table.

    The mapping pipeline's form of :class:`ScoreCheckpoint`: each input row
    gives ``width`` integers (e.g. hit index, score, strand, MAPQ),
    committed a chunk at a time with the same flush-then-journal order.
    """

    directory: pathlib.Path
    total: int
    chunk: int
    width: int
    columns: tuple[str, ...] = ()
    #: identity of the INPUT data (path + size + mtime, seed, ...): a resume
    #: against other inputs would mix stale and fresh rows, so a mismatch
    #: is refused. Empty disables the check.
    fingerprint: str = ""

    def __post_init__(self) -> None:
        self.directory = pathlib.Path(self.directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        meta_path = self.directory / "meta.json"
        meta = {"total": self.total, "chunk": self.chunk,
                "width": self.width, "columns": list(self.columns),
                "fingerprint": self.fingerprint}
        if meta_path.exists():
            old = json.loads(meta_path.read_text())
            old.setdefault("fingerprint", "")
            if old != meta:
                raise ValueError(
                    f"checkpoint {self.directory} was created with {old}; "
                    f"refusing to resume with {meta}")
        else:
            meta_path.write_text(json.dumps(meta))
        self._table = _open_memmap(self.directory / "table.npy", np.int64,
                                   (self.total, self.width))
        self._journal = self.directory / "done.jsonl"

    done_chunks = ScoreCheckpoint.done_chunks
    pending_chunks = ScoreCheckpoint.pending_chunks
    is_complete = ScoreCheckpoint.is_complete

    def commit(self, chunk_index: int, lo: int, rows: np.ndarray) -> None:
        """Write one chunk's rows, flush them, then journal the chunk."""
        self._table[lo : lo + rows.shape[0]] = rows
        self._table.flush()
        _journal(self._journal, chunk_index, lo, int(rows.shape[0]))

    def table(self) -> np.ndarray:
        return np.asarray(self._table)


def run_scored_batch(
    checkpoint_dir,
    reads: np.ndarray,
    refs: np.ndarray,
    score_fn,
    chunk: int = 65536,
) -> np.ndarray:
    """Score a huge batch with resume-on-restart.

    ``score_fn(reads_chunk, refs_chunk) -> (n,) int32``. Chunks completed by
    an earlier run are skipped.
    """
    ckpt = ScoreCheckpoint(checkpoint_dir, total=reads.shape[0], chunk=chunk)
    pending = ckpt.pending_chunks()
    if not pending:
        _log.info("checkpoint complete; returning stored scores")
        return ckpt.scores()
    _log.info("resuming: %d/%d chunks pending", len(pending),
              -(-reads.shape[0] // chunk))
    for c, lo, hi in pending:
        ckpt.commit(c, lo, np.asarray(score_fn(reads[lo:hi], refs[lo:hi]), dtype=np.int32))
    return ckpt.scores()
