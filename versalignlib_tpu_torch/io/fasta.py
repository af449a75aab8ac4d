"""FASTA parsing with the reference's record semantics (the port's copy of
``versalignlib_tpu/io/fasta.py``).

Mirrors the reference's ``FastaProvider::parse_fasta``
(src/util/versalignUtil.h:47-99):

- records start at ``>`` headers; sequence lines concatenate;
- a sequence line containing a space DISCARDS the whole record (the
  reference clears name+content and ignores the rest until the next header);
- an empty line terminates the current record (the reference flushes and
  clears the name, so later lines are ignored).

Deliberate divergence: the reference's ``getline().good()`` loop drops the
final line of a file with no trailing newline; we parse it (documented
reference bug, SURVEY.md appendix-adjacent).
"""

from __future__ import annotations

import io
import pathlib
from typing import Iterable


def parse_fasta(path: str | pathlib.Path | io.TextIOBase) -> list[str]:
    """Parse a FASTA file -> list of sequences (headers discarded, like the
    reference, which returns only the char* sequences)."""
    if isinstance(path, io.TextIOBase):
        lines = path.read().splitlines()
    else:
        with open(path, "r") as f:
            lines = f.read().splitlines()

    values: list[str] = []
    name = ""
    content: list[str] = []
    for line in lines:
        if not line or line[0] == ">":
            if name:
                values.append("".join(content))
                name = ""
            if line:
                name = line[1:]
            content = []
        elif name:
            if " " in line:
                # Reference behavior: a space invalidates the record.
                name = ""
                content = []
            else:
                content.append(line)
    if name:
        values.append("".join(content))
    return values


def parse_fasta_with_names(path) -> list[tuple[str, str]]:
    """Like :func:`parse_fasta` but keeps the header names."""
    if isinstance(path, io.TextIOBase):
        lines = path.read().splitlines()
    else:
        with open(path, "r") as f:
            lines = f.read().splitlines()
    out: list[tuple[str, str]] = []
    name = ""
    content: list[str] = []
    for line in lines:
        if not line or line[0] == ">":
            if name:
                out.append((name, "".join(content)))
                name = ""
            if line:
                name = line[1:]
            content = []
        elif name:
            if " " in line:
                name = ""
                content = []
            else:
                content.append(line)
    if name:
        out.append((name, "".join(content)))
    return out


def iter_fasta(path: str | pathlib.Path | io.TextIOBase):
    """Stream sequences one record at a time (same record semantics as
    :func:`parse_fasta`, O(record) memory — for 10M+-record ingestion where
    whole-file reads don't fit)."""
    f = path if isinstance(path, io.TextIOBase) else open(path, "r")
    try:
        name = ""
        content: list[str] = []
        for line in f:
            # \r\n-tolerant like parse_fasta's splitlines() (matters for
            # caller-supplied streams; file opens already translate CRLF).
            line = line.rstrip("\r\n")
            if not line or line[0] == ">":
                if name:
                    yield "".join(content)
                    name = ""
                if line:
                    name = line[1:]
                content = []
            elif name:
                if " " in line:
                    name = ""
                    content = []
                else:
                    content.append(line)
        if name:
            yield "".join(content)
    finally:
        if not isinstance(path, io.TextIOBase):
            f.close()


def iter_fasta_chunks(path, chunk_records: int = 100_000):
    """Yield lists of up to ``chunk_records`` sequences — the streaming
    front-end for chunked pipelines (scripts/bulk_align.py, checkpointed
    runs): memory stays O(chunk) regardless of file size."""
    batch: list[str] = []
    for seq in iter_fasta(path):
        batch.append(seq)
        if len(batch) >= chunk_records:
            yield batch
            batch = []
    if batch:
        yield batch


def write_fasta(path, sequences: Iterable[str], names: Iterable[str] | None = None,
                width: int = 80) -> None:
    """Write sequences as FASTA (default names seq0, seq1, ...)."""
    seqs = list(sequences)
    if names is None:
        names = [f"seq{i}" for i in range(len(seqs))]
    with open(path, "w") as f:
        for name, seq in zip(names, seqs):
            f.write(f">{name}\n")
            for off in range(0, len(seq), width):
                f.write(seq[off : off + width] + "\n")
