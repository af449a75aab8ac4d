"""Host traceback decoder, FASTA parser and SAM formatter (C++), built with
g++ at first use and loaded with ctypes.

The port's copy of the loader, ``decode_batch_native``,
``decode_banded_native``, ``replay_records_native``, ``parse_fasta_codes``
and ``format_sam_native`` of ``versalignlib_tpu/native``. The decoder has no
Python fallback: a failed build raises, because the decoder is on the
alignment path. :func:`available` reports whether the library loads, for the
callers that keep a Python path (``io/sam.py::write_sam_batch``).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

from versalignlib_tpu_torch.types import Algorithm, Alignment, AlignmentBatch

_DIR = pathlib.Path(__file__).parent
_SO = _DIR / "_versalign_native.so"
_SRC = sorted((_DIR / "src").glob("*.cpp"))
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _build() -> None:
    # Build to a temporary name and rename, so that processes building at
    # the same time never load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_DIR)
    os.close(fd)
    try:
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
               "-o", tmp, *[str(s) for s in _SRC]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"native decoder build failed ({' '.join(cmd)}):\n{proc.stderr}")
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs_mtime = max(s.stat().st_mtime for s in _SRC)
        if not _SO.exists() or _SO.stat().st_mtime < srcs_mtime:
            _build()
        lib = ctypes.CDLL(str(_SO))
        lib.val_decode_batch.restype = ctypes.c_int
        lib.val_decode_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,      # ptr, kind, pack
            ctypes.c_void_p, ctypes.c_void_p,                 # reads, refs
            ctypes.c_char_p, ctypes.c_char_p,                 # texts
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # starts, scores
            ctypes.c_int, ctypes.c_int, ctypes.c_int,         # b, m, n
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # scoring
            ctypes.c_int, ctypes.c_int,                       # is_nw, is_affine
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out bufs
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int,      # cigar_cap, meta, threads
        ]
        lib.val_decode_banded.restype = ctypes.c_int
        lib.val_decode_banded.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,      # words, band, win
            ctypes.c_void_p, ctypes.c_void_p,                 # offsets, wbase
            ctypes.c_void_p, ctypes.c_void_p,                 # reads, refs
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # starts, scores
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # b, m_rows, m, n
            ctypes.c_int,                                     # is_affine
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out bufs
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int,      # cigar_cap, meta, threads
        ]
        lib.val_fasta_scan.restype = ctypes.c_int
        lib.val_fasta_scan.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.val_fasta_read.restype = ctypes.c_int
        lib.val_fasta_read.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p,
        ]
        lib.val_format_sam.restype = ctypes.c_int64
        lib.val_format_sam.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,   # gapped, aln_cap
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,   # cigar, cap, meta
            ctypes.c_char_p, ctypes.c_void_p,                 # seqs, offsets
            ctypes.c_char_p, ctypes.c_void_p,                 # quals, offsets
            ctypes.c_char_p, ctypes.c_void_p,                 # qnames, offsets
            ctypes.c_char_p, ctypes.c_void_p,                 # rnames, offsets
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # flags x2, mapq
            ctypes.c_int,                                     # b
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out, caps, lens
            ctypes.c_int,                                     # threads
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library builds and loads here; never raises."""
    try:
        _load()
    except (OSError, RuntimeError):
        return False
    return True


def decode_batch_native(
    ptr,  # (words (b, m, nc) int32, pack) tuple of packed codes
    reads: np.ndarray,
    refs: np.ndarray,
    start_read_pos: np.ndarray,
    start_ref_pos: np.ndarray,
    params,
    algorithm,
    scores: np.ndarray | None = None,
    read_texts: list[str] | None = None,
    ref_texts: list[str] | None = None,
    n_threads: int | None = None,
    affine: bool = False,
    raw: bool = False,
    gapped: bool = True,
):
    """Batch traceback decode of packed pointer words through the C++
    walker: 2-bit linear move codes, or with ``affine=True`` 4-bit Gotoh
    codes (``hptr | e_ext<<2 | f_ext<<3``) walked by the three-state
    machine of ``gotoh._affine_traceback``.

    ``raw=True`` returns an :class:`AlignmentBatch` column store instead of a
    list of :class:`Alignment` objects; ``gapped=False`` (raw only) skips the
    gapped-string columns.
    """
    words, pack = ptr
    ptr_arr = np.ascontiguousarray(words, dtype=np.int32)
    b, m = np.shape(reads)
    n = np.shape(refs)[1]
    if ptr_arr.shape != (b, m, -(-n // pack)):
        raise ValueError(f"pointer words {ptr_arr.shape} do not match "
                         f"{b} pairs of {m}x{n} at {pack} codes per word")
    return _decode(ptr_arr, 1, pack, reads, refs, start_read_pos, start_ref_pos, params,
                   algorithm, scores, read_texts, ref_texts, n_threads, affine, raw, gapped)


def _decode(ptr_arr, kind, pack, reads, refs, start_read_pos, start_ref_pos, params,
            algorithm, scores, read_texts, ref_texts, n_threads, affine, raw, gapped):
    """One ``val_decode_batch`` call over pointer data of ``kind`` (1 packed
    words, 2 walk records), already checked against the pairs' shape."""
    lib = _load()
    reads = np.ascontiguousarray(reads, dtype=np.uint8)
    refs = np.ascontiguousarray(refs, dtype=np.uint8)
    b, m = reads.shape
    n = refs.shape[1]
    start_r = np.ascontiguousarray(start_read_pos, dtype=np.int32)
    start_f = np.ascontiguousarray(start_ref_pos, dtype=np.int32)
    scores_arr = (
        None if scores is None else np.ascontiguousarray(scores, dtype=np.int32)
    )

    rt_buf = ft_buf = None
    if read_texts is not None:
        rt_buf = b"".join(
            t.encode("latin-1").ljust(m, b"\0")[:m] for t in read_texts
        )
    if ref_texts is not None:
        ft_buf = b"".join(
            t.encode("latin-1").ljust(n, b"\0")[:n] for t in ref_texts
        )

    if not gapped and not raw:
        raise ValueError("gapped=False requires raw=True (Alignment objects "
                         "carry gapped strings)")
    aln_cap = m + n
    cigar_cap = 3 * aln_cap + 16
    read_g = np.zeros((b, aln_cap), dtype=np.uint8) if gapped else None
    ref_g = np.zeros((b, aln_cap), dtype=np.uint8) if gapped else None
    cigar = np.zeros((b, cigar_cap), dtype=np.uint8)
    meta = np.zeros((b, 8), dtype=np.int32)

    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 8)

    rc = lib.val_decode_batch(
        ptr_arr.ctypes.data_as(ctypes.c_void_p), kind, pack,
        reads.ctypes.data_as(ctypes.c_void_p), refs.ctypes.data_as(ctypes.c_void_p),
        rt_buf, ft_buf,
        start_r.ctypes.data_as(ctypes.c_void_p),
        start_f.ctypes.data_as(ctypes.c_void_p),
        None if scores_arr is None else scores_arr.ctypes.data_as(ctypes.c_void_p),
        b, m, n,
        params.score_match, params.score_mismatch,
        params.score_gap_read, params.score_gap_ref,
        1 if Algorithm(algorithm) == Algorithm.NEEDLEMAN_WUNSCH else 0,
        1 if affine else 0,
        None if read_g is None else read_g.ctypes.data_as(ctypes.c_void_p),
        None if ref_g is None else ref_g.ctypes.data_as(ctypes.c_void_p),
        cigar.ctypes.data_as(ctypes.c_void_p),
        cigar_cap,
        meta.ctypes.data_as(ctypes.c_void_p),
        n_threads,
    )
    if rc != 0:
        raise RuntimeError(f"val_decode_batch failed: {rc}")
    return _results(read_g, ref_g, cigar, meta, raw)


def replay_records_native(
    records: np.ndarray,  # (b, m) int32 walk records (ops/walk.py)
    reads: np.ndarray,
    refs: np.ndarray,
    start_read_pos: np.ndarray,
    start_ref_pos: np.ndarray,
    scores: np.ndarray,
    params,
    algorithm,
    read_texts: list[str] | None = None,
    ref_texts: list[str] | None = None,
    raw: bool = False,
    gapped: bool = True,
    n_threads: int | None = None,
):
    """Replay the traceback walks' row records (``ops/walk.py``: one
    ``left_count*4 | exit_code`` int32 per read row) through the C++ walker,
    the counterpart of ``versalignlib_tpu.native.replay_records_native``.
    Same outputs as :func:`decode_batch_native` on the pointer words the
    records were walked from, for every gap model and for the banded walks
    too: records carry no Gotoh state, so they always take the decoder's
    linear records mode (kind 2; its affine walker has no records mode).
    """
    records = np.ascontiguousarray(records, dtype=np.int32)
    b, m = np.shape(reads)
    if records.shape != (b, m):
        raise ValueError(f"walk records {records.shape} do not match {b} pairs of "
                         f"{m} read rows")
    return _decode(records, 2, 16, reads, refs, start_read_pos, start_ref_pos, params,
                   algorithm, scores, read_texts, ref_texts, n_threads, False, raw, gapped)


def _results(read_g, ref_g, cigar, meta, raw: bool):
    """The decoder's columns as an :class:`AlignmentBatch` (``raw``) or a
    list of :class:`Alignment`."""
    if raw:
        return AlignmentBatch(read_g, ref_g, cigar, meta)
    b, aln_cap = read_g.shape
    cigar_cap = cigar.shape[1]
    out = []
    rg_bytes = read_g.tobytes()
    fg_bytes = ref_g.tobytes()
    cg_bytes = cigar.tobytes()
    for k in range(b):
        (score, rs, re_, fs, fe, aln_len, buf_start, clen) = (int(x) for x in meta[k])
        base = k * aln_cap
        cb = k * cigar_cap
        out.append(
            Alignment(
                read=rg_bytes[base : base + aln_len].decode("latin-1"),
                ref=fg_bytes[base : base + aln_len].decode("latin-1"),
                score=score,
                cigar=cg_bytes[cb : cb + clen].decode("ascii"),
                read_start=rs,
                read_end=re_,
                ref_start=fs,
                ref_end=fe,
                buffer_start=buf_start,
                buffer_end=aln_cap - 1,
            )
        )
    return out


def decode_banded_native(
    words: np.ndarray,      # (b, m_rows, win//8) int32 pointer words
    band: int,
    win: int,
    offsets: np.ndarray,    # (m_rows,) int32 band start per row
    wbase: np.ndarray,      # (m_rows,) int32 column of word 0's field 0 per row
    reads: np.ndarray,
    refs: np.ndarray,
    start_read_pos: np.ndarray,
    start_ref_pos: np.ndarray,
    params,
    algorithm,
    scores: np.ndarray,
    n_threads: int | None = None,
    raw: bool = False,
    gapped: bool = True,
):
    """Banded traceback decode through the C++ walker (linear or affine
    codes, 8 per int32 word; ``val_decode_banded``), the counterpart of
    ``versalignlib_tpu.native.decode_banded_native``. The code of cell (i, j)
    is field ``(j - wbase[i]) % 8`` of word ``(j - wbase[i]) // 8`` of row i;
    the walk stops at START, at row 0 or column 0, and where it leaves the
    band of ``band`` columns right of ``offsets[i]``.

    ``raw=True`` returns an :class:`AlignmentBatch`; ``gapped=False`` (raw
    only) drops its gapped-string columns.
    """
    if not gapped and not raw:
        raise ValueError("gapped=False requires raw=True (Alignment objects "
                         "carry gapped strings)")
    lib = _load()
    words = np.ascontiguousarray(words, dtype=np.int32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int32)
    wbase = np.ascontiguousarray(wbase, dtype=np.int32)
    reads = np.ascontiguousarray(reads, dtype=np.uint8)
    refs = np.ascontiguousarray(refs, dtype=np.uint8)
    start_r = np.ascontiguousarray(start_read_pos, dtype=np.int32)
    start_f = np.ascontiguousarray(start_ref_pos, dtype=np.int32)
    scores = np.ascontiguousarray(scores, dtype=np.int32)
    b, m = reads.shape
    n = refs.shape[1]
    m_rows = words.shape[1]
    if win % 8 or words.shape != (b, m_rows, win // 8) or m_rows < m \
            or offsets.shape[0] < m_rows or wbase.shape[0] < m_rows:
        raise ValueError(f"pointer words {words.shape} do not match {b} pairs of "
                         f"{m} rows at {win // 8} words per row")
    aln_cap = m + n
    cigar_cap = 3 * aln_cap + 16
    read_g = np.zeros((b, aln_cap), dtype=np.uint8)
    ref_g = np.zeros((b, aln_cap), dtype=np.uint8)
    cigar = np.zeros((b, cigar_cap), dtype=np.uint8)
    meta = np.zeros((b, 8), dtype=np.int32)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 8)
    vp = ctypes.c_void_p
    rc = lib.val_decode_banded(
        words.ctypes.data_as(vp), band, win,
        offsets.ctypes.data_as(vp), wbase.ctypes.data_as(vp),
        reads.ctypes.data_as(vp), refs.ctypes.data_as(vp),
        start_r.ctypes.data_as(vp), start_f.ctypes.data_as(vp),
        scores.ctypes.data_as(vp), b, m_rows, m, n, 1 if params.affine else 0,
        read_g.ctypes.data_as(vp), ref_g.ctypes.data_as(vp),
        cigar.ctypes.data_as(vp), cigar_cap, meta.ctypes.data_as(vp), n_threads,
    )
    if rc != 0:
        raise RuntimeError(f"val_decode_banded failed: {rc}")
    if not gapped:
        read_g = ref_g = None
    return _results(read_g, ref_g, cigar, meta, raw)


def parse_fasta_codes(path) -> tuple[np.ndarray, np.ndarray]:
    """Native fused FASTA parse + encode + pad: (codes (n, max_len) uint8,
    lengths (n,) int64), equal to ``io.fasta.parse_fasta`` followed by
    ``alphabet.pad_and_encode``. Raises ``OSError`` for a file it cannot
    read."""
    lib = _load()
    n = ctypes.c_int64()
    mx = ctypes.c_int64()
    path_b = str(path).encode()
    if lib.val_fasta_scan(path_b, ctypes.byref(n), ctypes.byref(mx)) != 0:
        raise OSError(f"cannot read FASTA file: {path}")
    codes = np.zeros((n.value, max(mx.value, 1)), dtype=np.uint8)
    lengths = np.zeros(n.value, dtype=np.int64)
    if n.value:
        rc = lib.val_fasta_read(path_b, codes.ctypes.data_as(ctypes.c_void_p), n.value,
                                codes.shape[1], lengths.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise OSError(f"FASTA parse failed: {path}")
    return codes, lengths


def format_sam_native(
    batch,                   # types.AlignmentBatch (column store)
    seqs: list[str],         # oriented SEQ strings
    qnames: list[str],
    rnames: list[str],
    flags_mapped: np.ndarray,
    flags_unmapped: np.ndarray,
    mapqs: np.ndarray,
    quals: list[str] | None = None,
    n_threads: int | None = None,
) -> bytes:
    """SAM record lines (each with its newline) of a whole
    :class:`AlignmentBatch`, formatted in C++ on ``n_threads`` threads
    (default ``min(8, os.cpu_count())``); the headers are the caller's.
    The records are those of ``io/sam.py::sam_record`` (edge normalization,
    NM/MD), whatever the thread count."""
    lib = _load()
    b = len(batch)
    if b == 0:
        return b""

    def _concat(strings):
        off = np.zeros(b + 1, dtype=np.int64)
        np.cumsum([len(s) for s in strings], out=off[1:])
        return "".join(strings).encode("latin-1"), off

    seq_b, seq_off = _concat(seqs)
    qn_b, qn_off = _concat(qnames)
    rn_b, rn_off = _concat(rnames)
    ql_b = ql_off = None
    if quals is not None and any(q is not None for q in quals):
        if any(q is None for q in quals):
            raise ValueError("mixed qual/None per batch is not supported "
                             "by the native formatter")
        ql_b, ql_off = _concat(quals)

    meta = np.ascontiguousarray(batch.meta, dtype=np.int32)
    read_g = np.ascontiguousarray(batch.read_gapped)
    ref_g = np.ascontiguousarray(batch.ref_gapped)
    cigar = np.ascontiguousarray(batch.cigar)
    aln_cap = read_g.shape[1]
    cigar_cap = cigar.shape[1]
    fm = np.ascontiguousarray(flags_mapped, dtype=np.int32)
    fu = np.ascontiguousarray(flags_unmapped, dtype=np.int32)
    mq = np.ascontiguousarray(mapqs, dtype=np.int32)

    # A bound on each record's bytes: names + seq + qual + soft-clipped
    # CIGAR + MD (2 chars a column) + the fixed fields and tags.
    per = (np.diff(qn_off) + np.diff(rn_off) + 2 * np.diff(seq_off)
           + cigar_cap + 2 * meta[:, 5].astype(np.int64) + 128)
    caps = np.zeros(b + 1, dtype=np.int64)
    np.cumsum(per, out=caps[1:])
    out = np.zeros(int(caps[-1]), dtype=np.uint8)
    lens = np.zeros(b, dtype=np.int64)
    threads = n_threads or min(8, os.cpu_count() or 1)
    total = lib.val_format_sam(
        read_g.ctypes.data, ref_g.ctypes.data, aln_cap,
        cigar.ctypes.data, cigar_cap, meta.ctypes.data,
        seq_b, seq_off.ctypes.data,
        ql_b, None if ql_off is None else ql_off.ctypes.data,
        qn_b, qn_off.ctypes.data,
        rn_b, rn_off.ctypes.data,
        fm.ctypes.data, fu.ctypes.data, mq.ctypes.data,
        b, out.ctypes.data, caps.ctypes.data, lens.ctypes.data, threads)
    if total < 0:
        raise RuntimeError("val_format_sam overflowed a record's bound")
    return out[:total].tobytes()
