"""Host traceback decoder (C++), built with g++ at first use and loaded with
ctypes.

The port's copy of the loader and ``decode_batch_native`` of
``versalignlib_tpu/native``. There is no Python fallback: a failed build
raises, because the decoder is on the alignment path.
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
        _lib = lib
        return _lib


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
    lib = _load()
    words, pack = ptr
    ptr_arr = np.ascontiguousarray(words, dtype=np.int32)
    reads = np.ascontiguousarray(reads, dtype=np.uint8)
    refs = np.ascontiguousarray(refs, dtype=np.uint8)
    b, m = reads.shape
    n = refs.shape[1]
    if ptr_arr.shape != (b, m, -(-n // pack)):
        raise ValueError(f"pointer words {ptr_arr.shape} do not match "
                         f"{b} pairs of {m}x{n} at {pack} codes per word")
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
        ptr_arr.ctypes.data_as(ctypes.c_void_p), 1, pack,
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

    if raw:
        return AlignmentBatch(read_g, ref_g, cigar, meta)
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
