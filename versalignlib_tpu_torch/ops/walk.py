"""Traceback walks: packed pointer rows -> one record per read row — the
counterpart of ``versalignlib_tpu/ops/walk.py``.

Along a traceback path the read row never increases, and within one row the
path is ``k`` LEFT moves and then one exit move (UP, DIAG or START). So a
pair's walk is one record per read row, ``left_count*4 | exit_code``, and
the host replays the records without the pointer words. Rows outside the
walk hold 0. Row 0 above the matrix is all-START; the dense column -1 is UP
for NW and START for SW; leaving the band on either edge is a hard stop
with a START record (walk.py:286-290).

The plain versions here run lockstep over read rows from the bottom and
vectorised over pairs, as the JAX walks do, on whatever device their
tensors lie on; they unpack each row's codes into one field per column and
take the LEFT run's end as the highest stop field at or below the cursor.
``csrc/walk.cu`` and ``csrc/banded_walk.cu`` are the card's kernels
(wrappers in ``ops/cuda_walk.py``), which follow one pair per thread.

Inputs are the fills' outputs as the port lays them out: dense pointer
words (B, m, ceil(n/16)) of 2-bit codes or (B, m, ceil(n/8)) of 4-bit
Gotoh codes ``hptr | e_ext<<2 | f_ext<<3`` with the aux word and (NW)
``hsel`` (``ops/plain.py``); banded words (B, m, ceil(band/8)) whose field
k of row i is column ``offsets[i] + k``, with ``best`` (SW) or ``keep``
(NW) (``ops/plain_banded.py``). Each walk returns ``(records (B, m),
start_r, start_f, scores)``, all int32 on the inputs' device.
"""

from __future__ import annotations

import numpy as np
import torch

from versalignlib_tpu_torch.ops.oracle import _text_from_codes
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm, Alignment, Trace, cigar_from_gapped

_START, _UP, _LEFT, _DIAG = (int(t) for t in (Trace.START, Trace.UP, Trace.LEFT, Trace.DIAG))


def _fields(words: torch.Tensor, bits: int) -> torch.Tensor:
    """(B, W) int32 words -> (B, W * 32 // bits) int64 codes, field j of word
    w at column w * (32 // bits) + j."""
    pack = 32 // bits
    shifts = bits * torch.arange(pack, dtype=torch.int64, device=words.device)
    w = words.to(torch.int64) & 0xFFFFFFFF
    return ((w[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(w.shape[0], -1)


def _gather(codes: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """codes[b, max(j[b], 0)] per pair."""
    return codes.gather(1, j.clamp(min=0).long()[:, None])[:, 0]


def _last_stop(stop: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The highest column whose ``stop`` flag is set, per pair; -1 if none."""
    return torch.where(stop, cols, -1).amax(dim=1)


def dense_starts(aux: torch.Tensor, hsel: torch.Tensor | None, mrp: torch.Tensor,
                 mxp: torch.Tensor, n: int, local: bool):
    """Traceback start cell and score per pair from a dense fill's outputs
    (walk.py:56-73): SW ``(aux[1], aux[2])`` with score ``aux[0]``; NW
    ``(mrp, min(mxp, aux[0]))`` with score ``hsel[clip(start_f, -1, n-1) +
    1]``, 0 where mrp < 0. mxp is each ref's last valid position."""
    if local:
        return aux[:, 1].clone(), aux[:, 2].clone(), aux[:, 0].clone()
    start_f = torch.minimum(mxp.to(torch.int32), aux[:, 0])
    idx = (start_f.clamp(-1, n - 1) + 1).long()
    score = hsel.gather(1, idx[:, None])[:, 0]
    return (mrp.to(torch.int32).clone(), start_f,
            torch.where(mrp >= 0, score, 0).to(torch.int32))


def banded_starts(best: torch.Tensor | None, keep: torch.Tensor | None, mrp: torch.Tensor,
                  mxp: torch.Tensor, offsets: torch.Tensor, n: int, band: int, local: bool):
    """Banded traceback start cell and score per pair (walk.py:297-320): SW
    the fill's best registers; NW row mrp and the first maximum of ``keep``
    over the in-band window ``[o, min(o + band, n, mxp + 1))`` of that row,
    or (-1, -1, 0) when mrp < 0 or the window is empty."""
    if local:
        return best[:, 1].clone(), best[:, 2].clone(), best[:, 0].clone()
    mrp = mrp.to(torch.int32)
    o = offsets[mrp.clamp(min=0).long()].to(torch.int32)
    hi = torch.minimum((o + band).clamp(max=n), mxp.to(torch.int32) + 1)
    ok = (mrp >= 0) & (hi > o)
    k = torch.arange(keep.shape[1], device=keep.device)
    vals = torch.where(k[None, :] < (hi - o)[:, None], keep.long(), -(2 ** 40))
    score, arg = vals.max(dim=1)
    # max(dim) returns the first index of the maximum on CPU and CUDA.
    return (torch.where(ok, mrp, -1), torch.where(ok, o + arg.to(torch.int32), -1),
            torch.where(ok, score.to(torch.int32), 0))


def _records(b: int, m: int, dev) -> torch.Tensor:
    return torch.zeros((b, m), dtype=torch.int32, device=dev)


def walk_dense(ptr: torch.Tensor, aux: torch.Tensor, hsel: torch.Tensor | None,
               mrp: torch.Tensor, mxp: torch.Tensor, n: int, local: bool):
    """Plain dense linear walk (walk.py:78 ``walk_blocks``) over 2-bit
    pointer words (B, m, ceil(n/16))."""
    b, m, _ = ptr.shape
    dev = ptr.device
    start_r, start_f, scores = dense_starts(aux, hsel, mrp, mxp, n, local)
    bnd = _START if local else _UP
    cols = torch.arange(ptr.shape[2] * 16, dtype=torch.int64, device=dev)
    fp = torch.full((b,), -1, dtype=torch.int64, device=dev)
    started = torch.zeros(b, dtype=torch.bool, device=dev)
    done = torch.zeros_like(started)
    records = _records(b, m, dev)
    for r in range(m - 1, -1, -1):
        codes = _fields(ptr[:, r], 2)
        newly = (start_r == r) & ~started
        started |= newly
        fp = torch.where(newly, start_f.long(), fp)
        active = started & ~done
        fpos = fp >= 0
        j_stop = _last_stop((codes != _LEFT) & (cols[None, :] <= fp[:, None]), cols)
        left = torch.where(fpos, fp - j_stop, 0)
        code = torch.where(fpos & (j_stop >= 0), _gather(codes, j_stop), bnd)
        records[:, r] = torch.where(active, left * 4 + code, 0).to(torch.int32)
        stop_now = active & (code == _START)
        fp = torch.where(active & fpos & ~stop_now,
                         torch.where(code == _DIAG, j_stop - 1, j_stop), fp)
        done |= stop_now
    return records, start_r, start_f, scores


def _affine_row(codes: torch.Tensor, cols: torch.Tensor, k_f: torch.Tensor):
    """The LEFT run of a row in state H under 4-bit Gotoh codes
    (walk.py:205-250): the E chain enters at the cursor ``k_f`` if its hptr
    is LEFT and continues left over ``cont(j) = e_ext(j+1) | hptr(j) ==
    LEFT`` down to the highest field in ``[0, k_f - 1]`` where cont is
    clear. Returns (code at k_f, jb: the cursor after the run, -1 when the
    run leaves the row, code at jb)."""
    e_next = torch.cat([(codes[:, 1:] >> 2) & 1, torch.zeros_like(codes[:, :1])], dim=1)
    cont = (e_next == 1) | ((codes & 3) == _LEFT)
    stop = ~cont & (cols[None, :] <= (k_f - 1)[:, None])
    code_f = _gather(codes, k_f)
    jb = torch.where((code_f & 3) == _LEFT, _last_stop(stop, cols), k_f)
    return code_f, jb, _gather(codes, jb)


def walk_dense_affine(ptr: torch.Tensor, aux: torch.Tensor, hsel: torch.Tensor | None,
                      mrp: torch.Tensor, mxp: torch.Tensor, n: int, local: bool):
    """Plain dense Gotoh walk (walk.py:162 ``walk_blocks_affine``) over
    4-bit pointer words (B, m, ceil(n/8)): the three states collapse to the
    same records. A row entered in state F exits UP with no LEFT and chains
    on its own cell's f_ext (the per-pair ``in_f``)."""
    b, m, _ = ptr.shape
    dev = ptr.device
    start_r, start_f, scores = dense_starts(aux, hsel, mrp, mxp, n, local)
    bnd = _START if local else _UP
    cols = torch.arange(ptr.shape[2] * 8, dtype=torch.int64, device=dev)
    fp = torch.full((b,), -1, dtype=torch.int64, device=dev)
    in_f = torch.zeros(b, dtype=torch.bool, device=dev)
    started = torch.zeros_like(in_f)
    done = torch.zeros_like(in_f)
    records = _records(b, m, dev)
    for r in range(m - 1, -1, -1):
        codes = _fields(ptr[:, r], 4)
        newly = (start_r == r) & ~started
        started |= newly
        fp = torch.where(newly, start_f.long(), fp)
        in_f &= ~newly
        active = started & ~done
        fpos = fp >= 0
        code_fp, jb, code_jb = _affine_row(codes, cols, fp)
        code = torch.where(in_f, _UP, torch.where(jb >= 0, code_jb & 3, bnd))
        code = torch.where(fpos, code, bnd)
        cnt = torch.where(in_f | ~fpos, 0, fp - jb)
        records[:, r] = torch.where(active, cnt * 4 + code, 0).to(torch.int32)
        stop_now = active & (code == _START)
        fx = torch.where(in_f, (code_fp >> 3) & 1, (code_jb >> 3) & 1)
        chained = torch.where(in_f, fp, jb) >= 0
        fp = torch.where(active & fpos & ~in_f & ~stop_now,
                         torch.where(code == _DIAG, jb - 1, jb), fp)
        in_f = active & fpos & (code == _UP) & (fx == 1) & chained
        done |= stop_now
    return records, start_r, start_f, scores


def walk_banded(ptr: torch.Tensor, best: torch.Tensor | None, keep: torch.Tensor | None,
                mrp: torch.Tensor, mxp: torch.Tensor, offsets: torch.Tensor, n: int,
                band: int, local: bool):
    """Plain banded linear walk (walk.py:324 ``walk_blocks_banded`` with
    ``wbase = offsets``) over band-relative 2-bit words (B, m,
    ceil(band/8)); ``offsets`` (m,) the band starts on the words' device.
    The cursor is a ref column; a run that reaches the band's low edge
    emits down to it and stops."""
    b, m, nw = ptr.shape
    dev = ptr.device
    start_r, start_f, scores = banded_starts(best, keep, mrp, mxp, offsets, n, band, local)
    cols = torch.arange(nw * 8, dtype=torch.int64, device=dev)
    fp = torch.full((b,), -1, dtype=torch.int64, device=dev)
    started = torch.zeros(b, dtype=torch.bool, device=dev)
    done = torch.zeros_like(started)
    records = _records(b, m, dev)
    offs = [int(v) for v in offsets.tolist()]
    for r in range(m - 1, -1, -1):
        # Sixteen 2-bit fields a word, of which the low eight are the band's.
        codes = _fields(ptr[:, r], 2).view(b, nw, 16)[:, :, :8].reshape(b, -1)
        newly = (start_r == r) & ~started
        started |= newly
        fp = torch.where(newly, start_f.long(), fp)
        active = started & ~done
        k_f = fp - offs[r]
        live = active & (k_f >= 0) & (k_f < band)
        k_stop = _last_stop((codes != _LEFT) & (cols[None, :] <= k_f[:, None]), cols)
        found = k_stop >= 0
        cnt = torch.where(found, k_f - k_stop, k_f + 1)
        code = torch.where(found & live, _gather(codes, k_stop), _START)
        cnt = torch.where(live, cnt, 0)
        records[:, r] = torch.where(active, cnt * 4 + code, 0).to(torch.int32)
        stop_now = active & (code == _START)
        fp = torch.where(live & ~stop_now,
                         offs[r] + torch.where(code == _DIAG, k_stop - 1, k_stop), fp)
        done |= stop_now
    return records, start_r, start_f, scores


def walk_banded_affine(ptr: torch.Tensor, best: torch.Tensor | None,
                       keep: torch.Tensor | None, mrp: torch.Tensor, mxp: torch.Tensor,
                       offsets: torch.Tensor, n: int, band: int, local: bool):
    """Plain banded Gotoh walk (walk.py:413 ``walk_blocks_banded_affine``
    with ``wbase = offsets``) over band-relative 4-bit words (B, m,
    ceil(band/8)): an E run that reaches the band's low edge emits down to
    it and stops, and a row entered out of band stops with START."""
    b, m, nw = ptr.shape
    dev = ptr.device
    start_r, start_f, scores = banded_starts(best, keep, mrp, mxp, offsets, n, band, local)
    cols = torch.arange(nw * 8, dtype=torch.int64, device=dev)
    fp = torch.full((b,), -1, dtype=torch.int64, device=dev)
    in_f = torch.zeros(b, dtype=torch.bool, device=dev)
    started = torch.zeros_like(in_f)
    done = torch.zeros_like(in_f)
    records = _records(b, m, dev)
    offs = [int(v) for v in offsets.tolist()]
    for r in range(m - 1, -1, -1):
        codes = _fields(ptr[:, r], 4)
        newly = (start_r == r) & ~started
        started |= newly
        fp = torch.where(newly, start_f.long(), fp)
        in_f &= ~newly
        active = started & ~done
        k_f = fp - offs[r]
        live = active & (k_f >= 0) & (k_f < band)
        code_f, jb, code_jb = _affine_row(codes, cols, k_f.clamp(0, nw * 8 - 1))
        found = jb >= 0
        code = torch.where(in_f, _UP, torch.where(found, code_jb & 3, _START))
        code = torch.where(live, code, _START)
        cnt = torch.where(live & ~in_f, torch.where(found, k_f - jb, k_f + 1), 0)
        records[:, r] = torch.where(active, cnt * 4 + code, 0).to(torch.int32)
        stop_now = active & (code == _START)
        fx = torch.where(in_f, (code_f >> 3) & 1, (code_jb >> 3) & 1)
        fp = torch.where(live & ~in_f & ~stop_now,
                         offs[r] + torch.where(code == _DIAG, jb - 1, jb), fp)
        in_f = live & (code == _UP) & (fx == 1)
        done |= stop_now
    return records, start_r, start_f, scores


# ---------------------------------------------------------------------------
# Host replay: records -> alignments
# ---------------------------------------------------------------------------

def replay_one(records: np.ndarray, read: np.ndarray, ref: np.ndarray,
               start_read_pos: int, start_ref_pos: int, score: int,
               params: AlignmentParameters, algorithm: Algorithm,
               read_text: str | None = None, ref_text: str | None = None) -> Alignment:
    """Replay one pair's walk records into an :class:`Alignment`, move for
    move as the host decoder walks the pointer words (walk.py:525-588). The
    native replay (:func:`replay_batch`) serves the paths; this one the
    tests."""
    m = records.shape[0]
    n = ref.shape[0]
    if read_text is None:
        read_text = _text_from_codes(read)
    if ref_text is None:
        ref_text = _text_from_codes(ref)
    rp, fp = int(start_read_pos), int(start_ref_pos)
    read_chars: list[str] = []
    ref_chars: list[str] = []
    steps = 0
    while rp >= 0:
        rec = int(records[rp])
        k, code = rec >> 2, rec & 3
        for _ in range(k):
            read_chars.append("-")
            ref_chars.append(ref_text[fp])
            fp -= 1
        steps += k
        if code == _START:
            break
        read_chars.append(read_text[rp])
        if code == _UP:
            ref_chars.append("-")
        else:  # DIAG
            ref_chars.append(ref_text[fp])
            fp -= 1
        rp -= 1
        steps += 1
    read_g = "".join(reversed(read_chars))
    ref_g = "".join(reversed(ref_chars))
    aln_length = m + n
    return Alignment(
        read=read_g, ref=ref_g, score=int(score), cigar=cigar_from_gapped(read_g, ref_g),
        read_start=rp + 1, read_end=int(start_read_pos) + 1,
        ref_start=fp + 1, ref_end=int(start_ref_pos) + 1,
        buffer_start=aln_length - 1 - steps, buffer_end=aln_length - 1)


def replay_batch(records: np.ndarray, reads: np.ndarray, refs: np.ndarray,
                 start_read_pos: np.ndarray, start_ref_pos: np.ndarray,
                 scores: np.ndarray, params: AlignmentParameters, algorithm: Algorithm,
                 read_texts: list[str] | None = None, ref_texts: list[str] | None = None,
                 raw: bool = False, gapped: bool = True):
    """Replay a batch of walk records through the native decoder
    (``native.replay_records_native``); there is no Python fallback, as the
    native loader raises when it cannot build."""
    from versalignlib_tpu_torch.native import replay_records_native

    return replay_records_native(
        records, reads, refs, start_read_pos, start_ref_pos, scores, params, algorithm,
        read_texts, ref_texts, raw=raw, gapped=gapped)
