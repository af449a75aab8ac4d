"""Host-side traceback of one pair (the port's copy of ``decode_one`` from
``versalignlib_tpu/ops/traceback.py``).

``ops/cuda_align.py`` uses it only for the degenerate batch with an empty
read or ref axis, where the walk is boundary-only; every other batch goes
through the native decoder, with no fallback to this walker, and so do the
dense pointer codes of :func:`decode_batch` and :func:`decode_batch_affine`.
"""

from __future__ import annotations

import numpy as np

from versalignlib_tpu_torch.ops.oracle import _text_from_codes
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm, Alignment, Trace, cigar_from_gapped


def _sub_score(a: int, b: int, params: AlignmentParameters) -> int:
    """``alphabet.substitution_scores`` of one pair of codes: the default
    DNA table, or ``matrix[a][b]`` with codes outside [0, S) read as 0."""
    if params.matrix is not None:
        s = len(params.matrix)
        return params.matrix[a if 0 <= a < s else 0][b if 0 <= b < s else 0]
    if not (1 <= a <= 4 and 1 <= b <= 4):
        return 0
    return params.score_match if a == b else params.score_mismatch


def decode_one(
    ptr_inner: np.ndarray,
    read: np.ndarray,
    ref: np.ndarray,
    start_read_pos: int,
    start_ref_pos: int,
    params: AlignmentParameters,
    algorithm: Algorithm,
    score: int | None = None,
    read_text: str | None = None,
    ref_text: str | None = None,
) -> Alignment:
    """Decode one pair's traceback.

    ``ptr_inner[i, j]`` is the pointer of DP cell (i+1, j+1); the boundary
    row is START and the boundary column START (SW) or UP (NW,
    DefaultKernel.cpp:304,395). ``score`` may be given; if None it is
    reconstructed from the path and the NW column-0 boundary value.
    """
    m, n = ptr_inner.shape
    is_nw = algorithm == Algorithm.NEEDLEMAN_WUNSCH
    if read_text is None:
        read_text = _text_from_codes(read)
    if ref_text is None:
        ref_text = _text_from_codes(ref)

    rp, fp = int(start_read_pos), int(start_ref_pos)
    read_chars: list[str] = []
    ref_chars: list[str] = []
    path_cost = 0
    steps = 0
    while True:
        if rp < 0:
            bt = Trace.START  # boundary row 0 is all START
        elif fp < 0:
            bt = Trace.UP if is_nw else Trace.START  # boundary col 0
        else:
            bt = ptr_inner[rp, fp]
        if bt == Trace.START:
            break
        if bt == Trace.UP:
            read_chars.append(read_text[rp])
            ref_chars.append("-")
            path_cost += params.score_gap_ref
            rp -= 1
        elif bt == Trace.LEFT:
            read_chars.append("-")
            ref_chars.append(ref_text[fp])
            path_cost += params.score_gap_read
            fp -= 1
        else:
            read_chars.append(read_text[rp])
            ref_chars.append(ref_text[fp])
            path_cost += _sub_score(int(read[rp]), int(ref[fp]), params)
            rp -= 1
            fp -= 1
        steps += 1
        if steps > m + n:
            raise RuntimeError("traceback did not terminate")

    if score is None:
        # Path start boundary value: 0 on row 0; (rp+1)*gap_ref on NW
        # column 0 (DefaultKernel.cpp:305).
        boundary = (rp + 1) * params.score_gap_ref if (fp < 0 and rp >= 0 and is_nw) else 0
        score = boundary + path_cost

    read_g = "".join(reversed(read_chars))
    ref_g = "".join(reversed(ref_chars))
    aln_length = m + n
    return Alignment(
        read=read_g,
        ref=ref_g,
        score=int(score),
        cigar=cigar_from_gapped(read_g, ref_g),
        read_start=rp + 1,
        read_end=int(start_read_pos) + 1,
        ref_start=fp + 1,
        ref_end=int(start_ref_pos) + 1,
        buffer_start=aln_length - 1 - steps,
        buffer_end=aln_length - 1,
    )


def _decode_dense(codes, affine: bool, *args) -> list[Alignment]:
    """Dense (B, m, n) codes of DP cells (r+1, c+1), packed into words as
    the fill packs them (2-bit linear codes 16 a word, 4-bit Gotoh codes 8),
    walked by the native decoder; ``args`` are ``decode_batch_native``'s
    after the words."""
    import torch

    from versalignlib_tpu_torch.native import decode_batch_native
    from versalignlib_tpu_torch.ops.plain import AFFINE_PACK, PACK, pack_words

    bits, pack = (4, AFFINE_PACK) if affine else (2, PACK)
    codes = torch.from_numpy(np.array(codes, dtype=np.int64))
    b, m, n = codes.shape
    words = pack_words(codes.reshape(b * m, n), bits=bits, pack=pack).reshape(b, m, -1)
    return decode_batch_native((words.numpy(), pack), *args, affine=affine)


def decode_batch(
    ptr_inner: np.ndarray,
    reads: np.ndarray,
    refs: np.ndarray,
    start_read_pos: np.ndarray,
    start_ref_pos: np.ndarray,
    params: AlignmentParameters,
    algorithm: Algorithm,
    scores: np.ndarray | None = None,
    read_texts: list[str] | None = None,
    ref_texts: list[str] | None = None,
) -> list[Alignment]:
    """Decode a batch of dense (B, m, n) uint8 move codes, ``ptr_inner[i,
    r, c]`` that of DP cell (r+1, c+1) (as ``distributed_align_device``
    returns them): packed 16 to a word and walked by the native decoder."""
    return _decode_dense(ptr_inner, False, reads, refs, start_read_pos, start_ref_pos,
                         params, algorithm, scores, read_texts, ref_texts)


def decode_batch_affine(
    ptr: np.ndarray,
    reads: np.ndarray,
    refs: np.ndarray,
    start_read_pos: np.ndarray,
    start_ref_pos: np.ndarray,
    params: AlignmentParameters,
    algorithm: Algorithm,
    scores: np.ndarray,
    read_texts: list[str] | None = None,
    ref_texts: list[str] | None = None,
) -> list[Alignment]:
    """Decode a batch of dense (B, m, n) uint8 Gotoh codes, ``hptr |
    e_ext<<2 | f_ext<<3`` for DP cell (r+1, c+1), with the exact end-cell
    ``scores`` (required): packed 8 to a word as the Gotoh fill packs them
    and walked by the native decoder's three-state machine."""
    return _decode_dense(ptr, True, reads, refs, start_read_pos, start_ref_pos, params,
                         algorithm, scores, read_texts, ref_texts)
