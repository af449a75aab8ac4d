"""Host-side traceback of one pair (the port's copy of ``decode_one`` from
``versalignlib_tpu/ops/traceback.py``).

``ops/cuda_align.py`` uses it only for the degenerate batch with an empty
read or ref axis, where the walk is boundary-only; every other batch goes
through the native decoder, with no fallback to this walker.
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
