"""Factory functions for the model families."""

from __future__ import annotations

from versalignlib_tpu_torch.models.base import AlignmentModel
from versalignlib_tpu_torch.params import AlignmentParameters, DEFAULT_PARAMETERS
from versalignlib_tpu_torch.types import Algorithm, TieBreak


def smith_waterman(
    params: AlignmentParameters = DEFAULT_PARAMETERS,
    tie: TieBreak = TieBreak.DIAG_UP_LEFT,
) -> AlignmentModel:
    """Local alignment (reference opt=0, DefaultKernel.cpp:83-138)."""
    return AlignmentModel("smith_waterman", Algorithm.SMITH_WATERMAN, params, tie)


def needleman_wunsch(
    params: AlignmentParameters = DEFAULT_PARAMETERS,
    tie: TieBreak = TieBreak.DIAG_UP_LEFT,
) -> AlignmentModel:
    """Semi-global / overlap alignment (reference opt=1; free end gaps in
    scoring, padding-robust end cells in traceback — SURVEY.md §2.2)."""
    return AlignmentModel("needleman_wunsch", Algorithm.NEEDLEMAN_WUNSCH, params, tie)


def affine_smith_waterman(
    gap_open: int = -4,
    gap_extend: int = -1,
    params: AlignmentParameters = DEFAULT_PARAMETERS,
) -> AlignmentModel:
    """Gotoh affine-gap local alignment (additive over the reference)."""
    p = params.replace(
        gap_open_read=gap_open, gap_open_ref=gap_open,
        score_gap_read=gap_extend, score_gap_ref=gap_extend,
    )
    return AlignmentModel("affine_smith_waterman", Algorithm.SMITH_WATERMAN, p)


def affine_needleman_wunsch(
    gap_open: int = -4,
    gap_extend: int = -1,
    params: AlignmentParameters = DEFAULT_PARAMETERS,
) -> AlignmentModel:
    """Gotoh affine-gap semi-global alignment (additive over the reference)."""
    p = params.replace(
        gap_open_read=gap_open, gap_open_ref=gap_open,
        score_gap_read=gap_extend, score_gap_ref=gap_extend,
    )
    return AlignmentModel("affine_needleman_wunsch", Algorithm.NEEDLEMAN_WUNSCH, p)


def protein_smith_waterman(
    gap_open: int = -10,
    gap_extend: int = -1,
    matrix: tuple | None = None,
) -> AlignmentModel:
    """BLOSUM62 protein local alignment (additive: the reference is
    DNA-only). Sequences are encoded against ``alphabet.PROTEIN_ALPHABET``;
    pass a custom ``matrix`` (with zero padding row/col 0) to override."""
    from versalignlib_tpu_torch.alphabet import PROTEIN_ALPHABET, blosum62

    p = AlignmentParameters(
        score_gap_read=gap_extend, score_gap_ref=gap_extend,
        gap_open_read=gap_open, gap_open_ref=gap_open,
        matrix=blosum62() if matrix is None else matrix,
    )
    return AlignmentModel("protein_smith_waterman", Algorithm.SMITH_WATERMAN,
                          p, alphabet=PROTEIN_ALPHABET)


def banded_smith_waterman(
    band: int = 512,
    tile: int = 256,
    params: AlignmentParameters = DEFAULT_PARAMETERS,
) -> AlignmentModel:
    """Banded local scoring for long pairs (additive over the reference)."""
    return AlignmentModel(
        "banded_smith_waterman", Algorithm.SMITH_WATERMAN, params,
        banded=True, band=band, band_tile=tile,
    )


def banded_needleman_wunsch(
    band: int = 512,
    tile: int = 256,
    params: AlignmentParameters = DEFAULT_PARAMETERS,
) -> AlignmentModel:
    """Banded semi-global scoring for long pairs (BASELINE config 4)."""
    return AlignmentModel(
        "banded_needleman_wunsch", Algorithm.NEEDLEMAN_WUNSCH, params,
        banded=True, band=band, band_tile=tile,
    )
