"""Alignment model families (the port's copy of ``versalignlib_tpu/models``;
``score`` and ``align`` take ``device=``, the card by default).

A *model* bundles an algorithm, scoring parameters, and execution strategy
(dense vs banded, preferred mode) into one configured object — the role the
reference splits between the ``opt`` flag (include/AlignmentKernel.h:26-32)
and the injected ``CustomParameters`` (src/impl/CustomParameters.h:6-59).

Families:

- :func:`smith_waterman` — local alignment (reference opt=0);
- :func:`needleman_wunsch` — semi-global / overlap (reference opt=1, with
  all its boundary quirks preserved);
- :func:`affine` variants — Gotoh gap model (additive over the reference);
- :func:`banded` variants — long-pair banded DP (additive).
"""

from versalignlib_tpu_torch.models.base import AlignmentModel
from versalignlib_tpu_torch.models.families import (
    affine_needleman_wunsch,
    affine_smith_waterman,
    banded_needleman_wunsch,
    banded_smith_waterman,
    protein_smith_waterman,
    needleman_wunsch,
    smith_waterman,
)

__all__ = [
    "AlignmentModel",
    "smith_waterman",
    "needleman_wunsch",
    "affine_needleman_wunsch",
    "affine_smith_waterman",
    "banded_smith_waterman",
    "protein_smith_waterman",
    "banded_needleman_wunsch",
]
