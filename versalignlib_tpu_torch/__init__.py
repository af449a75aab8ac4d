"""versalignlib_tpu_torch — the PyTorch and CUDA port of versalignlib_tpu.

Pairwise DNA alignment (Smith-Waterman and the reference's semi-global
"Needleman-Wunsch") with hand-written CUDA kernels for NVIDIA Hopper
(``csrc/``), held bit for bit against the JAX package. The package imports
``torch``, numpy and the standard library, never ``jax`` or
``versalignlib_tpu``.

    from versalignlib_tpu_torch import AlignmentEngine, Algorithm
    engine = AlignmentEngine()            # runs on the card ("cuda")
    scores = engine.score_alignments(Algorithm.SMITH_WATERMAN, reads, refs)
"""

from versalignlib_tpu_torch.dispatch import AlignmentEngine
from versalignlib_tpu_torch.params import (
    DEFAULT_PARAMETERS,
    AlignmentParameters,
    params_from_reference,
)
from versalignlib_tpu_torch.types import Algorithm, Alignment, AlignmentBatch, TieBreak

__all__ = [
    "AlignmentEngine",
    "AlignmentParameters",
    "DEFAULT_PARAMETERS",
    "Algorithm",
    "TieBreak",
    "Alignment",
    "AlignmentBatch",
    "params_from_reference",
]
