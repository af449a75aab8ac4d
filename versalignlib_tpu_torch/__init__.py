"""versalignlib_tpu_torch — the PyTorch and CUDA port of versalignlib_tpu.

Pairwise alignment (Smith-Waterman and the reference's semi-global
"Needleman-Wunsch"), one-vs-many search, read mapping against panels and
whole references, PSSM profile search, six-frame translated search and hit
statistics, banded long pairs and seed-chain-extend long-read mapping, with
hand-written CUDA kernels for NVIDIA Hopper (``csrc/``),
held bit for bit against the JAX package. The package imports ``torch``,
numpy and the standard library, never ``jax`` or ``versalignlib_tpu``.

    from versalignlib_tpu_torch import AlignmentEngine, Algorithm, map_reads
    engine = AlignmentEngine()            # runs on the card ("cuda")
    scores = engine.score_alignments(Algorithm.SMITH_WATERMAN, reads, refs)
    hits = map_reads(reads, panel)        # one-vs-many on the card
    alns = models.banded_needleman_wunsch(band=512).align(long_reads, long_refs)
    server = AlignServer(BatchingAligner(engine))   # HTTP JSON serving
"""

from versalignlib_tpu_torch import models
from versalignlib_tpu_torch.alphabet import decode, encode, pad_and_encode
from versalignlib_tpu_torch.dispatch import (AlignmentEngine, available_backends, get_backend,
                                             register_backend)
from versalignlib_tpu_torch.longread import LongReadHits, find_chains, map_long_reads
from versalignlib_tpu_torch.ops.banded import banded_align_batch, banded_score_batch
from versalignlib_tpu_torch.ops.pssm import (ProfileHit, calibrate_profile, pack_pssm,
                                             profile_search, pssm_from_sequences)
from versalignlib_tpu_torch.params import (
    DEFAULT_PARAMETERS,
    AlignmentParameters,
    params_from_reference,
)
from versalignlib_tpu_torch.refmap import (ReferenceHits, WindowIndex, map_to_reference,
                                           tile_references)
from versalignlib_tpu_torch.search import (PairedHits, SearchHits, best_hits,
                                           map_read_pairs, map_reads, score_matrix)
from versalignlib_tpu_torch.seed import MinimizerIndex, build_index, minimizers
from versalignlib_tpu_torch.stats import (ROBINSON_FREQS, GumbelCalibration, calibrate,
                                          calibrate_islands, karlin_lambda)
from versalignlib_tpu_torch.translate import (TranslatedHits, calibrate_translated,
                                              translate_six_frames, translated_search)
from versalignlib_tpu_torch.types import Algorithm, Alignment, AlignmentBatch, AlignMode, TieBreak

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy serving-layer exports: `import versalignlib_tpu_torch` loads no
    # HTTP or threading machinery until a server is wanted.
    if name in ("BatchingAligner", "AlignServer"):
        from versalignlib_tpu_torch import serve

        return getattr(serve, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BatchingAligner",
    "AlignServer",
    "AlignmentEngine",
    "get_backend",
    "register_backend",
    "available_backends",
    "AlignmentParameters",
    "DEFAULT_PARAMETERS",
    "Algorithm",
    "TieBreak",
    "Alignment",
    "AlignmentBatch",
    "AlignMode",
    "params_from_reference",
    "encode",
    "decode",
    "pad_and_encode",
    "score_matrix",
    "best_hits",
    "map_reads",
    "map_read_pairs",
    "SearchHits",
    "PairedHits",
    "map_to_reference",
    "ReferenceHits",
    "tile_references",
    "WindowIndex",
    "GumbelCalibration",
    "calibrate",
    "calibrate_islands",
    "karlin_lambda",
    "ROBINSON_FREQS",
    "profile_search",
    "ProfileHit",
    "calibrate_profile",
    "pssm_from_sequences",
    "pack_pssm",
    "translated_search",
    "calibrate_translated",
    "translate_six_frames",
    "TranslatedHits",
    "models",
    "banded_score_batch",
    "banded_align_batch",
    "map_long_reads",
    "LongReadHits",
    "build_index",
    "MinimizerIndex",
    "minimizers",
    "find_chains",
    "__version__",
]
