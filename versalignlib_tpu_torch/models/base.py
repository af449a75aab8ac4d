"""AlignmentModel: a configured, executable alignment pipeline (the
counterpart of ``versalignlib_tpu/models/base.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from versalignlib_tpu_torch.alphabet import encode_custom, pad_and_encode
from versalignlib_tpu_torch.params import DEFAULT_PARAMETERS, AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm, Alignment, TieBreak


@dataclasses.dataclass(frozen=True)
class AlignmentModel:
    """Immutable model config.

    ``banded`` models score and align through the banded kernels
    (``ops/banded.py``); dense models go through the backend registry
    (``"cuda"``, or ``"oracle"`` on the host). ``score`` and ``align`` run
    on ``device``: the card by default, the plain PyTorch path with
    ``device="cpu"``.
    """

    name: str
    algorithm: Algorithm
    params: AlignmentParameters = DEFAULT_PARAMETERS
    tie: TieBreak = TieBreak.DIAG_UP_LEFT
    banded: bool = False
    band: int = 512
    band_tile: int = 256
    #: traceback walk on the device (only row records come back to the
    #: host); None walks on the card for CUDA and on the host for the CPU.
    device_walk: bool | None = None
    #: custom alphabet string for encoding (None = the reference DNA table);
    #: char i maps to code i+1, code 0 stays the padding sentinel.
    alphabet: str | None = None

    def _encode_seqs(self, seqs):
        if self.alphabet is None:
            return pad_and_encode(seqs)
        return encode_custom(seqs, self.alphabet)

    def _encode(self, reads, refs):
        def enc(x):
            if isinstance(x, np.ndarray) and x.dtype == np.uint8 and x.ndim == 2:
                return x
            return self._encode_seqs(x)

        reads_enc, refs_enc = enc(reads), enc(refs)
        if reads_enc.shape[0] != refs_enc.shape[0]:
            raise ValueError(
                f"read/ref counts differ: {reads_enc.shape[0]} vs {refs_enc.shape[0]}")
        return reads_enc, refs_enc

    def score(self, reads, refs, backend: str = "auto",
              device: torch.device | str = "cuda") -> np.ndarray:
        reads_enc, refs_enc = self._encode(reads, refs)
        if self.banded:
            from versalignlib_tpu_torch.ops.banded import banded_score_batch

            return banded_score_batch(reads_enc, refs_enc, self.params, self.algorithm,
                                      band=self.band, tile=self.band_tile, device=device)
        from versalignlib_tpu_torch.dispatch import _resolve_device, get_backend

        be = get_backend(backend, _resolve_device(device))
        return np.asarray(be.score_alignments(self.algorithm, reads_enc, refs_enc,
                                              self.params), dtype=np.int32)

    def align(self, reads, refs, backend: str = "auto",
              device: torch.device | str = "cuda") -> list[Alignment]:
        reads_enc, refs_enc = self._encode(reads, refs)
        if self.banded:
            from versalignlib_tpu_torch.ops.banded import banded_align_batch

            return banded_align_batch(reads_enc, refs_enc, self.params, self.algorithm,
                                      band=self.band, tile=self.band_tile, tie=self.tie,
                                      device_walk=self.device_walk, device=device)
        from versalignlib_tpu_torch.dispatch import _resolve_device, get_backend

        be = get_backend(backend, _resolve_device(device))
        if be.name == "cuda":
            return be.compute_alignments(self.algorithm, reads_enc, refs_enc, self.params,
                                         self.tie, device_walk=self.device_walk)
        if self.device_walk is not None:
            raise ValueError(
                "device_walk is only supported by the banded path and the cuda "
                f"backend; got backend={be.name!r}. Leave device_walk=None or "
                "select backend='cuda'.")
        return be.compute_alignments(self.algorithm, reads_enc, refs_enc, self.params,
                                     self.tie)
