"""Dispatcher backend wiring the CUDA kernels — the counterpart of
``versalignlib_tpu/ops/pallas_backend.py``.

Scores come from ``csrc/score.cu``; alignments from ``csrc/align.cu``, or
``csrc/align_affine.cu`` under affine gaps, then on a CUDA device the
traceback walk ``csrc/walk.cu`` and a replay of its records on the host (on
the CPU the host decoder, unless ``device_walk`` asks for the plain walk). On a CUDA
device, a pair shape whose memory plan exceeds the card is refused before
any launch. There is no other backend to fall
back to.
"""

from __future__ import annotations

import torch

from versalignlib_tpu_torch.ops import cuda_align, cuda_walk
from versalignlib_tpu_torch.ops.cuda_score import CudaScorer
from versalignlib_tpu_torch.types import Algorithm
from versalignlib_tpu_torch.utils.capabilities import probe


class CudaBackend:
    name = "cuda"

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._scorer = CudaScorer(self.device)

    def is_available(self) -> bool:
        return self.device.type == "cpu" or torch.cuda.is_available()

    def _check_dense_fits(self, reads, refs, params, mode: str) -> None:
        if self.device.type != "cuda":
            return
        caps = probe(self.device.index or 0)
        m, n = reads.shape[1], refs.shape[1]
        if not caps.dense_fits(m, n, mode, params.affine):
            raise ValueError(
                f"dense {m}x{n} pairs exceed the memory of {caps.name} "
                f"({caps.memory_bytes >> 20} MiB) under the {mode} kernel's plan")

    def score_alignments(self, algorithm, reads, refs, params):
        self._check_dense_fits(reads, refs, params, "score")
        return self._scorer(reads, refs, params, Algorithm(algorithm))

    def compute_alignments(self, algorithm, reads, refs, params, tie,
                           device_walk: bool | None = None, raw: bool = False,
                           gapped: bool = True):
        """``device_walk``: walk the pointer words where the fill ran and
        return only row records to the host (``ops/cuda_walk.py``). None,
        the default, walks on the card for a CUDA device and on the host
        for the CPU, as the JAX backend walks on the device when compiled
        and on the host in interpret mode."""
        self._check_dense_fits(reads, refs, params, "align")
        return cuda_align.align_batch(
            reads, refs, params, Algorithm(algorithm), tie, device=self.device, raw=raw,
            device_walk=cuda_walk.resolve_device_walk(device_walk, self.device),
            gapped=gapped)
