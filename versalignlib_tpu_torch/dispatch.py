"""Backend registry and the user-facing :class:`AlignmentEngine`.

The counterpart of ``versalignlib_tpu/dispatch.py``: a registry of backends
keyed by name, each implementing the two-method surface of the reference's
``AlignmentKernel`` interface (AlignmentKernel.h:34-44):

    score_alignments(algorithm, reads, refs)   -> (n,) int32 scores
    compute_alignments(algorithm, reads, refs) -> list[Alignment]

The port registers two backends: ``"oracle"`` (the numpy oracles, on the
host whatever the device) and ``"cuda"``, which ``"auto"`` resolves to.
Entry points run on the card: the engine's default device is ``"cuda"``, and
on a host without one it raises instead of quietly using the CPU. The plain
PyTorch path runs only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Protocol

import numpy as np
import torch

from versalignlib_tpu_torch.alphabet import pad_and_encode
from versalignlib_tpu_torch.ops import oracle
from versalignlib_tpu_torch.params import DEFAULT_PARAMETERS, AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm, Alignment, AlignmentBatch, TieBreak
from versalignlib_tpu_torch.utils.profiling import annotate


class Backend(Protocol):
    """Structural interface every kernel backend implements."""

    name: str

    def is_available(self) -> bool: ...

    def score_alignments(
        self, algorithm: Algorithm, reads: np.ndarray, refs: np.ndarray,
        params: AlignmentParameters,
    ) -> np.ndarray: ...

    def compute_alignments(
        self, algorithm: Algorithm, reads: np.ndarray, refs: np.ndarray,
        params: AlignmentParameters, tie: TieBreak, device_walk: bool | None = None,
        raw: bool = False, gapped: bool = True,
    ) -> list[Alignment] | AlignmentBatch: ...


@dataclasses.dataclass
class _Registration:
    factory: Callable[[torch.device], Backend]
    priority: int  # higher = preferred by "auto"


_REGISTRY: dict[str, _Registration] = {}


def register_backend(name: str, factory: Callable[[torch.device], Backend],
                     priority: int = 0) -> None:
    """Register a backend factory, called with the device to run on."""
    _REGISTRY[name] = _Registration(factory=factory, priority=priority)


def get_backend(name: str, device: torch.device | str = "cuda") -> Backend:
    """The backend ``name`` on ``device``; ``"auto"`` picks the available
    backend of highest priority."""
    device = torch.device(device)
    if name == "auto":
        ranked = sorted(_REGISTRY, key=lambda k: -_REGISTRY[k].priority)
        for candidate in ranked:
            backend = _REGISTRY[candidate].factory(device)
            if backend.is_available():
                return backend
        raise RuntimeError(f"no alignment backend available on {device}")
    reg = _REGISTRY.get(name)
    if reg is None:
        raise KeyError(f"Unknown backend {name!r}; available: {sorted(_REGISTRY)}")
    return reg.factory(device)


def available_backends(device: torch.device | str = "cuda") -> list[str]:
    """Names of registered backends that can run on ``device``."""
    return [name for name, reg in _REGISTRY.items()
            if reg.factory(torch.device(device)).is_available()]


def _resolve_device(device: torch.device | str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"AlignmentEngine(device={str(device)!r}) needs a CUDA device, and "
            "none is available (torch.cuda.is_available() is False); pass "
            "device='cpu' to run the plain PyTorch path")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def _resolve_placement(device: torch.device | str, mesh) -> torch.device:
    """The device an entry point runs on: with a mesh its first device (the
    shards run on all of its devices), else ``device`` resolved."""
    return mesh.devices[0] if mesh is not None else _resolve_device(device)


class AlignmentEngine:
    """User-facing entry point: scoring and full alignment over string or
    code batches (the reference example driver's kernel handling,
    main.cpp:74-215): pads and encodes sequences, runs the backend."""

    def __init__(
        self,
        params: AlignmentParameters = DEFAULT_PARAMETERS,
        backend: str = "auto",
        tie: TieBreak = TieBreak.DIAG_UP_LEFT,
        device: torch.device | str = "cuda",
        mesh=None,
        device_walk: bool | None = None,
    ) -> None:
        """``device``: ``"cuda"`` (default; raises without a card) or
        ``"cpu"`` for the plain PyTorch path. ``device_walk``: the traceback
        walk on the device, so that only row records come back to the host;
        None (the default) walks on the card for CUDA and on the host for
        the CPU, and True on the CPU runs the plain walk.

        ``mesh``: a :class:`~versalignlib_tpu_torch.parallel.mesh.Mesh`;
        scores and alignments then run data-parallel over its devices
        (``parallel/distributed.py``) through the ``cuda`` backend's kernels,
        and ``device`` is the mesh's first device."""
        self.params = params
        self.mesh = mesh
        self.device = _resolve_placement(device, mesh)
        self.backend = get_backend(backend, self.device)
        if mesh is not None and self.backend.name != "cuda":
            raise ValueError(f"a mesh runs the cuda backend's kernels, not {backend!r}")
        self.tie = tie
        self.device_walk = device_walk

    def _prepare(self, reads, refs) -> tuple[np.ndarray, np.ndarray]:
        if isinstance(reads, np.ndarray) and reads.dtype == np.uint8 and reads.ndim == 2:
            reads_enc = reads
        else:
            reads_enc = pad_and_encode(reads)
        if isinstance(refs, np.ndarray) and refs.dtype == np.uint8 and refs.ndim == 2:
            refs_enc = refs
        else:
            refs_enc = pad_and_encode(refs)
        if reads_enc.shape[0] != refs_enc.shape[0]:
            # Same validation as main.cpp:93-102.
            raise ValueError(
                f"read/ref counts differ: {reads_enc.shape[0]} vs {refs_enc.shape[0]}"
            )
        return reads_enc, refs_enc

    def score_alignments(self, algorithm: Algorithm, reads, refs) -> np.ndarray:
        with annotate("engine.score_alignments"):
            reads_enc, refs_enc = self._prepare(reads, refs)
            if self.mesh is not None:
                from versalignlib_tpu_torch.parallel.distributed import distributed_score_batch

                return distributed_score_batch(reads_enc, refs_enc, self.params, algorithm,
                                               mesh=self.mesh)
            return np.asarray(
                self.backend.score_alignments(algorithm, reads_enc, refs_enc, self.params),
                dtype=np.int32,
            )

    def compute_alignments(
        self, algorithm: Algorithm, reads, refs, raw: bool = False,
        gapped: bool = True,
    ) -> list[Alignment] | AlignmentBatch:
        """``raw=True`` (the ``cuda`` backend only): return the
        :class:`AlignmentBatch` column store instead of per-pair
        ``Alignment`` objects. ``gapped=False`` (raw only): CIGAR-only
        columns, no gapped strings."""
        with annotate("engine.compute_alignments"):
            reads_enc, refs_enc = self._prepare(reads, refs)
            if self.mesh is not None:
                if raw:
                    raise ValueError("raw alignment batches require the cuda backend "
                                     "without a mesh")
                from versalignlib_tpu_torch.parallel.distributed import distributed_align_batch

                return distributed_align_batch(reads_enc, refs_enc, self.params, algorithm,
                                               self.tie, mesh=self.mesh,
                                               device_walk=self.device_walk)
            if self.backend.name != "cuda":
                if raw:
                    raise ValueError("raw alignment batches require the cuda backend")
                return self.backend.compute_alignments(
                    algorithm, reads_enc, refs_enc, self.params, self.tie)
            return self.backend.compute_alignments(
                algorithm, reads_enc, refs_enc, self.params, self.tie,
                device_walk=self.device_walk, raw=raw, gapped=gapped,
            )


class OracleBackend:
    """The numpy oracles (``ops/oracle.py``, ``ops/gotoh.py``), pair by pair on
    the host: the semantic ground truth, available on every device."""

    name = "oracle"

    def is_available(self) -> bool:
        return True

    def score_alignments(self, algorithm, reads, refs, params):
        return oracle.score_alignments(algorithm, reads, refs, params)

    def compute_alignments(self, algorithm, reads, refs, params, tie):
        return oracle.compute_alignments(algorithm, reads, refs, params, tie)


register_backend("oracle", lambda device: OracleBackend(), priority=0)


def _cuda_factory(device: torch.device) -> Backend:
    from versalignlib_tpu_torch.ops.cuda_backend import CudaBackend

    return CudaBackend(device)


register_backend("cuda", _cuda_factory, priority=20)
