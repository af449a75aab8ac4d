"""Multi-process data parallelism over ``torch.distributed`` (the port's
counterpart of ``versalignlib_tpu/parallel/multihost.py``).

Every process parses the same inputs and owns one contiguous slice of the
pair batch (:func:`process_slice`), which it runs on its own local mesh
(:func:`local_mesh`, :mod:`versalignlib_tpu_torch.parallel.distributed`):

- **Scoring**: each process scores its slice, then one ``all_gather`` gives
  every process the whole (B,) int32 vector, 4 bytes a pair.
- **Alignment** stays in the process: each aligns its slice and writes its
  own result shard. No pointer byte crosses processes.

The collective backend is chosen by the caller from the devices, never
retried with another: ``"nccl"`` when each process has cards of its own,
``"gloo"`` (CPU tensors) when processes run on the CPU or share a card (NCCL
refuses two ranks on one card).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from versalignlib_tpu_torch.parallel.distributed import (distributed_align_batch,
                                                         distributed_score_batch)
from versalignlib_tpu_torch.parallel.mesh import Mesh, make_mesh
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm, Alignment, TieBreak

BACKENDS = ("nccl", "gloo")


def _local_rank() -> tuple[int, int]:
    """(this process's rank on its node, the node's process count), from
    the ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` that ``torchrun`` sets;
    (0, 1) where they are not set."""
    if "LOCAL_RANK" not in os.environ:
        return 0, 1
    return int(os.environ["LOCAL_RANK"]), int(os.environ.get("LOCAL_WORLD_SIZE", "1"))


def local_mesh(n_devices: int | None = None, device: torch.device | str = "cuda") -> Mesh:
    """This process's own devices as a mesh.

    On the CPU, ``n_devices`` shards (default 1), as ``make_mesh`` gives
    them. On cards, under ``torchrun`` (``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` set) the node's cards are dealt out among its L
    processes, local rank r taking cards r, r + L, r + 2L, ...; on a node
    with more processes than cards, rank r shares card r % cards with
    others (gloo only: :func:`initialize` refuses NCCL there). Without
    those variables, every card the process sees (restrict them with
    ``CUDA_VISIBLE_DEVICES``). Then the first ``n_devices`` of those.
    """
    if torch.device(device).type != "cuda":
        return make_mesh(n_devices, device=device)
    cards = make_mesh().devices
    rank, local = _local_rank()
    mine = cards[rank::local] or (cards[rank % len(cards)],)
    return make_mesh(n_devices, devices=mine)


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str = "nccl",
) -> None:
    """Join the process group (idempotent).

    With a coordinator ``host:port``, the process count and this process's
    id, the group meets through a TCP store there; with no arguments it
    reads the ``env://`` variables that ``torchrun`` sets (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). ``backend`` is ``"nccl"``
    (each process on cards of its own, :func:`local_mesh`; the caller makes
    its first card current) or ``"gloo"``. NCCL is refused where the node
    has more ``torchrun`` processes than cards, since some would share one.
    """
    if dist.is_initialized():
        return
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs a card, and none is available "
                               "(torch.cuda.is_available() is False)")
        local, cards = _local_rank()[1], torch.cuda.device_count()
        if local > cards:
            raise ValueError(f"{local} processes on this node share {cards} card(s), and "
                             "NCCL refuses two ranks on one card: use the gloo backend")
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)


def process_slice(b: int, process_id: int | None = None,
                  num_processes: int | None = None) -> tuple[int, int]:
    """Contiguous ``[lo, hi)`` row range of a B-pair batch owned by one
    process, balanced to within one pair; trailing processes may own an
    empty range when B < the process count."""
    p = dist.get_rank() if process_id is None else process_id
    n = dist.get_world_size() if num_processes is None else num_processes
    return (b * p) // n, (b * (p + 1)) // n


def _collective_device() -> torch.device:
    """Where the group's tensors live: this process's current card under
    NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def device_count(mesh: Mesh) -> int:
    """The mesh devices of every process together (each process passes its
    own local mesh)."""
    total = torch.tensor([mesh.size], dtype=torch.int64, device=_collective_device())
    dist.all_reduce(total)
    return int(total.item())


def multihost_score_batch(
    reads: np.ndarray,
    refs: np.ndarray,
    params: AlignmentParameters,
    algorithm: Algorithm,
    mesh: Mesh | None = None,
) -> np.ndarray:
    """Score a global (B, m) x (B, n) code batch across all processes.

    ``reads`` and ``refs`` are the same on every process. Each scores its
    :func:`process_slice` on ``mesh`` (default: :func:`local_mesh`)
    through :func:`distributed_score_batch`; the slices, padded to the
    longest, are all-gathered, and every process returns the whole (B,)
    int32 vector.
    """
    reads = np.asarray(reads)
    b = reads.shape[0]
    world = dist.get_world_size()
    lo, hi = process_slice(b)
    local = distributed_score_batch(reads[lo:hi], np.asarray(refs)[lo:hi], params,
                                    algorithm, mesh=mesh if mesh is not None else local_mesh())
    per = -(-b // world)
    dev = _collective_device()
    mine = torch.zeros(per, dtype=torch.int32, device=dev)
    mine[:hi - lo] = torch.from_numpy(local).to(dev)
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine)
    rows = [hi_p - lo_p for lo_p, hi_p in (process_slice(b, p, world) for p in range(world))]
    return torch.cat([part[:k] for part, k in zip(parts, rows)]).cpu().numpy()


def multihost_align_batch(
    reads: np.ndarray,
    refs: np.ndarray,
    params: AlignmentParameters,
    algorithm: Algorithm,
    tie: TieBreak = TieBreak.DIAG_UP_LEFT,
    mesh: Mesh | None = None,
    device_walk: bool | None = None,
) -> tuple[list[Alignment], int, int]:
    """Full alignment of a global batch; this process aligns its
    :func:`process_slice` on ``mesh`` (default: :func:`local_mesh`).

    Returns ``(alignments, lo, hi)``, the alignments of global rows ``[lo,
    hi)``. Pointer words and walk records never leave the process that made
    them; callers write one result shard a process.
    """
    reads = np.asarray(reads)
    refs = np.asarray(refs)
    lo, hi = process_slice(reads.shape[0])
    if lo == hi:
        return [], lo, hi
    alns = distributed_align_batch(reads[lo:hi], refs[lo:hi], params, algorithm, tie=tie,
                                   mesh=mesh if mesh is not None else local_mesh(),
                                   device_walk=device_walk)
    return alns, lo, hi
