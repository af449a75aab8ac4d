"""Asynchronous device staging: host-to-device copies ahead of the consumer
(the port's counterpart of ``versalignlib_tpu/io/staging.py``).

The reference's closest analogue is the OpenCL host path's zero-copy
``CL_MEM_USE_HOST_PTR`` buffers per batch (OpenCLKernel.cpp:68-74), which
are synchronous. Here each array is copied into page-locked memory and sent
to the card on a side CUDA stream, so chunk k+1 crosses PCIe while chunk k
computes, and the copy runs at the page-locked rate rather than through the
pageable staging of CUDA's copy engine.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch


def prefetch_to_device(
    chunks: Iterable[tuple],
    depth: int = 2,
    device: torch.device | str = "cuda",
    mesh=None,
) -> Iterator[tuple]:
    """Yield each chunk with its ndarrays staged on ``device``, ``depth``
    chunks ahead of the one being consumed.

    Non-array elements (indices, metadata) pass through untouched, and the
    order is kept. On a CUDA device each array is copied into a page-locked
    tensor and sent with ``non_blocking=True`` on a side stream; the copy
    records an event, the consumer's stream waits on it when the chunk is
    yielded, and each staged tensor is ``record_stream``-ed on the consumer's
    stream so that the caching allocator never hands its memory to the side
    stream while the consumer still reads it. The page-locked sources stay
    referenced until their copies have finished. With ``device="cpu"`` the
    arrays come back as ``torch.from_numpy`` views. ``depth`` bounds device
    memory: at most ``depth`` chunks are staged beyond the one consumed.

    ``mesh`` (in place of ``device``, where the JAX function takes a
    ``sharding``): each array becomes the list of its row shards, shard d
    on the mesh's device d, in the layout of ``parallel/distributed.py``
    (rows padded with zeros to a multiple of the mesh size, equal
    contiguous shards), each staged as above on a side stream of its own
    device.
    """
    if depth < 1:
        raise ValueError("depth must be >= 1")
    from versalignlib_tpu_torch.dispatch import _resolve_placement
    from versalignlib_tpu_torch.parallel.distributed import shard_rows

    first = _resolve_placement(device, mesh)
    devices = (first,) if mesh is None else mesh.devices

    def pieces(x: np.ndarray) -> list[np.ndarray]:
        return [x] if mesh is None else shard_rows(x, mesh.size)

    def as_given(staged: list):
        """One tensor without a mesh, the list of its shards with one."""
        return staged[0] if mesh is None else staged

    if first.type == "cpu":
        yield from _ahead(chunks, depth, lambda item: tuple(
            as_given([torch.from_numpy(p) for p in pieces(x)]) if isinstance(x, np.ndarray)
            else x for x in item))
        return

    sides = {dev: torch.cuda.Stream(dev) for dev in dict.fromkeys(devices)}
    in_flight: collections.deque = collections.deque()  # (events, page-locked sources)

    def stage(item: tuple):
        out, sources, copies = [], [], []
        for x in item:
            if not isinstance(x, np.ndarray):
                out.append(x)
                continue
            staged = []
            for piece, dev in zip(pieces(x), devices):
                src = torch.from_numpy(np.ascontiguousarray(piece)).pin_memory()
                sources.append(src)
                with torch.cuda.stream(sides[dev]):
                    staged.append(src.to(dev, non_blocking=True))
            copies += staged
            out.append(as_given(staged))
        done = []
        for dev, side in sides.items():
            event = torch.cuda.Event()
            event.record(side)
            done.append((dev, event))
        in_flight.append((done, sources))
        return tuple(out), done, copies

    try:
        for staged, done, copies in _ahead(chunks, depth, stage):
            for dev, event in done:
                torch.cuda.current_stream(dev).wait_event(event)
            for x in copies:
                x.record_stream(torch.cuda.current_stream(x.device))
            while in_flight and all(e.query() for _, e in in_flight[0][0]):
                in_flight.popleft()
            yield staged
    finally:
        for done, _ in in_flight:
            for _, event in done:
                event.synchronize()


def _ahead(chunks: Iterable[tuple], depth: int, stage) -> Iterator:
    """``stage(item)`` of each chunk in order, called ``depth`` chunks before
    the result is taken."""
    queue: collections.deque = collections.deque()
    it = iter(chunks)
    for item in it:
        queue.append(stage(item))
        if len(queue) == depth:
            break
    while queue:
        out = queue.popleft()
        for item in it:
            queue.append(stage(item))
            break
        yield out


class PinnedBuffers:
    """Page-locked host buffers, one a slot, that a path's copies take in
    turn and keep across calls, since pinning memory takes longer than the
    copy it speeds up (a fresh ``pin_memory()`` a chunk made the search
    paths slower). A slot grows when a call needs more; a buffer of more
    than ``limit`` bytes (None: no limit) serves its call only.
    :meth:`release` gives the kept buffers back."""

    def __init__(self, slots: int, limit: int | None = None):
        self.limit = limit
        self._bufs: list[torch.Tensor | None] = [None] * slots

    def take(self, slot: int, shape: tuple, dtype=torch.int32) -> torch.Tensor:
        nbytes = int(np.prod(shape)) * dtype.itemsize
        buf = self._bufs[slot]
        if buf is None or buf.numel() < nbytes:
            self._bufs[slot] = None   # free the smaller buffer first
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
            if self.limit is None or nbytes <= self.limit:
                self._bufs[slot] = buf
        return buf[:nbytes].view(dtype).view(shape)

    def release(self) -> None:
        self._bufs = [None] * len(self._bufs)
