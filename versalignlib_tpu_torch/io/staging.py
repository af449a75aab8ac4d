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
    """
    if depth < 1:
        raise ValueError("depth must be >= 1")
    from versalignlib_tpu_torch.dispatch import _resolve_device

    device = _resolve_device(device)
    if device.type == "cpu":
        yield from _ahead(chunks, depth, lambda item: tuple(
            torch.from_numpy(x) if isinstance(x, np.ndarray) else x for x in item))
        return

    side = torch.cuda.Stream(device)
    in_flight: collections.deque = collections.deque()  # (event, page-locked sources)

    def stage(item: tuple):
        out, sources = [], []
        with torch.cuda.stream(side):
            for x in item:
                if isinstance(x, np.ndarray):
                    src = torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
                    sources.append(src)
                    out.append(src.to(device, non_blocking=True))
                else:
                    out.append(x)
            done = torch.cuda.Event()
            done.record(side)
        in_flight.append((done, sources))
        return tuple(out), done

    try:
        for staged, done in _ahead(chunks, depth, stage):
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for x in staged:
                if isinstance(x, torch.Tensor):
                    x.record_stream(consumer)
            while in_flight and in_flight[0][0].query():
                in_flight.popleft()
            yield staged
    finally:
        for done, _ in in_flight:
            done.synchronize()


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
