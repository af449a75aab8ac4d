"""Data-parallel batched alignment over a device mesh (the port's
counterpart of ``versalignlib_tpu/parallel/distributed.py``).

The pair batch splits into contiguous row shards, one per mesh device
(:mod:`versalignlib_tpu_torch.parallel.mesh`); every shard runs the port's
single-device kernels on its own device (on a card the hand-written ones,
on the CPU their plain versions), and the results come back to the host in
row order. The fills have no communication between shards; the trailing
gather is the only one.

Shard ``d`` holds rows ``[d * per, (d + 1) * per)`` of the batch padded with
all-invalid pairs (zero codes) to a multiple of the mesh size, the JAX
package's layout; the pad rows are dropped from every result.
"""

from __future__ import annotations

import contextlib
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from versalignlib_tpu_torch.ops import cuda_align
from versalignlib_tpu_torch.ops.cuda_backend import CudaBackend
from versalignlib_tpu_torch.ops.cuda_score import score_batch_device
from versalignlib_tpu_torch.parallel.mesh import Mesh, make_mesh
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm, Alignment, TieBreak
from versalignlib_tpu_torch.utils.profiling import count


def shard_rows(x: np.ndarray, size: int, min_per: int = 1) -> list[np.ndarray]:
    """The rows of ``x``, padded with zeros to a multiple of ``size`` (at
    least ``min_per`` rows a shard), as ``size`` equal contiguous shards."""
    x = np.ascontiguousarray(x)
    per = max(min_per, -(-x.shape[0] // size))
    pad = per * size - x.shape[0]
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
    return [x[d * per:(d + 1) * per] for d in range(size)]


def put(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``: on the CPU a view of it; on a card a copy from
    pageable memory, which the host waits for (kernels already queued on
    other cards keep running)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cpu":
        return t
    count("h2d_bytes", t.nbytes)
    return t.to(device)


def put_shards(x: np.ndarray, mesh: Mesh) -> list[torch.Tensor]:
    """The row shards of ``x`` (:func:`shard_rows`), shard d on device d."""
    return [put(s, dev) for s, dev in zip(shard_rows(x, mesh.size), mesh.devices)]


def on_device(device: torch.device):
    """The CUDA device guard of ``device`` (a no-op for the CPU), so that a
    kernel launched on a card's stream runs with that card current."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def gather(parts: list[torch.Tensor], dim: int = 0) -> np.ndarray:
    """Every shard's result on the host, concatenated along ``dim`` in shard
    order. Each copy waits for its own device only, so shards queued on
    other devices keep running."""
    host = [p.cpu() for p in parts]
    return (host[0] if len(host) == 1 else torch.cat(host, dim=dim)).numpy()


@functools.lru_cache(maxsize=None)
def _pool(devices: tuple[torch.device, ...]) -> ThreadPoolExecutor:
    """One thread for each of ``devices``, made at the first call on those
    devices and kept for the process's life."""
    return ThreadPoolExecutor(max_workers=len(devices), thread_name_prefix="mesh")


def map_shards(mesh: Mesh, fn) -> list:
    """``fn(d, device)`` for every shard d, each device's shards in order
    under its guard: in the caller's thread where the mesh has one distinct
    device (the CPU, or one card), else in one thread for each device (a
    pool kept for those devices), so that one card's host work overlaps
    another's kernels. Returns the results in shard order; an exception of
    any shard is raised."""
    by_device: dict[torch.device, list[int]] = {}
    for d, dev in enumerate(mesh.devices):
        by_device.setdefault(dev, []).append(d)

    def run(dev):
        with on_device(dev):
            return [(d, fn(d, dev)) for d in by_device[dev]]

    if len(by_device) == 1:
        done = run(mesh.devices[0])
    else:
        pool = _pool(tuple(by_device))
        futures = [pool.submit(run, dev) for dev in by_device]
        done = [pair for f in futures for pair in f.result()]
    out = [None] * mesh.size
    for d, result in done:
        out[d] = result
    return out


def _check_fits(mesh: Mesh, reads: np.ndarray, refs: np.ndarray,
                params: AlignmentParameters, mode: str) -> None:
    """Refuse pairs that exceed a card of the mesh under the kernel's plan,
    before any launch (``CudaBackend``'s gate, once a device)."""
    for dev in dict.fromkeys(mesh.devices):
        CudaBackend(dev)._check_dense_fits(reads, refs, params, mode)


def score_shards(reads: list[torch.Tensor], refs: list[torch.Tensor],
                 params: AlignmentParameters, algorithm: Algorithm,
                 mesh: Mesh) -> list[torch.Tensor]:
    """The score kernel (``csrc/score.cu``) launched on every shard's
    device, shard d's codes already there (:func:`put_shards`,
    ``io.prefetch_to_device(mesh=)``): each shard's (rows,) int32 scores on
    its device, none waited for."""
    outs = []
    for r, f, dev in zip(reads, refs, mesh.devices):
        with on_device(dev):
            outs.append(score_batch_device(r, f, params, algorithm))
    return outs


def distributed_score_batch(
    reads: np.ndarray,
    refs: np.ndarray,
    params: AlignmentParameters,
    algorithm: Algorithm,
    mesh: Mesh | None = None,
) -> np.ndarray:
    """Score a (B, m) x (B, n) code batch sharded over ``mesh`` (default:
    every card of the process): (B,) int32.

    Every shard's codes are queued to its device and the score kernel
    (``csrc/score.cu``) is launched on each shard's device before any result
    is waited for; the pad rows (score 0) are dropped. The JAX function's
    ``impl=`` is the mesh's devices here: a mesh of cards launches the
    kernel, a CPU mesh runs its plain version.
    """
    if mesh is None:
        mesh = make_mesh()
    reads = np.asarray(reads, dtype=np.uint8)
    refs = np.asarray(refs, dtype=np.uint8)
    b = reads.shape[0]
    if b == 0:
        return np.zeros(0, dtype=np.int32)
    _check_fits(mesh, reads, refs, params, "score")
    outs = score_shards(put_shards(reads, mesh), put_shards(refs, mesh), params,
                        Algorithm(algorithm), mesh)
    return gather(outs)[:b].astype(np.int32, copy=False)


def distributed_align_batch(
    reads: np.ndarray,
    refs: np.ndarray,
    params: AlignmentParameters,
    algorithm: Algorithm,
    tie: TieBreak = TieBreak.DIAG_UP_LEFT,
    mesh: Mesh | None = None,
    device_walk: bool | None = None,
) -> list[Alignment]:
    """Full alignment of a (B, m) x (B, n) code batch sharded over ``mesh``:
    B :class:`Alignment` in row order.

    Every shard runs the port's single-device align on its device
    (``CudaBackend.compute_alignments``): the pointer fill (``csrc/align.cu``,
    or ``csrc/align_affine.cu`` under affine gaps, never taken off the
    mesh), the traceback walk (on the card by default, ``device_walk``) and
    the host replay. Shards of different devices run in threads of their
    own; the pad rows are dropped.
    """
    if mesh is None:
        mesh = make_mesh()
    reads = np.asarray(reads, dtype=np.uint8)
    refs = np.asarray(refs, dtype=np.uint8)
    b = reads.shape[0]
    if b == 0:
        return []
    _check_fits(mesh, reads, refs, params, "align")
    r_sh = shard_rows(reads, mesh.size)
    f_sh = shard_rows(refs, mesh.size)
    parts = map_shards(mesh, lambda d, dev: CudaBackend(dev).compute_alignments(
        algorithm, r_sh[d], f_sh[d], params, tie, device_walk=device_walk))
    return [a for part in parts for a in part][:b]


def _unpack_codes(words: torch.Tensor, n: int) -> torch.Tensor:
    """(B, m, ceil(n/16)) int32 words of 2-bit move codes -> (B, m, n) uint8
    codes, code j of a row in bits ``2 * (j % 16)`` of word j // 16."""
    shifts = 2 * torch.arange(cuda_align.PACK, dtype=torch.int32, device=words.device)
    codes = (words.unsqueeze(-1) >> shifts) & 3
    return codes.reshape(*words.shape[:2], -1)[:, :, :n].to(torch.uint8)


def distributed_align_device(
    reads: np.ndarray,
    refs: np.ndarray,
    params: AlignmentParameters,
    algorithm: Algorithm,
    tie: TieBreak = TieBreak.DIAG_UP_LEFT,
    mesh: Mesh | None = None,
):
    """Sharded dense pointer fill, the JAX package's portable variant:
    ``(ptr (B, m, n) uint8, start_read_pos (B,), start_ref_pos (B,), best
    (B,))`` on the host, ``ptr[i, r, c]`` the move code of DP cell (r+1,
    c+1), the start cell and score those of ``ops/traceback.decode_batch``.

    Each shard's pointers come from the linear fill (``csrc/align.cu`` on a
    card), unpacked on its device from 2-bit words to one code a byte; the
    start cells come from the fill's aux word and ``hsel``. Linear gaps
    only, as the JAX variant's fill.
    """
    if params.affine:
        raise ValueError("distributed_align_device fills linear-gap pointers; affine "
                         "parameters go through distributed_align_batch")
    if mesh is None:
        mesh = make_mesh()
    algorithm = Algorithm(algorithm)
    tie = TieBreak(tie)
    reads = np.asarray(reads, dtype=np.uint8)
    refs = np.asarray(refs, dtype=np.uint8)
    b, m = reads.shape
    n = refs.shape[1]
    if b == 0:
        return (np.zeros((0, m, n), np.uint8),) + (np.zeros(0, np.int32),) * 3
    _check_fits(mesh, reads, refs, params, "align")
    r_sh, f_sh = shard_rows(reads, mesh.size), shard_rows(refs, mesh.size)
    mrps = [cuda_align.last_valid_pos(r, tie, params.matrix) for r in r_sh]
    outs = []
    for r, f, mrp, dev in zip(r_sh, f_sh, mrps, mesh.devices):
        with on_device(dev):
            ptr, aux, hsel = cuda_align.fill(put(r, dev), put(f, dev), put(mrp, dev),
                                             params, algorithm, tie)
            outs.append((_unpack_codes(ptr, n), aux, hsel))
    local = algorithm == Algorithm.SMITH_WATERMAN
    starts = [cuda_align.start_cells(aux.cpu().numpy(), None if hsel is None else
                                     hsel.cpu().numpy(), mrp, f, tie, local, params.matrix)
              for (_, aux, hsel), mrp, f in zip(outs, mrps, f_sh)]
    ptr = gather([p for p, _, _ in outs])[:b]
    start_r, start_f, best = (np.concatenate(col)[:b].astype(np.int32)
                              for col in zip(*starts))
    return ptr, start_r, start_f, best
