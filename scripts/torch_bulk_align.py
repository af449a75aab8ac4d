#!/usr/bin/env python
"""Bulk alignment pipeline on the cards of one process: millions of pairs,
restartable (the port's counterpart of ``scripts/bulk_align.py``, with the
same checkpoint files).

Pair chunks (synthetic, drawn from ``--seed`` per chunk as
``scripts/bulk_align.py`` draws them, or from FASTA/FASTQ files) go through
the score kernel (``--mode score``) or the pointer fill, the traceback walk
and the replay (``--mode align``); completed chunks are journaled
(``utils/checkpoint.ScoreCheckpoint``) so that a killed run resumes where
it left off.

``--mode score`` shards each chunk over a mesh of every card of the
process (``parallel.make_mesh()``; one card is a mesh of one shard), as
``scripts/bulk_align.py`` does, in a dispatch-ahead loop:
``io.prefetch_to_device(mesh=)`` stages chunk k+1's row shards in
page-locked memory and copies each to its card on a side stream while chunk
k scores, the score kernel is launched on every shard
(``parallel.distributed.score_shards``), each shard's scores are copied
back into page-locked memory behind its launch, at most two chunks are in
flight, and only the oldest is waited for. ``--no-prefetch`` copies each
shard from pageable memory and waits for its scores (the A/B).
``--mode align`` runs on one card and writes each chunk's alignments
(``AlignmentBatch.write_to``) to ``alignments_<chunk>.txt`` and its scores
to the checkpoint.

Everything runs on ``--device`` (default ``cuda``, which raises without a
card); ``--device cpu`` takes the plain PyTorch path (one shard).

Usage:
  python scripts/torch_bulk_align.py --pairs 10000000 --len 128 --ckpt /tmp/run1
  python scripts/torch_bulk_align.py --reads r.fa --refs f.fa --ckpt /tmp/run2 --mode align
"""

from __future__ import annotations

import argparse
import collections
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np


def synthetic_chunk(seed: int, chunk_index: int, n_pairs: int, length: int):
    rng = np.random.default_rng((seed, chunk_index))
    reads = rng.integers(1, 5, size=(n_pairs, length)).astype(np.uint8)
    refs = rng.integers(1, 5, size=(n_pairs, length)).astype(np.uint8)
    return reads, refs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pairs", type=int, default=0, help="synthetic pair count")
    ap.add_argument("--len", dest="length", type=int, default=128)
    ap.add_argument("--reads")
    ap.add_argument("--refs")
    ap.add_argument("--ckpt", required=True, help="checkpoint directory")
    ap.add_argument("--chunk", type=int, default=65536)
    ap.add_argument("--mode", choices=["score", "align"], default="score")
    ap.add_argument("--algorithm", choices=["sw", "nw"], default="sw")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-prefetch", action="store_true",
                    help="score mode: copy each chunk from pageable memory and wait "
                         "for it (the A/B of the dispatch-ahead loop)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the card (default; raises without one) or the plain path")
    args = ap.parse_args(argv)

    import torch

    from versalignlib_tpu_torch.alphabet import pad_and_encode
    from versalignlib_tpu_torch.dispatch import _resolve_device
    from versalignlib_tpu_torch.io.staging import prefetch_to_device
    from versalignlib_tpu_torch.ops import cuda_align, cuda_walk
    from versalignlib_tpu_torch.parallel import make_mesh
    from versalignlib_tpu_torch.parallel.distributed import (gather, on_device, score_shards,
                                                             shard_rows)
    from versalignlib_tpu_torch.params import AlignmentParameters
    from versalignlib_tpu_torch.types import Algorithm
    from versalignlib_tpu_torch.utils.checkpoint import ScoreCheckpoint
    from versalignlib_tpu_torch.utils.profiling import GcupsMeter

    device = _resolve_device(args.device)  # no card: RuntimeError
    cuda = device.type == "cuda"
    mesh = make_mesh(device=device)
    p = AlignmentParameters()
    algorithm = Algorithm.SMITH_WATERMAN if args.algorithm == "sw" else Algorithm.NEEDLEMAN_WUNSCH

    if args.pairs:
        total = args.pairs

        def get_chunk(c, lo, hi):
            return synthetic_chunk(args.seed, c, hi - lo, args.length)
    else:
        if not (args.reads and args.refs):
            ap.error("--pairs or (--reads and --refs) required")
        from versalignlib_tpu_torch.io.fastq import parse_sequences

        reads_all = pad_and_encode(parse_sequences(args.reads))
        refs_all = pad_and_encode(parse_sequences(args.refs))
        total = reads_all.shape[0]

        def get_chunk(c, lo, hi):
            return reads_all[lo:hi], refs_all[lo:hi]

    ckpt = ScoreCheckpoint(args.ckpt, total=total, chunk=args.chunk)
    pending = ckpt.pending_chunks()
    done = -(-total // args.chunk) - len(pending)
    print(f"{total} pairs, chunk {args.chunk}: {done} chunks done, "
          f"{len(pending)} pending; device={device} "
          f"mesh={mesh.size if args.mode == 'score' else 'no'}")
    pairs_run = sum(hi - lo for _, lo, hi in pending)

    def to_host(shards: list[torch.Tensor]) -> list[tuple]:
        """Each shard's scores on their way to the host: on a card a copy
        into page-locked memory queued behind its launch, and its event."""
        if not cuda:
            return [(s, None) for s in shards]
        out = []
        for scores, dev in zip(shards, mesh.devices):
            with on_device(dev):
                host = torch.empty(scores.shape, dtype=scores.dtype, pin_memory=True)
                host.copy_(scores, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(dev))
            out.append((host, ready))
        return out

    meter = GcupsMeter()
    t_start = time.perf_counter()

    if args.mode == "score" and not args.no_prefetch:
        staged = prefetch_to_device(
            ((c, lo, hi, *get_chunk(c, lo, hi)) for c, lo, hi in pending), depth=2, mesh=mesh)
        inflight: collections.deque = collections.deque()
        cells_total = 0

        def commit_oldest():
            c_, lo_, hi_, parts = inflight.popleft()
            for _, ready in parts:
                if ready is not None:
                    ready.synchronize()
            scores = gather([host for host, _ in parts])[:hi_ - lo_]
            ckpt.commit(c_, lo_, scores.astype(np.int32, copy=False))
            if (c_ % 8) == 0:
                rate = cells_total / max(time.perf_counter() - t_start, 1e-9)
                print(f"  chunk {c_}: {rate / 1e9:.1f} GCUPS aggregate")

        for c, lo, hi, r_sh, f_sh in staged:
            cells_total += (hi - lo) * r_sh[0].shape[1] * f_sh[0].shape[1]
            inflight.append((c, lo, hi, to_host(score_shards(r_sh, f_sh, p, algorithm, mesh))))
            if len(inflight) >= 2:
                commit_oldest()
        while inflight:
            commit_oldest()
        wall = time.perf_counter() - t_start
        print(f"DONE: {cells_total / max(wall, 1e-9) / 1e9:.3f} GCUPS aggregate; "
              f"wall {wall:.3f} s; pairs/sec {pairs_run / max(wall, 1e-9):.0f}")
        print("score sum:", int(ckpt.scores().sum()))
        return 0

    device_walk = cuda_walk.resolve_device_walk(None, device)
    for c, lo, hi in pending:
        reads, refs = get_chunk(c, lo, hi)
        cells = reads.shape[0] * reads.shape[1] * refs.shape[1]
        with meter.measure(cells):
            if args.mode == "score":
                r_sh, f_sh = ([torch.from_numpy(s).to(dev) for s, dev in
                               zip(shard_rows(x, mesh.size), mesh.devices)]
                              for x in (reads, refs))
                out = gather(score_shards(r_sh, f_sh, p, algorithm, mesh))[:hi - lo]
                scores = out.astype(np.int32, copy=False)
            else:
                # The raw column store: no per-pair Alignment objects.
                alns = cuda_align.align_batch(reads, refs, p, algorithm, device=device,
                                              raw=True, device_walk=device_walk)
                scores = np.asarray(alns.scores, dtype=np.int32)
                with open(pathlib.Path(args.ckpt) / f"alignments_{c:06d}.txt", "w") as f:
                    alns.write_to(f)
        ckpt.commit(c, lo, scores)
        if (c % 8) == 0:
            print(f"  chunk {c}: {meter.report()}")

    wall = time.perf_counter() - t_start
    print(f"DONE: {meter.report()}; wall {wall:.3f} s; "
          f"pairs/sec {pairs_run / max(wall, 1e-9):.0f}")
    print("score sum:", int(ckpt.scores().sum()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
