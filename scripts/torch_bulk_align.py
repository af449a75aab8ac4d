#!/usr/bin/env python
"""Bulk alignment pipeline on one card: millions of pairs, restartable (the
port's counterpart of ``scripts/bulk_align.py``, in its single-device form,
with the same checkpoint files).

Pair chunks (synthetic, drawn from ``--seed`` per chunk as
``scripts/bulk_align.py`` draws them, or from FASTA/FASTQ files) go through
the score kernel (``--mode score``) or the pointer fill, the traceback walk
and the replay (``--mode align``); completed chunks are journaled
(``utils/checkpoint.ScoreCheckpoint``) so that a killed run resumes where
it left off.

``--mode score`` runs a dispatch-ahead loop: ``io.prefetch_to_device``
stages chunk k+1's codes in page-locked memory and copies them on a side
stream while chunk k scores, each chunk's scores are copied back into
page-locked memory behind its launch, at most two chunks are in flight,
and only the oldest is waited for. ``--no-prefetch`` copies each chunk
from pageable memory and waits for its scores (the A/B). ``--mode align``
writes each chunk's alignments (``AlignmentBatch.write_to``) to
``alignments_<chunk>.txt`` and its scores to the checkpoint.

Everything runs on ``--device`` (default ``cuda``, which raises without a
card); ``--device cpu`` takes the plain PyTorch path. The JAX script's mesh
path (several devices, ``distributed_score_batch``) is not here: it comes
with the port's multi-device layer.

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
    from versalignlib_tpu_torch.ops.cuda_score import score_batch_device
    from versalignlib_tpu_torch.params import AlignmentParameters
    from versalignlib_tpu_torch.types import Algorithm
    from versalignlib_tpu_torch.utils.checkpoint import ScoreCheckpoint
    from versalignlib_tpu_torch.utils.profiling import GcupsMeter

    device = _resolve_device(args.device)  # no card: RuntimeError
    cuda = device.type == "cuda"
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
          f"{len(pending)} pending; device={device}")
    pairs_run = sum(hi - lo for _, lo, hi in pending)

    def to_host(scores: torch.Tensor):
        """The scores on their way to the host: on the card a copy into
        page-locked memory queued behind the launch, and its event."""
        if not cuda:
            return scores, None
        host = torch.empty(scores.shape, dtype=scores.dtype, pin_memory=True)
        host.copy_(scores, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(device))
        return host, ready

    meter = GcupsMeter()
    t_start = time.perf_counter()

    if args.mode == "score" and not args.no_prefetch:
        staged = prefetch_to_device(
            ((c, lo, *get_chunk(c, lo, hi)) for c, lo, hi in pending), depth=2, device=device)
        inflight: collections.deque = collections.deque()
        cells_total = 0

        def commit_oldest():
            c_, lo_, (host, ready) = inflight.popleft()
            if ready is not None:
                ready.synchronize()
            ckpt.commit(c_, lo_, host.numpy().astype(np.int32, copy=False))
            if (c_ % 8) == 0:
                rate = cells_total / max(time.perf_counter() - t_start, 1e-9)
                print(f"  chunk {c_}: {rate / 1e9:.1f} GCUPS aggregate")

        for c, lo, r_d, f_d in staged:
            cells_total += r_d.shape[0] * r_d.shape[1] * f_d.shape[1]
            inflight.append((c, lo, to_host(score_batch_device(r_d, f_d, p, algorithm))))
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
                out = score_batch_device(torch.from_numpy(reads).to(device),
                                         torch.from_numpy(refs).to(device), p, algorithm)
                scores = out.cpu().numpy().astype(np.int32, copy=False)
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
