#!/usr/bin/env python
"""Multi-process alignment over torch.distributed (the port's
counterpart of ``scripts/multihost_align.py``).

Start one copy per process; together they score and align a shared pair
batch with no pointer traffic between processes
(``versalignlib_tpu_torch/parallel/multihost.py``). Each process runs its
slice on a mesh of its own devices (``multihost.local_mesh``): under
``torchrun`` the node's cards dealt out among its processes (local rank r of
L takes cards r, r + L, ...), else every card it sees (restrict them with
``CUDA_VISIBLE_DEVICES``), or with ``--cpu-devices N`` N shards on the CPU.

With ``torchrun`` (which sets the ``env://`` variables and ``LOCAL_RANK``):

    torchrun --nproc-per-node 2 scripts/torch_multihost_align.py \\
        --reads reads.fa --refs refs.fa --outdir out/

With an explicit rendezvous, one command a process:

    python scripts/torch_multihost_align.py ... --coordinator localhost:9911 \\
        --num-processes 2 --process-id $i [--cpu-devices 2]

The collective backend is NCCL for processes on cards of their own and gloo
on the CPU (``--collective``; processes that share one card must take
gloo: NCCL refuses two ranks on one card). Nothing falls back to another.

Outputs (the extended CLI formats, byte for byte those of the JAX script):
process 0 writes ``scores_<algo>.txt`` for the whole batch (the scores are
all-gathered); every process writes
``alignments_<algo>.part<pid>-of<n>.txt`` for its contiguous slice; process
0 writes ``manifest.json``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reads", required=True)
    ap.add_argument("--refs", required=True)
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--algorithm", choices=["sw", "nw", "both"], default="both")
    ap.add_argument("--mode", choices=["score", "align", "both"], default="both")
    ap.add_argument("--match", type=int, default=2)
    ap.add_argument("--mismatch", type=int, default=-1)
    ap.add_argument("--gap-read", type=int, default=-3)
    ap.add_argument("--gap-ref", type=int, default=-3)
    ap.add_argument("--gap-open", type=int, default=0,
                    help="affine gap-open penalty (0 = linear)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port rendezvous (omit under torchrun: env://)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the process's cards (default; raises without one) or the CPU")
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="a mesh of N shards on the CPU (implies --device cpu)")
    ap.add_argument("--collective", choices=["nccl", "gloo"], default=None,
                    help="collective backend (default: nccl on cards, gloo on the CPU)")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from versalignlib_tpu_torch.alphabet import pad_and_encode
    from versalignlib_tpu_torch.cli import OUT_FILES, _write_alignments, _write_scores
    from versalignlib_tpu_torch.io.fasta import parse_fasta
    from versalignlib_tpu_torch.parallel import multihost
    from versalignlib_tpu_torch.params import AlignmentParameters
    from versalignlib_tpu_torch.types import Algorithm

    device = "cpu" if args.cpu_devices else args.device
    mesh = multihost.local_mesh(args.cpu_devices or None, device=device)
    collective = args.collective or ("nccl" if mesh.is_cuda else "gloo")
    if mesh.is_cuda:
        torch.cuda.set_device(mesh.devices[0])
    multihost.initialize(args.coordinator, args.num_processes, args.process_id,
                         backend=collective)
    pid, nproc = dist.get_rank(), dist.get_world_size()

    reads = parse_fasta(args.reads)
    refs = parse_fasta(args.refs)
    if len(reads) != len(refs):
        print(f"Read count ({len(reads)}) does not equal ref count ({len(refs)})",
              file=sys.stderr)
        return 1
    r_enc = pad_and_encode(reads)
    f_enc = pad_and_encode(refs)
    params = AlignmentParameters(
        score_match=args.match, score_mismatch=args.mismatch,
        score_gap_read=args.gap_read, score_gap_ref=args.gap_ref,
        gap_open_read=args.gap_open, gap_open_ref=args.gap_open,
    )

    outdir = pathlib.Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    algos = {"sw": [Algorithm.SMITH_WATERMAN],
             "nw": [Algorithm.NEEDLEMAN_WUNSCH],
             "both": [Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH]}[args.algorithm]
    manifest = {"pairs": len(reads), "processes": nproc,
                "devices": multihost.device_count(mesh), "outputs": []}

    for algorithm in algos:
        t0 = time.perf_counter()
        if args.mode in ("score", "both"):
            scores = multihost.multihost_score_batch(r_enc, f_enc, params, algorithm,
                                                     mesh=mesh)
            if pid == 0:
                path = outdir / OUT_FILES[(algorithm, "score")]
                _write_scores(path, reads, refs, scores)
                manifest["outputs"].append(path.name)
        if args.mode in ("align", "both"):
            alns, lo, hi = multihost.multihost_align_batch(r_enc, f_enc, params, algorithm,
                                                           mesh=mesh)
            base = OUT_FILES[(algorithm, "align")].removesuffix(".txt")
            _write_alignments(outdir / f"{base}.part{pid:03d}-of{nproc:03d}.txt", alns)
            # Slices are deterministic, so process 0 lists every process's
            # shard without communicating.
            manifest["outputs"].extend(
                {"file": f"{base}.part{p:03d}-of{nproc:03d}.txt",
                 "rows": list(multihost.process_slice(len(reads), p, nproc))}
                for p in range(nproc))
        print(f"[{pid}/{nproc}] {algorithm.name}: {len(reads)} pairs "
              f"in {time.perf_counter() - t0:.3f} s", flush=True)

    if pid == 0:
        (outdir / "manifest.json").write_text(json.dumps(manifest, indent=1))
    # Every process reaches the end before process 0 exits.
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
