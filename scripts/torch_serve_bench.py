#!/usr/bin/env python
"""Serving benchmark of the port: p50/p90/p99 latency and throughput under
concurrent mixed score/align/map HTTP load (the port's counterpart of
``scripts/serve_bench.py``, at its mix).

- stands up ``AlignServer`` over a ``BatchingAligner`` in this process (a
  threading HTTP server in front, one dispatcher thread owning the device);
- drives it with N client threads over keep-alive HTTP connections, each
  issuing a random mix of POST /v1/score, /v1/align and /v1/map requests;
- runs every (endpoint, shape bucket) once off the clock first: on the card
  that builds the kernels (nvcc) and loads the native replay;
- checks served scores against the ``oracle`` backend before the timed
  window (a fast wrong server is not a result);
- reports per-endpoint p50/p90/p99/mean latency, request and pair
  throughput, the dispatcher's batching counters, the device share
  (``device_sum_s`` over the window: the dispatcher's busy share, host
  work included) split into the engine's score and align calls and the
  rest, the share of pairs and DP cells that
  the server's shape bucketing (``serve._bucket``) pads, and the align
  path's A/B: the raw column store against materialized ``Alignment``
  objects on 4096 pairs.

It runs on the card, or on the CPU only when asked (``--device cpu``); there
is no fallback. ``main(argv)`` returns 0 and, with ``--out``, writes the
result as JSON.

Usage: python scripts/torch_serve_bench.py [--duration 30] [--clients 8]
                                           [--device cuda|cpu] [--out result.json]
"""

from __future__ import annotations

import argparse
import http.client
import json
import statistics
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# Workload shapes (those of scripts/serve_bench.py). Lengths are drawn just
# under their power-of-two buckets, so the server's shape bucketing maps
# every request onto one bucket per endpoint. 60/30/10 mirrors a
# read-mapping service: mostly cheap rescoring, some tracebacks, occasional
# panel mapping.
SCORE_PAIRS = 32   # pairs per /v1/score request, reads<=128bp vs refs<=256bp
ALIGN_PAIRS = 8    # pairs per /v1/align request, 96-128bp
MAP_READS = 16     # reads per /v1/map request vs an 8-entry 256bp panel
MIX = (("score", 0.60), ("align", 0.30), ("map", 0.10))
AB_PAIRS = 4096    # pairs of the align path's A/B

PATHS = {"score": "/v1/score", "align": "/v1/align", "map": "/v1/map"}


def _rand_seq(rng, lo: int, hi: int) -> str:
    return "".join(rng.choice(list("ACGT"), size=int(rng.integers(lo, hi))))


def _make_bodies(rng, panel):
    """One request body per endpoint kind."""
    return {
        "score": {"reads": [_rand_seq(rng, 100, 129) for _ in range(SCORE_PAIRS)],
                  "refs": [_rand_seq(rng, 200, 257) for _ in range(SCORE_PAIRS)],
                  "algorithm": "sw"},
        "align": {"reads": [_rand_seq(rng, 96, 129) for _ in range(ALIGN_PAIRS)],
                  "refs": [_rand_seq(rng, 96, 129) for _ in range(ALIGN_PAIRS)],
                  "algorithm": "sw"},
        "map": {"reads": [_rand_seq(rng, 100, 129) for _ in range(MAP_READS)],
                "panel": panel, "algorithm": "sw", "both_strands": True,
                "align": False},
    }


def _map_cells(body) -> tuple[int, int]:
    """(real, dispatched) DP cells of one /v1/map request: the server pads
    the read count and both length axes to their buckets."""
    from versalignlib_tpu_torch.serve import _bucket

    reads, panel = body["reads"], body["panel"]
    strands = 2 if body["both_strands"] else 1
    real = sum(map(len, reads)) * sum(map(len, panel)) * strands
    padded = (_bucket(len(reads), floor=8) * _bucket(max(map(len, reads)))
              * len(panel) * _bucket(max(map(len, panel))) * strands)
    return real, padded


class EngineMeter:
    """The engine as the dispatcher calls it, counting the pairs and DP
    cells of every batch as dispatched (padded to their buckets) and as
    requested (rows of codes that are not all padding, each pair's cells
    its read length times its ref length), and the host seconds of each
    score and align call (each returns host arrays, so the card's work is
    inside). Every other attribute is the engine's."""

    def __init__(self, engine) -> None:
        self._engine = engine
        self._lock = threading.Lock()
        self.counts = {"pairs": 0, "real_pairs": 0, "cells": 0, "real_cells": 0,
                       "score_calls": 0, "score_s": 0.0, "align_calls": 0, "align_s": 0.0}

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def _count(self, reads, refs) -> None:
        rl = np.count_nonzero(reads, axis=1).astype(np.int64)
        fl = np.count_nonzero(refs, axis=1).astype(np.int64)
        with self._lock:
            c = self.counts
            c["pairs"] += reads.shape[0]
            c["real_pairs"] += int(np.count_nonzero(rl + fl))
            c["cells"] += reads.shape[0] * reads.shape[1] * refs.shape[1]
            c["real_cells"] += int((rl * fl).sum())

    def _timed(self, kind: str, t0: float) -> None:
        with self._lock:
            self.counts[f"{kind}_calls"] += 1
            self.counts[f"{kind}_s"] += time.perf_counter() - t0

    def score_alignments(self, algorithm, reads, refs):
        self._count(reads, refs)
        t0 = time.perf_counter()
        try:
            return self._engine.score_alignments(algorithm, reads, refs)
        finally:
            self._timed("score", t0)

    def compute_alignments(self, algorithm, reads, refs, **kw):
        self._count(reads, refs)
        t0 = time.perf_counter()
        try:
            return self._engine.compute_alignments(algorithm, reads, refs, **kw)
        finally:
            self._timed("align", t0)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.counts)


def _post(conn: http.client.HTTPConnection, path: str, body: dict):
    conn.request("POST", path, body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    if resp.status != 200:
        raise RuntimeError(f"{path} -> {resp.status}: {data[:200]!r}")
    return json.loads(data)


def _client_loop(addr, seed: int, stop: threading.Event, ready: threading.Event,
                 records: list, errors: list, panel) -> None:
    """One keep-alive client issuing the endpoint mix until ``stop``;
    records (kind, latency s, map cells (real, dispatched) or None)."""
    rng = np.random.default_rng(seed)
    conn = http.client.HTTPConnection(*addr, timeout=300)
    kinds = [k for k, _ in MIX]
    probs = [p for _, p in MIX]
    try:
        ready.wait()
        while not stop.is_set():
            kind = rng.choice(kinds, p=probs)
            body = _make_bodies(rng, panel)[kind]
            t0 = time.perf_counter()
            try:
                _post(conn, PATHS[kind], body)
            except Exception as exc:  # noqa: BLE001 (recorded and reported)
                errors.append(f"{kind}: {exc}")
                conn.close()
                conn = http.client.HTTPConnection(*addr, timeout=300)
                continue
            records.append((kind, time.perf_counter() - t0,
                            _map_cells(body) if kind == "map" else None))
    finally:
        conn.close()


def _percentiles(lat_s: list) -> dict:
    ms = sorted(v * 1e3 for v in lat_s)
    if not ms:
        return {}

    def pick(q):
        return ms[min(len(ms) - 1, int(q * len(ms)))]

    return {"count": len(ms), "p50_ms": pick(0.50), "p90_ms": pick(0.90),
            "p99_ms": pick(0.99), "mean_ms": statistics.fmean(ms), "max_ms": ms[-1]}


def align_path_ab(engine, rng) -> dict:
    """One batch of AB_PAIRS pairs of 120-128 bp aligned both ways after a
    warm-up: the raw column store with its JSON rows against materialized
    ``Alignment`` objects with theirs; the JSON must be equal."""
    from versalignlib_tpu_torch.serve import _alignment_json
    from versalignlib_tpu_torch.types import Algorithm

    sw = Algorithm.SMITH_WATERMAN
    ar = [_rand_seq(rng, 120, 129) for _ in range(AB_PAIRS)]
    af = [_rand_seq(rng, 120, 129) for _ in range(AB_PAIRS)]
    engine.compute_alignments(sw, ar, af, raw=True)
    engine.compute_alignments(sw, ar, af)
    t0 = time.perf_counter()
    batch = engine.compute_alignments(sw, ar, af, raw=True)
    rows_raw = batch.to_json_rows()
    t_raw = time.perf_counter() - t0
    t0 = time.perf_counter()
    objs = engine.compute_alignments(sw, ar, af)
    rows_obj = [_alignment_json(a) for a in objs]
    t_obj = time.perf_counter() - t0
    # The JSON stage alone, from the results already made.
    t0 = time.perf_counter()
    batch.to_json_rows()
    t_json_raw = time.perf_counter() - t0
    t0 = time.perf_counter()
    [_alignment_json(a) for a in objs]
    t_json_obj = time.perf_counter() - t0
    if rows_raw != rows_obj:
        raise AssertionError("raw column-store JSON differs from the materialized JSON")
    return {"pairs": AB_PAIRS, "raw_total_s": t_raw, "materialized_total_s": t_obj,
            "align_path_speedup_total": t_obj / t_raw,
            "json_stage_from_columns_s": t_json_raw,
            "json_stage_from_objects_s": t_json_obj, "identical_json": True}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--duration", type=float, default=30.0, help="timed load window, seconds")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the card (default; raises without one) or the plain path")
    ap.add_argument("--out", type=Path, help="write the result as JSON to this path")
    args = ap.parse_args(argv)

    import torch

    from versalignlib_tpu_torch.dispatch import AlignmentEngine
    from versalignlib_tpu_torch.serve import AlignServer, BatchingAligner
    from versalignlib_tpu_torch.types import Algorithm

    engine = AlignmentEngine(device=args.device)  # no card: RuntimeError
    kind = torch.cuda.get_device_name(engine.device) if engine.device.type == "cuda" else "cpu"
    print(f"[serve_bench] device={kind} backend={engine.backend.name}", file=sys.stderr)
    counter = EngineMeter(engine)

    rng = np.random.default_rng(7)
    panel = [_rand_seq(rng, 240, 257) for _ in range(8)]

    aligner = BatchingAligner(counter, max_wait_ms=args.max_wait_ms)
    with AlignServer(aligner) as server:
        server.start()
        addr = server.address
        conn = http.client.HTTPConnection(*addr, timeout=600)

        # Every (endpoint, bucket) once off the clock, and the coalesced
        # pair-count buckets of concurrent same-kind requests.
        t0 = time.perf_counter()
        bodies = _make_bodies(rng, panel)
        for k in ("score", "align", "map"):
            _post(conn, PATHS[k], bodies[k])
        for k in ("score", "align"):
            _post(conn, PATHS[k], {"reads": bodies[k]["reads"] * args.clients,
                                   "refs": bodies[k]["refs"] * args.clients,
                                   "algorithm": "sw"})
        warm_s = time.perf_counter() - t0
        print(f"[serve_bench] warmup {warm_s:.3f} s", file=sys.stderr)

        got = _post(conn, PATHS["score"], bodies["score"])["scores"]
        oracle = AlignmentEngine(backend="oracle", device=args.device)
        want = [int(v) for v in oracle.score_alignments(
            Algorithm.SMITH_WATERMAN, bodies["score"]["reads"], bodies["score"]["refs"])]
        if got != want:
            raise AssertionError("served scores differ from the oracle backend's")
        conn.close()

        stop, ready = threading.Event(), threading.Event()
        records: list = []   # list.append is atomic under the GIL
        errors: list = []
        threads = [threading.Thread(
            target=_client_loop, args=(addr, 100 + i, stop, ready, records, errors, panel),
            daemon=True) for i in range(args.clients)]
        for t in threads:
            t.start()
        stats0, pads0 = aligner.stats(), counter.snapshot()
        ready.set()
        t0 = time.perf_counter()
        time.sleep(args.duration)
        stop.set()
        for t in threads:
            t.join(timeout=120)
        elapsed = time.perf_counter() - t0
        stats1, pads1 = aligner.stats(), counter.snapshot()
        if any(t.is_alive() for t in threads):
            raise AssertionError("a client thread did not finish")

    ab = align_path_ab(engine, rng)
    print(f"[serve_bench] align-path A/B (warm): raw {ab['raw_total_s']:.4f} s vs "
          f"materialized {ab['materialized_total_s']:.4f} s "
          f"({ab['align_path_speedup_total']:.3f}x)", file=sys.stderr)

    by_kind = {k: [dt for kk, dt, _ in records if kk == k] for k in PATHS}
    pairs = {"score": SCORE_PAIRS, "align": ALIGN_PAIRS, "map": MAP_READS}
    total_pairs = sum(pairs[k] * len(v) for k, v in by_kind.items())
    batches = stats1["batches"] - stats0["batches"]
    requests = stats1["requests"] - stats0["requests"]
    pads = {k: pads1[k] - pads0[k] for k in pads1}
    map_cells = [c for kk, _, c in records if kk == "map"]
    map_real, map_padded = (sum(c[i] for c in map_cells) for i in (0, 1))
    device_s = stats1["device_sum_s"] - stats0["device_sum_s"]
    result = {
        "device": {"platform": "gpu" if engine.device.type == "cuda" else "cpu",
                   "kind": kind},
        "backend": engine.backend.name,
        "clients": args.clients,
        "duration_s": elapsed,
        "max_wait_ms": args.max_wait_ms,
        "mix": dict(MIX),
        "warmup_s": warm_s,
        "requests_total": len(records),
        "requests_per_s": len(records) / elapsed,
        "pairs_per_s": total_pairs / elapsed,
        "errors": len(errors),
        "latency": {k: _percentiles(v) for k, v in by_kind.items()},
        "batching": {
            "batches": batches,
            "mean_batch_pairs": (stats1["batched_pairs"] - stats0["batched_pairs"])
            / max(1, batches),
            "mean_device_batch_ms": (stats1["latency_sum_s"] - stats0["latency_sum_s"])
            / max(1, batches) * 1e3,
            "mean_queue_wait_ms": (stats1["queue_wait_sum_s"] - stats0["queue_wait_sum_s"])
            / max(1, requests) * 1e3,
            "max_queue_wait_ms": stats1["queue_wait_max_s"] * 1e3,
            "device_sum_s": device_s,
            "device_share": device_s / elapsed,
            "align_path": "raw AlignmentBatch column store"
            if engine.backend.name == "cuda" else "Alignment objects",
        },
        # The dispatcher's batch time split: the engine's score and align
        # calls, and the rest (map requests, encoding, slicing).
        "dispatcher_s": {
            "score_calls": pads["score_calls"], "score_s": pads["score_s"],
            "align_calls": pads["align_calls"], "align_s": pads["align_s"],
            "rest_s": device_s - pads["score_s"] - pads["align_s"]},
        # Score and align batches as dispatched against as requested; map
        # requests from their bodies (_map_cells).
        "bucket_padding": {
            "score_align_pairs": pads["pairs"], "score_align_real_pairs": pads["real_pairs"],
            "score_align_padded_pair_share": 1 - pads["real_pairs"] / max(1, pads["pairs"]),
            "score_align_cells": pads["cells"], "score_align_real_cells": pads["real_cells"],
            "score_align_padded_cell_share": 1 - pads["real_cells"] / max(1, pads["cells"]),
            "map_cells": map_padded, "map_real_cells": map_real,
            "map_padded_cell_share": 1 - map_real / max(1, map_padded),
        },
        "align_path_ab": ab,
    }
    if errors:
        result["error_samples"] = errors[:5]
    if args.out is not None:
        args.out.write_text(json.dumps(result, indent=2) + "\n")
    print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
