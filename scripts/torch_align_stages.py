"""Where the time of ``compute_alignments`` goes on the card, stage by stage.

    python3 scripts/torch_align_stages.py [--seed N] [--pairs B]

For B pairs of 512 x 512 (SW, canonical flavor, default 4096) it times, with
the host clock and a synchronise after each stage, the steps that
``ops/cuda_align.align_batch`` takes for one chunk: host preparation
(slicing, last valid rows), host-to-device copies, the fill, the page-locked
host buffers, the device-to-host copy, the start cells and the native
decode. It then times ``align_batch`` whole, in one chunk and in chunks of
B/2, alternating, and prints the top host-side operations of one call
under ``torch.profiler``. One JSON line per measurement; medians of 7 after
a warm-up.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from versalignlib_tpu_torch.native import decode_batch_native  # noqa: E402
from versalignlib_tpu_torch.ops import cuda_align  # noqa: E402
from versalignlib_tpu_torch.params import DEFAULT_PARAMETERS as P  # noqa: E402
from versalignlib_tpu_torch.types import Algorithm, TieBreak  # noqa: E402

REPS = 7


def stages(r_np, f_np, dev) -> dict:
    """One chunk's steps, each timed on the host clock after a synchronise."""
    sw, tie = Algorithm.SMITH_WATERMAN, TieBreak.DIAG_UP_LEFT
    t = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t[name] = 1e3 * (time.perf_counter() - t0)
        return out

    r_c, f_c, mrp = step("host_prep", lambda: (
        np.ascontiguousarray(r_np), np.ascontiguousarray(f_np),
        cuda_align.last_valid_pos(r_np, tie)))
    r, f, mrp_d = step("h2d", lambda: tuple(
        torch.from_numpy(x).to(dev) for x in (r_c, f_c, mrp)))
    ptr, aux, _ = step("fill", lambda: cuda_align.fill(r, f, mrp_d, P, sw, tie))
    host = step("pinned_alloc", lambda: [
        torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in (ptr, aux)])
    step("d2h", lambda: [h.copy_(x, non_blocking=True) for h, x in zip(host, (ptr, aux))])
    start_r, start_f, scores = step("start_cells", lambda: cuda_align.start_cells(
        host[1].numpy(), None, mrp, f_c, tie, True))
    step("decode", lambda: decode_batch_native(
        (host[0].numpy(), cuda_align.PACK), r_c, f_c, start_r, start_f, P, sw,
        scores, raw=True))
    return t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pairs", type=int, default=4096)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.nvidia_smi_line(), flush=True)
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda", 0)
    b = args.pairs
    r_np = chip_smoke.random_codes(rng, b, 512)
    f_np = chip_smoke.random_codes(rng, b, 512)

    stages(r_np, f_np, dev)  # warm-up: builds, allocator caches
    runs = [stages(r_np, f_np, dev) for _ in range(REPS)]
    print(json.dumps({"stages_ms": {k: statistics.median(x[k] for x in runs)
                                    for k in runs[0]}, "pairs": b, "k": REPS}),
          flush=True)

    def whole(chunk):
        return lambda: cuda_align.align_batch(
            r_np, f_np, P, Algorithm.SMITH_WATERMAN, device=dev,
            chunk_pairs=chunk, raw=True)

    times = {b: [], b // 2: []}
    for chunk in times:
        whole(chunk)()
    for _ in range(REPS):
        for chunk in times:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            whole(chunk)()
            torch.cuda.synchronize()
            times[chunk].append(1e3 * (time.perf_counter() - t0))
    for chunk, ts in times.items():
        print(json.dumps({"align_batch_ms": statistics.median(ts), "min": min(ts),
                          "max": max(ts), "chunk_pairs": chunk, "pairs": b,
                          "k": REPS}), flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        whole(b)()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: -e.cpu_time_total)[:12]
    print(json.dumps({"profiler_top_cpu": [
        {"name": e.key, "cpu_ms": e.cpu_time_total / 1e3, "calls": e.count,
         "device_ms": getattr(e, "device_time_total", 0) / 1e3} for e in rows]}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
