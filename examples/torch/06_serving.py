"""Online serving on the card: microbatching HTTP server + client round trip.

Starts an AlignServer in-process, sends concurrent requests, and shows the
batching stats. In production run `python -m versalignlib_tpu_torch.serve`
and put a load balancer in front of one server per card. The port's twin of
examples/06_serving.py.

    python examples/torch/06_serving.py [--device cuda|cpu]
"""

import argparse
import http.client
import json
import threading
import time

from versalignlib_tpu_torch import AlignmentEngine, AlignServer, BatchingAligner

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
device = ap.parse_args().device

# The dispatcher starts once all six concurrent requests are queued, so they
# coalesce into one device batch on every run and the output is the same
# whatever the timing.
aligner = BatchingAligner(AlignmentEngine(device=device), max_wait_ms=10, start=False)
with AlignServer(aligner, port=0) as server:
    server.start()
    host, port = server.address

    def post(path, body):
        conn = http.client.HTTPConnection(host, port, timeout=60)
        conn.request("POST", path, body=json.dumps(body))
        out = json.loads(conn.getresponse().read())
        conn.close()
        return out

    results = {}

    def client(i):
        results[i] = post("/v1/score", {
            "reads": ["ACGTACGTAC"] * 4, "refs": ["TTACGTACGTACTT"] * 4,
            "algorithm": "sw"})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    while aligner.stats()["requests"] < len(threads):
        time.sleep(0.001)
    aligner.start()
    for t in threads:
        t.join()
    print("scores per request:", {i: r["scores"][0] for i, r in
                                  sorted(results.items())})
    print("alignment:", post("/v1/align", {
        "reads": ["ACGTACGTAC"], "refs": ["TTACGTACGTACTT"]})
        ["alignments"][0]["cigar"])
    print("mapping:", post("/v1/map", {
        "reads": ["ACGTACGTAC"], "panel": ["TTACGTACGTACTT", "GGGGGGGG"]})
        ["hits"][0])

    conn = http.client.HTTPConnection(host, port, timeout=60)
    conn.request("GET", "/stats")
    stats = json.loads(conn.getresponse().read())
    conn.close()
    print(f"{stats['requests']} requests coalesced into "
          f"{stats['batches']} device batches")
