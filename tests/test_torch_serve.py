"""The port's server (``versalignlib_tpu_torch/serve.py``) against the JAX
package's: the same request bodies give equal JSON replies and status codes,
on the JAX side over ``AlignmentEngine(backend="oracle")`` and on the port's
over the ``oracle`` backend and over the ``cuda`` backend's raw column-store
path on the CPU (the plain PyTorch kernels' versions). Then the batching
behaviour of ``tests/test_serve.py`` on the port: coalescing, scatter,
validation, backpressure, a single dispatcher thread, close under traffic,
the ``/stats`` split, and no quiet fallback from the raw path."""

import http.client
import json
import queue
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from versalignlib_tpu import serve as jax_serve
from versalignlib_tpu.dispatch import AlignmentEngine as JaxEngine
from versalignlib_tpu_torch import AlignmentEngine, map_reads, serve
from versalignlib_tpu_torch.alphabet import reverse_complement
from versalignlib_tpu_torch.serve import AlignServer, BatchingAligner, _bucket, parse_algorithm
from versalignlib_tpu_torch.types import Algorithm, AlignmentBatch

_SW = Algorithm.SMITH_WATERMAN
_LIMITS = dict(max_request_pairs=16, max_map_cross=500)


def _pairs(rng, n, lo=8, hi=24):
    bases = np.array(list("ACGTN"))
    p = [0.24, 0.24, 0.24, 0.24, 0.04]

    def seq():
        return "".join(rng.choice(bases, size=int(rng.integers(lo, hi)), p=p))

    return [seq() for _ in range(n)], [seq() for _ in range(n)]


def _http(method, addr, path, body=None, raw: bytes | None = None):
    conn = http.client.HTTPConnection(*addr, timeout=60)
    try:
        payload = raw if raw is not None else (
            json.dumps(body) if body is not None else None)
        conn.request(method, path, body=payload,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def _bodies():
    """name -> (method, path, body or raw bytes): every endpoint, each
    error path the server answers before the device."""
    rng = np.random.default_rng(12)
    reads, refs = _pairs(rng, 6)
    bases = np.array(list("ACGT"))
    panel = ["".join(rng.choice(bases, size=int(rng.integers(36, 48)))) for _ in range(5)]
    mapped = [panel[2][5:25], reverse_complement(panel[1][10:30]), panel[4][3:19] + "TTAC",
              "GGGGCCCCAAAA", panel[0][:30]]
    big_r, big_f = _pairs(rng, 17)
    return {
        "score_sw": ("POST", "/v1/score", {"reads": reads, "refs": refs, "algorithm": "sw"}),
        "score_nw": ("POST", "/v1/score", {"reads": reads, "refs": refs,
                                           "algorithm": "needleman_wunsch"}),
        "score_default_algorithm": ("POST", "/v1/score", {"reads": reads[:2], "refs": refs[:2]}),
        "score_empty": ("POST", "/v1/score", {"reads": [], "refs": []}),
        "align_sw": ("POST", "/v1/align", {"reads": reads, "refs": refs, "algorithm": "sw"}),
        "align_nw": ("POST", "/v1/align", {"reads": reads, "refs": refs, "algorithm": "nw"}),
        "align_cigar_sw": ("POST", "/v1/align", {"reads": reads, "refs": refs,
                                                 "fields": "cigar"}),
        "align_cigar_nw": ("POST", "/v1/align", {"reads": reads, "refs": refs,
                                                 "algorithm": "NW", "fields": "cigar"}),
        "map_both_strands_align": ("POST", "/v1/map", {"reads": mapped, "panel": panel,
                                                       "align": True}),
        "map_both_strands": ("POST", "/v1/map", {"reads": mapped, "panel": panel}),
        "map_one_strand_align_nw": ("POST", "/v1/map", {
            "reads": mapped, "panel": panel, "both_strands": False, "align": True,
            "algorithm": "nw"}),
        "map_empty_panel": ("POST", "/v1/map", {"reads": mapped[:2], "panel": [],
                                                "align": True}),
        "400_counts_differ": ("POST", "/v1/score", {"reads": ["AC"], "refs": []}),
        "400_missing_refs": ("POST", "/v1/score", {"reads": ["AC"]}),
        "400_not_lists": ("POST", "/v1/align", {"reads": "AC", "refs": "AC"}),
        "400_not_strings": ("POST", "/v1/score", {"reads": [1], "refs": ["AC"]}),
        "400_bad_algorithm": ("POST", "/v1/score", {"reads": ["AC"], "refs": ["AC"],
                                                    "algorithm": "bogus"}),
        "400_bad_json": ("POST", "/v1/score", b"{not json"),
        "400_map_missing_panel": ("POST", "/v1/map", {"reads": mapped}),
        "400_map_not_strings": ("POST", "/v1/map", {"reads": mapped, "panel": [3]}),
        "413_pairs": ("POST", "/v1/score", {"reads": big_r, "refs": big_f}),
        "413_map_cross": ("POST", "/v1/map", {"reads": ["ACGT"] * 51, "panel": panel}),
        "map_one_strand_under_the_bound": ("POST", "/v1/map", {
            "reads": ["ACGTAC"] * 51, "panel": panel, "both_strands": False}),
        "404_post": ("POST", "/v2/score", {"reads": [], "refs": []}),
        "404_get": ("GET", "/nope", None),
    }


_BODIES = _bodies()


class _Servers:
    """One JAX server and the port's two, each started on port 0."""

    def __init__(self):
        self.servers = {
            "jax": jax_serve.AlignServer(jax_serve.BatchingAligner(
                JaxEngine(backend="oracle"), max_wait_ms=2), **_LIMITS),
            "oracle": AlignServer(BatchingAligner(
                AlignmentEngine(backend="oracle", device="cpu"), max_wait_ms=2), **_LIMITS),
            "raw": AlignServer(BatchingAligner(
                AlignmentEngine(device="cpu"), max_wait_ms=2), **_LIMITS),
        }
        for s in self.servers.values():
            s.start()

    def ask(self, name, method, path, body):
        addr = self.servers[name].address
        if isinstance(body, bytes):
            return _http(method, addr, path, raw=body)
        return _http(method, addr, path, body)

    def close(self):
        for s in self.servers.values():
            s.close()


@pytest.fixture(scope="module")
def servers():
    s = _Servers()
    yield s
    s.close()


@pytest.mark.parametrize("case", sorted(_BODIES))
def test_replies_equal_the_jax_servers(servers, case):
    method, path, body = _BODIES[case]
    want = servers.ask("jax", method, path, body)
    if case[:3].isdigit():
        assert want[0] == int(case[:3])
    else:
        assert want[0] == 200, want
    for name in ("oracle", "raw"):
        assert servers.ask(name, method, path, body) == want, name


def test_healthz_and_stats_keys_match_jax(servers):
    want = servers.ask("jax", "GET", "/healthz", None)
    for name, backend in (("oracle", "oracle"), ("raw", "cuda")):
        status, got = servers.ask(name, "GET", "/healthz", None)
        assert status == 200 and got == {"ok": True, "backend": backend, "platform": "cpu"}
        assert got.keys() == want[1].keys()
    body = _BODIES["score_sw"]
    for name in servers.servers:
        servers.ask(name, *body)
    keys = {name: set(servers.ask(name, "GET", "/stats", None)[1]) for name in servers.servers}
    assert keys["oracle"] == keys["raw"] == keys["jax"]
    assert {"max_batch_pairs", "batches", "mean_queue_wait_s", "device_sum_s"} <= keys["raw"]


def _backpressure_replies(mod, engine):
    """(queue full, batch timed out) replies of ``mod``'s server over
    ``engine`` whose dispatcher has not started."""
    out = []
    for max_queue, fill in ((1, True), (2, False)):
        aligner = mod.BatchingAligner(engine, max_queue=max_queue, start=False)
        server = mod.AlignServer(aligner, request_timeout_s=0.3)
        server.start()
        try:
            if fill:
                aligner.submit(["AC"], ["AC"])
            out.append(_http("POST", server.address, "/v1/score",
                             {"reads": ["ACGT"], "refs": ["ACGT"]}))
        finally:
            aligner.start()
            server.close()
    return out


def test_503_replies_match_jax():
    want = _backpressure_replies(jax_serve, JaxEngine(backend="oracle"))
    assert [w[0] for w in want] == [503, 503]
    assert want[0][1] == {"error": "server overloaded; retry"}
    assert want[1][1] == {"error": "batch timed out"}
    assert _backpressure_replies(serve, AlignmentEngine(backend="oracle", device="cpu")) == want


def test_raw_path_equals_the_oracle_path():
    rng = np.random.default_rng(3)
    raw = AlignmentEngine(device="cpu")
    oracle = AlignmentEngine(backend="oracle", device="cpu")
    for alg in ("sw", "nw"):
        r1, f1 = _pairs(rng, 3)
        r2, f2 = _pairs(rng, 4)
        for mode in ("align", "align_cigar"):
            gapped = mode == "align"
            got, want = [], []
            for engine, out in ((raw, got), (oracle, want)):
                with BatchingAligner(engine, max_wait_ms=50, start=False) as aligner:
                    futs = [aligner.submit(r, f, alg, mode) for r, f in ((r1, f1), (r2, f2))]
                    aligner.start()
                    out.extend(fut.result(timeout=30) for fut in futs)
            assert all(isinstance(x, AlignmentBatch) for x in got)
            assert all(isinstance(x, list) for x in want)
            assert [len(x) for x in got] == [3, 4]
            for g, w in zip(got, want):
                assert g.to_json_rows() == [serve._alignment_json(a, gapped) for a in w]


def test_no_fallback_from_the_raw_path(monkeypatch):
    """An error of the raw path (a native decoder that failed to load, say)
    reaches the request as a 500; nothing retries it another way."""
    engine = AlignmentEngine(device="cpu")
    calls = []

    def broken(*args, **kw):
        calls.append(kw)
        raise ImportError("native decoder failed to build")

    monkeypatch.setattr(engine, "compute_alignments", broken)
    with AlignServer(BatchingAligner(engine, max_wait_ms=2)) as server:
        server.start()
        status, err = _http("POST", server.address, "/v1/align",
                            {"reads": ["ACGT"], "refs": ["ACGT"]})
        stats = server.aligner.stats()
    assert status == 500 and "native decoder" in err["error"]
    assert calls == [{"raw": True, "gapped": True}]
    assert stats["errors"] == 1


def test_a_burst_of_concurrent_connections_is_queued(engine):
    """64 clients connect at once: the listen backlog queues them all (the
    default of 5 drops SYNs past the sixth), and each gets its scores."""
    clients = 64
    go = threading.Barrier(clients)
    replies, errors = [None] * clients, []

    def client(i):
        go.wait()
        try:
            replies[i] = _http("POST", server.address, "/v1/score",
                               {"reads": ["ACGT" * (1 + i % 4)], "refs": ["ACGT"]})
        except OSError as exc:
            errors.append(exc)

    with AlignServer(BatchingAligner(engine, max_wait_ms=2)) as server:
        server.start()
        assert server._httpd.request_queue_size == AlignServer.LISTEN_BACKLOG >= clients
        threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors[:3]
    assert replies == [(200, {"scores": [8]})] * clients


def test_bucket_and_algorithm_parsing():
    assert _bucket(1) == 32 and _bucket(32) == 32 and _bucket(33) == 64
    assert _bucket(512) == 512 and _bucket(513) == 1024
    for n in range(0, 3000, 7):
        for floor in (8, 32):
            assert _bucket(n, floor) == jax_serve._bucket(n, floor)
    assert parse_algorithm("sw") is Algorithm.SMITH_WATERMAN
    assert parse_algorithm("NW") is Algorithm.NEEDLEMAN_WUNSCH
    assert parse_algorithm("smith_waterman") is Algorithm.SMITH_WATERMAN
    assert parse_algorithm(Algorithm.SMITH_WATERMAN) is Algorithm.SMITH_WATERMAN
    assert parse_algorithm(1) is Algorithm.NEEDLEMAN_WUNSCH
    with pytest.raises(ValueError, match="unknown algorithm"):
        parse_algorithm("bogus")
    assert serve.MODES == jax_serve.MODES
    assert AlignServer.MAX_BODY_BYTES == jax_serve.AlignServer.MAX_BODY_BYTES


@pytest.fixture
def engine():
    return AlignmentEngine(backend="oracle", device="cpu")


def test_batching_coalesces_requests(engine, rng):
    # Enqueue BEFORE starting the dispatcher: deterministic coalescing.
    aligner = BatchingAligner(engine, max_wait_ms=50, start=False)
    reqs = []
    for _ in range(4):
        reads, refs = _pairs(rng, 3)
        reqs.append((reads, refs, aligner.submit(reads, refs, "sw", "score")))
    nw_reads, nw_refs = _pairs(rng, 2)
    nw_fut = aligner.submit(nw_reads, nw_refs, "nw", "score")
    aligner.start()
    for reads, refs, fut in reqs:
        want = engine.score_alignments(_SW, reads, refs)
        assert fut.result(timeout=30) == [int(v) for v in want]
    want = engine.score_alignments(Algorithm.NEEDLEMAN_WUNSCH, nw_reads, nw_refs)
    assert nw_fut.result(timeout=30) == [int(v) for v in want]
    s = aligner.stats()
    # 5 requests over 2 (algorithm, mode) groups -> exactly 2 device batches.
    assert s["requests"] == 5 and s["batches"] == 2
    assert s["batched_pairs"] == 14 and s["max_batch_pairs"] == 12
    aligner.close()


def test_align_mode_scatters_per_request(rng):
    engine = AlignmentEngine(device="cpu")
    with BatchingAligner(engine, max_wait_ms=50, start=False) as aligner:
        r1, f1 = _pairs(rng, 2)
        r2, f2 = _pairs(rng, 3)
        fut1 = aligner.submit(r1, f1, "sw", "align")
        fut2 = aligner.submit(r2, f2, "sw", "align")
        aligner.start()
        a1 = list(fut1.result(timeout=30))
        a2 = list(fut2.result(timeout=30))
    assert len(a1) == 2 and len(a2) == 3
    # Bucketed padding changes no result: the direct engine on the
    # unpadded batch gives the same alignments (all but the positions in
    # the padded text buffer).
    want = engine.compute_alignments(_SW, r1 + r2, f1 + f2)
    assert [serve._alignment_json(a) for a in a1 + a2] == \
        [serve._alignment_json(a) for a in want]


def test_submit_validation_and_backpressure(engine):
    aligner = BatchingAligner(engine, max_queue=2, start=False)
    with pytest.raises(ValueError, match="counts differ"):
        aligner.submit(["AC"], [], "sw", "score")
    with pytest.raises(ValueError, match="mode"):
        aligner.submit(["AC"], ["AC"], "sw", "fancy")
    assert aligner.submit([], [], "sw", "score").result() == []  # no device
    first = aligner.submit(["AC"], ["AC"])
    aligner.submit(["AC"], ["AC"])
    with pytest.raises(queue.Full):
        aligner.submit(["AC"], ["AC"])
    # Drain: start, let both resolve, close; then submits are rejected.
    aligner.start()
    assert first.result(timeout=30) == [4]
    aligner.close()
    with pytest.raises(RuntimeError, match="closed"):
        aligner.submit(["AC"], ["AC"])
    with pytest.raises(RuntimeError, match="closed"):
        aligner.submit_call(lambda: 1)


def test_concurrent_submitters_one_device_stream(engine):
    # 8 client threads flood; every result must be exact and the dispatcher
    # must batch at least some of them together.
    aligner = BatchingAligner(engine, max_wait_ms=20)
    errors = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def client(seed):
            local = np.random.default_rng(seed)
            for _ in range(5):
                reads, refs = _pairs(local, 2)
                got = aligner.score(reads, refs, "sw")
                want = engine.score_alignments(_SW, reads, refs)
                if got != [int(v) for v in want]:
                    errors.append((reads, refs, got, list(want)))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    s = aligner.stats()
    assert s["requests"] == 40 and s["errors"] == 0 and s["pairs"] == 80
    assert s["batches"] <= s["requests"]
    aligner.close()


def test_submit_call_runs_on_dispatcher(engine):
    with BatchingAligner(engine, max_wait_ms=5) as aligner:
        names = []
        fut = aligner.submit_call(
            lambda: names.append(threading.current_thread().name) or 42)
        assert fut.result(timeout=30) == 42
        assert names == ["versalign-dispatch"]
        boom = aligner.submit_call(lambda: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            boom.result(timeout=30)
        assert aligner.stats()["errors"] == 1


def test_http_map_endpoint_equals_map_reads(rng):
    engine = AlignmentEngine(device="cpu")
    bases = np.array(list("ACGT"))
    panel = ["".join(rng.choice(bases, size=40)) for _ in range(4)]
    reads = [panel[2][5:25], reverse_complement(panel[1][10:30])]
    with AlignServer(BatchingAligner(engine, max_wait_ms=5)) as server:
        server.start()
        status, out = _http("POST", server.address, "/v1/map",
                            {"reads": reads, "panel": panel, "align": True})
    assert status == 200
    want = map_reads(reads, panel, device="cpu")
    for i, h in enumerate(out["hits"]):
        assert (h["index"], h["score"], h["strand"], h["mapq"]) == (
            int(want.index[i]), int(want.score[i]), int(want.strand[i]), int(want.mapq[i]))
        assert h["alignment"] == serve._alignment_json(want.alignments[i])


def test_mixed_endpoint_stress_and_close_under_traffic(engine):
    """Score and map requests racing on one server: every response is
    valid; closing with requests in flight neither hangs nor corrupts."""
    aligner = BatchingAligner(engine, max_wait_ms=10)
    server = AlignServer(aligner, port=0)
    server.start()
    addr = server.address
    bases = np.array(list("ACGT"))
    panel = ["".join(np.random.default_rng(5).choice(bases, size=30)) for _ in range(3)]
    errors = []

    def score_client(seed):
        local = np.random.default_rng(seed)
        for _ in range(6):
            reads, refs = _pairs(local, 2)
            status, out = _http("POST", addr, "/v1/score", {"reads": reads, "refs": refs})
            want = engine.score_alignments(_SW, reads, refs)
            if status != 200 or out["scores"] != [int(v) for v in want]:
                errors.append((status, out))

    def map_client(seed):
        local = np.random.default_rng(seed)
        for _ in range(4):
            reads = [panel[int(local.integers(0, 3))][5:25]]
            status, out = _http("POST", addr, "/v1/map", {"reads": reads, "panel": panel})
            if status != 200 or out["hits"][0]["score"] != 40:
                errors.append((status, out))

    threads = ([threading.Thread(target=score_client, args=(i,)) for i in range(4)]
               + [threading.Thread(target=map_client, args=(100 + i,)) for i in range(2)])
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    # Close while a late request is in flight: the submitter gets a clean
    # error or result, never a hang.
    fut = aligner.submit(["ACGT"], ["ACGT"])
    server.close()  # drains + closes the aligner
    try:
        assert fut.result(timeout=30) == [8]
    except RuntimeError:
        pass  # "closed during submit" is an acceptable outcome
    with pytest.raises(RuntimeError, match="closed"):
        aligner.submit(["ACGT"], ["ACGT"])


def test_stats_split_queue_wait_vs_device(rng):
    with BatchingAligner(AlignmentEngine(device="cpu"), max_wait_ms=5.0) as ba:
        reads, refs = _pairs(rng, 6)
        ba.score(reads, refs)
        assert len(ba.align(reads[:3], refs[:3])) == 3
        s = ba.stats()
    assert s["device_sum_s"] > 0 and s["device_max_s"] > 0
    assert s["queue_wait_sum_s"] >= 0 and "queue_wait_max_s" in s
    assert "mean_queue_wait_s" in s and "mean_device_s" in s
    assert s["device_sum_s"] <= s["latency_sum_s"] + 1e-9


def test_lazy_exports_and_the_card_default(monkeypatch):
    code = ("import sys\n"
            "import versalignlib_tpu_torch as p\n"
            "assert 'versalignlib_tpu_torch.serve' not in sys.modules\n"
            "assert 'http.server' not in sys.modules\n"
            "from versalignlib_tpu_torch.serve import AlignServer, BatchingAligner\n"
            "assert p.AlignServer is AlignServer and p.BatchingAligner is BatchingAligner\n"
            "assert p.__all__[:2] == ['BatchingAligner', 'AlignServer']\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    import versalignlib_tpu_torch

    with pytest.raises(AttributeError):
        versalignlib_tpu_torch.NoSuchName
    # The command line runs on the card unless asked for the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--port", "0"])
