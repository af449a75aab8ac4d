"""The port's mesh layer on an 8-shard CPU mesh against the JAX package's
8-device virtual CPU mesh and its oracles: ``make_mesh``, the sharded
scores, alignments and dense pointers, ``AlignmentEngine(mesh=)``, the
search entry points under both ``panel_axis`` values (duplicate panel
entries across shards included) and ``prefetch_to_device(mesh=)``. No JAX
path here loads the JAX native decoder: the alignments are held to the
numpy oracles. Inputs come from a seeded numpy generator; every check is
``==``."""

import itertools
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.conftest import random_codes
from tests.test_torch_search import AFFINE_DNA, _jp, _panel_with_duplicates, _same_alignments
from versalignlib_tpu import refmap as jax_refmap
from versalignlib_tpu import search as jax_search
from versalignlib_tpu import translate as jax_translate
from versalignlib_tpu.ops import gotoh as jax_gotoh
from versalignlib_tpu.ops import oracle as jax_oracle
from versalignlib_tpu.parallel import distributed as jax_distributed
from versalignlib_tpu.parallel import make_mesh as jax_make_mesh
from versalignlib_tpu.types import Algorithm as JaxAlgorithm
from versalignlib_tpu.types import TieBreak as JaxTieBreak
from versalignlib_tpu_torch import AlignmentEngine, refmap, search, translate
from versalignlib_tpu_torch.alphabet import reverse_complement_codes
from versalignlib_tpu_torch.io.staging import prefetch_to_device
from versalignlib_tpu_torch.ops.traceback import decode_batch
from versalignlib_tpu_torch.parallel import (distributed_align_batch, distributed_score_batch,
                                             make_mesh)
from versalignlib_tpu_torch.parallel.distributed import distributed_align_device, shard_rows
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm, TieBreak

ROOT = pathlib.Path(__file__).resolve().parent.parent
MESH = make_mesh(8, device="cpu")
DNA = AlignmentParameters()
#: The JAX affine oracle's own test parameters (tests/test_distributed.py).
AFFINE = AlignmentParameters(score_match=2, score_mismatch=-1, score_gap_read=-1,
                             score_gap_ref=-1, gap_open_read=-4, gap_open_ref=-4)


@pytest.fixture(scope="module")
def fresh_jmesh():
    """A new JAX 8-device mesh for each call, in a device order of its own.
    The mesh is a static argument of the JAX package's jitted mesh
    helpers, so each call gets a dispatch cache of its own: jaxlib's
    nested-jit cache bug (versalignlib_tpu/search.py) otherwise hands a
    later call of one shape the executable of another ("Execution supplied
    2 buffers but compiled program expected 3"), and the JAX package's own
    tests never call those helpers. The order moves each shard to another
    device and changes no result. Each such call streams one chunk; the
    chunked and affine mesh runs are held to the JAX package's calls
    without a mesh in the same chunks (``jax_refs``), and to the port's
    single-device path."""
    import jax

    devices = jax.devices()[:8]
    orders = itertools.permutations(range(8))
    return lambda: jax_make_mesh(devices=[devices[i] for i in next(orders)])


def _key(alns):
    return [(a.read, a.ref, a.score, a.cigar) for a in alns]


#: The chunkings of the chunked runs: ``max_pairs`` of each search entry
#: point, ``panel_chunk`` of ``translated_search``.
MAX_PAIRS = {"search": (1 << 20, 14, 21), "pairs": (1 << 20, 24), "refmap": (1 << 20, 40)}
PANEL_CHUNKS = (None, 2)


def _jax_references() -> dict:
    """The JAX package's search entry points without a mesh, in every
    chunking of the chunked runs below, on the same inputs; alignments by
    ``backend="oracle"`` (``translated_search`` without them: its own align
    loads the native decoder)."""
    from tests.test_torch_translate import _translated_inputs

    out = {}
    reads, panel = _search_inputs(np.random.default_rng(500))
    for max_pairs in MAX_PAIRS["search"]:
        out["score_matrix", max_pairs] = jax_search.score_matrix(reads, panel, impl="xla",
                                                                 max_pairs=max_pairs)
        for params in (DNA, AFFINE_DNA):
            out["map_reads", max_pairs, params.affine] = jax_search.map_reads(
                reads, panel, _jp(params), impl="xla", max_pairs=max_pairs, backend="oracle")
    mate1, mate2, panel = _pair_inputs()
    for max_pairs in MAX_PAIRS["pairs"]:
        out["map_read_pairs", max_pairs] = jax_search.map_read_pairs(
            mate1, mate2, panel, impl="xla", max_pairs=max_pairs, backend="oracle")
    reads, refs = _refmap_inputs()
    for max_pairs in MAX_PAIRS["refmap"]:
        out["map_to_reference", max_pairs] = jax_refmap.map_to_reference(
            reads, refs, impl="xla", max_pairs=max_pairs, backend="oracle")
    reads, proteins = _translated_inputs(np.random.default_rng(800))
    for chunk in PANEL_CHUNKS:
        out["translated_search", chunk] = jax_translate.translated_search(
            reads, proteins, impl="xla", panel_chunk=chunk)
    return out


@pytest.fixture(scope="module", autouse=True)
def _jax_references_process():
    """:func:`_jax_references` in a process of its own, started with the
    module's first test. Every JAX mesh helper here traces the jitted score
    scan inside an outer jit, and after that this jaxlib's nested-jit
    dispatch bug hands a later affine call without a mesh another
    executable ("Execution supplied 2 buffers but compiled program expected
    3"; ``jax.clear_caches()`` does not clear it), so the calls without a
    mesh run where no mesh helper has."""
    code = ("import pickle, sys\n"
            "from tests.test_torch_parallel import _jax_references\n"
            "sys.stdout.buffer.write(pickle.dumps(_jax_references()))\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    yield proc
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_refs(_jax_references_process):
    out, err = _jax_references_process.communicate(timeout=100)
    assert _jax_references_process.returncode == 0, err.decode()[-3000:]
    return pickle.loads(out)


def test_make_mesh_bounds(monkeypatch):
    assert MESH.size == 8 and MESH.devices == (torch.device("cpu"),) * 8
    assert MESH.shape == {"data": 8} and not MESH.is_cuda
    assert make_mesh(device="cpu").size == 1
    assert make_mesh(4, devices=["cpu"] * 8).size == 4
    with pytest.raises(ValueError, match="only 8 present"):
        make_mesh(10_000, devices=MESH.devices)
    with pytest.raises(ValueError, match="all CUDA devices or all the CPU"):
        make_mesh(devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="at least one"):
        make_mesh(devices=[])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="card"):
        make_mesh(devices=["cuda:0"])
    for entry in (lambda: AlignmentEngine(mesh=make_mesh()),
                  lambda: distributed_score_batch(np.ones((2, 3), np.uint8),
                                                  np.ones((2, 3), np.uint8), DNA,
                                                  Algorithm.SMITH_WATERMAN),
                  lambda: search.map_reads(np.ones((2, 3), np.uint8),
                                           np.ones((2, 3), np.uint8), mesh=make_mesh())):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()


@pytest.mark.parametrize("b", [33, 13, 11, 9, 3])
@pytest.mark.parametrize("alg", list(Algorithm), ids=lambda a: a.name)
def test_distributed_scores_equal_jax_on_uneven_shards(fresh_jmesh, b, alg):
    rng = np.random.default_rng(100 + b)
    reads = random_codes(rng, b, 12, padded=True, n_prob=0.1)
    refs = random_codes(rng, b, 15, padded=True, n_prob=0.1)
    got = distributed_score_batch(reads, refs, DNA, alg, mesh=MESH)
    want = jax_distributed.distributed_score_batch(reads, refs, _jp(DNA), JaxAlgorithm(int(alg)),
                                                   mesh=fresh_jmesh(), impl="xla")
    assert got.dtype == np.int32 and got.shape == (b,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_oracle.score_alignments(
        JaxAlgorithm(int(alg)), reads, refs, _jp(DNA)))
    engine = AlignmentEngine(AFFINE, mesh=MESH)
    np.testing.assert_array_equal(
        engine.score_alignments(alg, reads, refs),
        jax_gotoh.score_alignments_affine(JaxAlgorithm(int(alg)), reads, refs, _jp(AFFINE)))


@pytest.mark.parametrize("tie", list(TieBreak), ids=lambda t: t.name)
@pytest.mark.parametrize("alg", list(Algorithm), ids=lambda a: a.name)
def test_engine_mesh_alignments_equal_the_jax_oracle(alg, tie):
    """Padded reads and N in both tie families, B = 13 and 11 on 8 shards,
    the walk on the host and (``device_walk=True``) its plain version."""
    rng = np.random.default_rng(200 + 2 * int(alg) + int(tie))
    for b in (13, 11):
        reads = random_codes(rng, b, 10, padded=True, n_prob=0.1)
        refs = random_codes(rng, b, 14, padded=True, n_prob=0.1)
        want = jax_oracle.compute_alignments(JaxAlgorithm(int(alg)), reads, refs, _jp(DNA),
                                             JaxTieBreak(int(tie)))
        for walk in (None, True):
            engine = AlignmentEngine(DNA, tie=tie, mesh=MESH, device_walk=walk)
            got = engine.compute_alignments(alg, reads, refs)
            assert len(got) == b and _key(got) == _key(want)
        assert got == AlignmentEngine(DNA, tie=tie, device="cpu").compute_alignments(
            alg, reads, refs)


@pytest.mark.parametrize("alg", list(Algorithm), ids=lambda a: a.name)
def test_affine_mesh_alignments_stay_on_the_mesh_in_both_flavors(alg):
    """Affine goes through the Gotoh fill shard by shard, never off the
    mesh, in the canonical and the SSE flavor."""
    rng = np.random.default_rng(300 + int(alg))
    reads = random_codes(rng, 9, 10, padded=True)
    refs = random_codes(rng, 9, 12, padded=True)
    for tie in TieBreak:
        got = distributed_align_batch(reads, refs, AFFINE, alg, tie, mesh=MESH)
        want = jax_gotoh.compute_alignments_affine(JaxAlgorithm(int(alg)), reads, refs,
                                                   _jp(AFFINE), JaxTieBreak(int(tie)))
        assert _key(got) == _key(want)


def test_raw_batches_and_other_backends_refuse_a_mesh():
    reads = np.ones((3, 5), np.uint8)
    with pytest.raises(ValueError, match="raw alignment batches"):
        AlignmentEngine(mesh=MESH).compute_alignments(Algorithm.SMITH_WATERMAN, reads, reads,
                                                      raw=True)
    with pytest.raises(ValueError, match="cuda backend"):
        AlignmentEngine(backend="oracle", mesh=MESH)
    assert distributed_score_batch(reads[:0], reads[:0], DNA, Algorithm.SMITH_WATERMAN,
                                   mesh=MESH).shape == (0,)
    assert distributed_align_batch(reads[:0], reads[:0], DNA, Algorithm.SMITH_WATERMAN,
                                   mesh=MESH) == []


@pytest.mark.parametrize("alg", list(Algorithm), ids=lambda a: a.name)
def test_distributed_align_device_equals_jax(fresh_jmesh, alg):
    """The dense pointers, start cells and scores equal the JAX portable
    variant's; decoded, they are the oracle's alignments."""
    rng = np.random.default_rng(400 + int(alg))
    reads = random_codes(rng, 16, 10)
    refs = random_codes(rng, 16, 12)
    reads[3, 7:] = 0
    got = distributed_align_device(reads, refs, DNA, alg, mesh=MESH)
    want = jax_distributed.distributed_align_device(
        reads, refs, _jp(DNA), JaxAlgorithm(int(alg)), JaxTieBreak.DIAG_UP_LEFT,
        fresh_jmesh())
    assert got[0].dtype == np.uint8 and got[0].shape == (16, 10, 12)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    alns = decode_batch(got[0], reads, refs, got[1], got[2], DNA, alg, got[3])
    assert _key(alns) == _key(jax_oracle.compute_alignments(JaxAlgorithm(int(alg)), reads,
                                                            refs, _jp(DNA)))
    with pytest.raises(ValueError, match="linear"):
        distributed_align_device(reads, refs, AFFINE, alg, mesh=MESH)


def _search_inputs(rng):
    panel = _panel_with_duplicates(rng, 11, 24)
    panel[6] = panel[1]                 # duplicates on three shards of 8
    reads = rng.integers(1, 5, size=(7, 20)).astype(np.uint8)
    reads[2] = panel[1, 2:22]           # ties between the duplicate entries
    reads[5] = reverse_complement_codes(panel[4, 1:21][None])[0]
    reads[6, 15:] = 0
    return reads, panel


def _same_fields(got, want, fields):
    for field in fields:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
        assert getattr(got, field).dtype == getattr(want, field).dtype


@pytest.mark.parametrize("axis", ["reads", "panel"])
def test_search_entry_points_on_a_mesh_equal_jax(fresh_jmesh, jax_refs, axis):
    """``score_matrix``, ``best_hits`` and ``map_reads`` over the mesh
    against the JAX package's mesh paths, with the winners' alignments held
    to the oracle (the JAX mesh align loads the native decoder); then in
    chunks of 2 and 3 entries, and affine, against the JAX calls without a
    mesh in the same chunks (alignments by ``backend="oracle"``) and the
    port's single-device path."""
    rng = np.random.default_rng(500)
    reads, panel = _search_inputs(rng)
    kw = dict(mesh=MESH, panel_axis=axis)
    np.testing.assert_array_equal(
        search.score_matrix(reads, panel, **kw),
        jax_search.score_matrix(reads, panel, impl="xla", mesh=fresh_jmesh(), panel_axis=axis))
    got = search.best_hits(reads, panel, **kw)
    want = jax_search.best_hits(reads, panel, impl="xla", mesh=fresh_jmesh(),
                                panel_axis=axis, align=False)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0][2] == 1               # the tie goes to the lowest panel index
    assert _key(got[2]) == _key(jax_oracle.compute_alignments(
        JaxAlgorithm.SMITH_WATERMAN, reads, panel[got[0]], _jp(DNA)))
    got = search.map_reads(reads, panel, **kw)
    want = jax_search.map_reads(reads, panel, impl="xla", mesh=fresh_jmesh(),
                                panel_axis=axis, align=False)
    _same_fields(got, want, ("index", "score", "strand", "mapq"))
    fields = ("index", "score", "strand", "mapq")
    for max_pairs in MAX_PAIRS["search"]:
        kw["max_pairs"] = max_pairs
        got = search.score_matrix(reads, panel, **kw)
        np.testing.assert_array_equal(got, jax_refs["score_matrix", max_pairs])
        np.testing.assert_array_equal(
            got, search.score_matrix(reads, panel, device="cpu", max_pairs=max_pairs))
        for params in (DNA, AFFINE_DNA):
            got = search.map_reads(reads, panel, params, **kw)
            want = jax_refs["map_reads", max_pairs, params.affine]
            one = search.map_reads(reads, panel, params, device="cpu", max_pairs=max_pairs)
            for other in (want, one):
                _same_fields(got, other, fields)
                _same_alignments(got.alignments, other.alignments)
        assert got.index[2] == 1


def _pair_inputs():
    rng = np.random.default_rng(600)
    panel = _panel_with_duplicates(rng, 7, 60)
    src = rng.integers(0, 7, size=6)
    mate1 = panel[src, 2:20].copy()
    mate2 = reverse_complement_codes(panel[src, 35:55].copy())
    mate1[1] = reverse_complement_codes(panel[src[1], 35:53])
    mate2[1] = panel[src[1], 2:22]
    return mate1, mate2, panel


def test_map_read_pairs_on_a_mesh_equals_jax(fresh_jmesh, jax_refs):
    mate1, mate2, panel = _pair_inputs()
    fields = ("index", "score", "orient", "mapq")
    got = search.map_read_pairs(mate1, mate2, panel, mesh=MESH)
    _same_fields(got, jax_search.map_read_pairs(mate1, mate2, panel, impl="xla",
                                                mesh=fresh_jmesh(), align=False), fields)
    for max_pairs in MAX_PAIRS["pairs"]:
        got = search.map_read_pairs(mate1, mate2, panel, mesh=MESH, max_pairs=max_pairs)
        want = jax_refs["map_read_pairs", max_pairs]
        one = search.map_read_pairs(mate1, mate2, panel, device="cpu", max_pairs=max_pairs)
        for other in (want, one):
            _same_fields(got, other, fields + ("strand1", "strand2"))
            _same_alignments(got.alignments1, other.alignments1)
            _same_alignments(got.alignments2, other.alignments2)


def _refmap_inputs():
    rng = np.random.default_rng(700)
    chr1 = rng.integers(1, 5, size=900).astype(np.uint8)
    chr2 = rng.integers(1, 5, size=400).astype(np.uint8)
    chr1[600:640] = chr1[100:140]
    reads = np.stack([chr1[0:40], chr1[100:140], chr1[850:890], chr2[233:273],
                      chr2[350:390]])
    reads[1::2] = reverse_complement_codes(reads[1::2])
    return reads, [chr1, chr2]


@pytest.mark.parametrize("axis", ["reads", "panel"])
def test_map_to_reference_on_a_mesh_equals_jax(fresh_jmesh, jax_refs, axis):
    """Two references with a repeated locus and reads on both strands, the
    window axis sharded under ``panel_axis="panel"``; streamed in chunks
    against the JAX call without a mesh in the same chunks and the port's
    single-device path."""
    reads, (chr1, chr2) = _refmap_inputs()
    fields = ("ref_id", "pos", "score", "strand", "mapq")
    got = refmap.map_to_reference(reads, [chr1, chr2], mesh=MESH, panel_axis=axis)
    _same_fields(got, jax_refmap.map_to_reference(reads, [chr1, chr2], impl="xla",
                                                  mesh=fresh_jmesh(), panel_axis=axis,
                                                  align=False), fields)
    assert got.mapq[1] == 0
    for max_pairs in MAX_PAIRS["refmap"]:
        got = refmap.map_to_reference(reads, [chr1, chr2], mesh=MESH, panel_axis=axis,
                                      max_pairs=max_pairs)
        want = jax_refs["map_to_reference", max_pairs]
        one = refmap.map_to_reference(reads, [chr1, chr2], device="cpu", max_pairs=max_pairs)
        for other in (want, one):
            _same_fields(got, other, fields)
            _same_alignments(got.alignments, other.alignments)


@pytest.mark.parametrize("axis", ["reads", "panel"])
def test_translated_search_on_a_mesh_equals_jax(fresh_jmesh, jax_refs, axis):
    from tests.test_torch_translate import _translated_inputs

    rng = np.random.default_rng(800)
    reads, proteins = _translated_inputs(rng)
    got = translate.translated_search(reads, proteins, mesh=MESH, panel_axis=axis)
    want = jax_translate.translated_search(reads, proteins, impl="xla", mesh=fresh_jmesh(),
                                           panel_axis=axis)
    for field in ("index", "frame", "score", "scores"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    for chunk in PANEL_CHUNKS:
        got = translate.translated_search(reads, proteins, mesh=MESH, panel_axis=axis,
                                          panel_chunk=chunk, alignments=True)
        want = jax_refs["translated_search", chunk]
        for field in ("index", "frame", "score"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
        _translated_alignments_equal_the_oracle(got, want, reads, proteins)
        one = translate.translated_search(reads, proteins, device="cpu", panel_chunk=chunk,
                                          alignments=True)
        for field in ("index", "frame", "score", "dna_start", "dna_end", "strand"):
            np.testing.assert_array_equal(getattr(got, field), getattr(one, field))
        _same_alignments(got.alignments, one.alignments)
        assert got.dna_cigar == one.dna_cigar


def _translated_alignments_equal_the_oracle(got, want, reads, proteins):
    """The winners' alignments held to the JAX Gotoh oracle on the JAX
    winners' (frame, protein) pairs (the JAX path's own align loads the
    native decoder), and their DNA coordinates and CIGARs to the JAX
    package's mapping of those alignments."""
    from versalignlib_tpu.alphabet import PROTEIN_ALPHABET as JAX_PROTEIN_ALPHABET
    from versalignlib_tpu.alphabet import encode_custom as jax_encode_custom

    frames = [jax_translate.FRAMES.index(int(f)) for f in want.frame]
    q = jax_encode_custom([want.proteins[i][f] for i, f in enumerate(frames)],
                          JAX_PROTEIN_ALPHABET)
    r = jax_encode_custom([proteins[j] for j in want.index], JAX_PROTEIN_ALPHABET)
    alns = jax_gotoh.compute_alignments_affine(JaxAlgorithm.SMITH_WATERMAN, q, r,
                                               jax_translate.TRANSLATED_PARAMETERS,
                                               JaxTieBreak.DIAG_UP_LEFT)
    coords = ("score", "cigar", "read_start", "read_end", "ref_start", "ref_end")
    assert [tuple(getattr(a, c) for c in coords) for a in got.alignments] == \
        [tuple(getattr(a, c) for c in coords) for a in alns]
    # The read's length as the JAX package takes it: to its last base.
    lens = [int(np.flatnonzero(x).max()) + 1 for x in reads]
    mapped = [jax_translate.map_protein_to_dna(int(f), n, a.read_start,
                                               max(a.read_end - 1, a.read_start))
              for f, n, a in zip(want.frame, lens, alns)]
    assert [(int(s), int(e), st) for s, e, st in mapped] == \
        list(zip(got.dna_start.tolist(), got.dna_end.tolist(), got.strand.tolist()))
    assert got.dna_cigar == [jax_translate._scale_cigar_dna(a.cigar) for a in alns]


def test_prefetch_to_device_stages_row_shards_in_order():
    rng = np.random.default_rng(900)
    chunks = [(c, rng.integers(0, 6, size=(b, 5)).astype(np.uint8), "meta")
              for c, b in enumerate((13, 8, 3))]
    mesh = make_mesh(4, device="cpu")
    got = list(prefetch_to_device(iter(chunks), depth=2, mesh=mesh))
    assert [g[0] for g in got] == [0, 1, 2] and all(g[2] == "meta" for g in got)
    for (_, codes, _), (_, shards, _) in zip(chunks, got):
        assert len(shards) == 4 and all(isinstance(s, torch.Tensor) for s in shards)
        for s, want in zip(shards, shard_rows(codes, 4)):
            np.testing.assert_array_equal(s.numpy(), want)
        np.testing.assert_array_equal(torch.cat(shards).numpy()[:codes.shape[0]], codes)


def test_map_shards_runs_a_thread_a_device_and_keeps_shard_order():
    """Shards of two distinct devices run at once, one thread a device (the
    first shard of each waits for the other's at a barrier), in threads kept
    from one call to the next; one device's shards run in the caller's
    thread. Results come back in shard order."""
    import threading

    from versalignlib_tpu_torch.parallel.distributed import map_shards
    from versalignlib_tpu_torch.parallel.mesh import Mesh

    cpu, meta = torch.device("cpu"), torch.device("meta")
    both = threading.Barrier(2, timeout=30)

    def fn(d, dev):
        if d < 2:
            both.wait()
        return d, dev, threading.get_ident()

    out = map_shards(Mesh((cpu, meta, cpu, meta)), fn)
    assert [(d, dev) for d, dev, _ in out] == [(0, cpu), (1, meta), (2, cpu), (3, meta)]
    assert out[0][2] == out[2][2] and out[1][2] == out[3][2]
    # The threads are kept for the mesh's devices: a second call runs on them.
    again = map_shards(Mesh((cpu, meta, cpu, meta)), fn)
    assert {t for _, _, t in again} == {t for _, _, t in out}
    assert map_shards(MESH, lambda d, dev: threading.get_ident()) == \
        [threading.get_ident()] * MESH.size
