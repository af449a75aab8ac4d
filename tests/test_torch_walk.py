"""The plain traceback walks of the port (``ops/walk.py``, the plain versions
of ``csrc/walk.cu`` and ``csrc/banded_walk.cu``) against the JAX package's
walks (``versalignlib_tpu/ops/walk.py``) on the port's own plain fill words,
with ``==`` (every output is an integer or text): records, start rows,
start columns and scores. The JAX walks take the words laid into one padded
(1, rows, words, 8, 128) block, with ``wbase = offsets`` for the banded
walks, whose port rows are band-relative. Then the replay of the records
against the host decode of the same pointer words, and the wiring: the
device-walk defaults, the memory plans and the banded round size."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import random_codes
from versalignlib_tpu.ops import walk as jax_walk
from versalignlib_tpu_torch import AlignmentEngine, AlignmentParameters, alphabet
from versalignlib_tpu_torch.native import (decode_banded_native, decode_batch_native,
                                           replay_records_native)
from versalignlib_tpu_torch.ops import cuda_align, cuda_banded, cuda_walk, plain, plain_banded
from versalignlib_tpu_torch.ops import walk as walks
from versalignlib_tpu_torch.ops.banded import band_offsets
from versalignlib_tpu_torch.ops.cuda_backend import CudaBackend
from versalignlib_tpu_torch.types import Algorithm, TieBreak
from versalignlib_tpu_torch.utils.capabilities import DeviceCapabilities

LINEAR = AlignmentParameters()
AFFINE = AlignmentParameters(score_match=2, score_mismatch=-1, score_gap_read=-1,
                             score_gap_ref=-1, gap_open_read=-4, gap_open_ref=-4)
BLOSUM62 = AlignmentParameters(score_gap_read=-11, score_gap_ref=-11,
                               matrix=alphabet.blosum62())
_GAPS = {"linear": LINEAR, "affine": AFFINE}

#: Dense (B, m, n): n (53) not a multiple of 16 or 8; reads padded to at
#: most 20 rows against refs of 53 (long NW LEFT runs across words), and
#: refs padded to at most 21 columns against reads of 37 (NW UP chains to
#: column -1).
_DENSE_SHAPE = (16, 37, 53)
#: Banded: (B, m, n); band 8 in the canonical flavor, 12 in the SSE one.
_BANDED_SHAPE = (16, 40, 52)

_FIELDS = ("read", "ref", "score", "cigar", "read_start", "read_end",
           "ref_start", "ref_end", "buffer_start", "buffer_end")


def _fields(a):
    return tuple(getattr(a, f) for f in _FIELDS)


def _block(x: np.ndarray, fill: int = 0):
    """(B, ...) -> (1, ..., 8, 128), pairs past B filled with ``fill``."""
    x = np.asarray(x, dtype=np.int32)
    out = np.full((1024,) + x.shape[1:], fill, np.int32)
    out[:x.shape[0]] = x
    out = out.reshape((8, 128) + x.shape[1:])
    return jnp.asarray(np.moveaxis(out, (0, 1), (-2, -1))[None])


def _unblock(y, b: int) -> np.ndarray:
    y = np.moveaxis(np.asarray(y)[0], (-2, -1), (0, 1))
    return y.reshape((1024,) + y.shape[2:])[:b]


def _periodic(length: int, phase: int) -> np.ndarray:
    return np.tile(np.array([1, 2, 3, 4], np.uint8), length // 4 + 2)[phase:phase + length]


def _dense_pairs(rng, b, m, n, params):
    """Random pairs with ~5% N (residues under a matrix), half the reads
    padded to at most 20 rows and half the refs to at most 21 columns, one
    all-padding read, a periodic read against a periodic ref (ties, long
    LEFT runs) and a read copied from its ref (a DIAG run)."""
    if params.matrix is None:
        reads = random_codes(rng, b, m, n_prob=0.05)
        refs = random_codes(rng, b, n, n_prob=0.05)
    else:
        reads = rng.integers(1, 21, size=(b, m)).astype(np.uint8)
        refs = rng.integers(1, 21, size=(b, n)).astype(np.uint8)
    for k in range(0, b, 2):
        reads[k, rng.integers(1, 21):] = 0
        refs[k + 1, rng.integers(1, 22):] = 0
    reads[0] = 0
    reads[1], refs[1] = _periodic(m, 1), _periodic(n, 0)
    reads[2, :min(m, n)] = refs[2, :min(m, n)]
    return reads, refs


def _banded_pairs(rng, b, m, n):
    """Random pairs with ~5% N and padding, reads copied from their ref
    with a deletion or an insertion of 3-6 bases (LEFT and UP runs), and
    one all-padding read (NW's mrp < 0)."""
    reads = random_codes(rng, b, m, padded=True, n_prob=0.05)
    refs = random_codes(rng, b, n, n_prob=0.05)
    for k in range(2, b, 2):
        cut, gap = int(rng.integers(8, m - 8)), int(rng.integers(3, 7))
        src = np.concatenate([refs[k, :cut], refs[k, cut + gap:]]) if k % 4 else \
            np.concatenate([refs[k, :cut], rng.integers(1, 5, gap), refs[k, cut:]])
        reads[k] = src[:m]
    reads[0] = 0
    return reads, refs


def _random_words(rng, b, m, nw, band, affine):
    """Pointer words of random codes, LEFT 60% of the time (long runs
    across words), fields past the band 0: 2-bit codes in the low 16 bits
    of a word, or 4-bit codes with random extend bits."""
    codes = np.where(rng.random((b, m, nw * 8)) < 0.6, 2, rng.integers(0, 4, (b, m, nw * 8)))
    if affine:
        codes = codes | (rng.integers(0, 4, codes.shape) << 2)
    codes[:, :, band:] = 0
    bits = 4 if affine else 2
    words = (codes.reshape(b, m, nw, 8) << (bits * np.arange(8))).sum(axis=3)
    return torch.from_numpy(words.astype(np.int64).astype(np.uint32).view(np.int32))


def _band_exits(records, start_r, start_f, offsets, band):
    """Count the walks that stop on the band's right edge (a row entered
    past the band) and on its left edge above column 0 (a row entered left
    of the band, or a LEFT run down to the band's start)."""
    right = left = 0
    for rec, r, fp in zip(records, start_r, start_f):
        r, fp = int(r), int(fp)
        while r >= 0:
            k, code = int(rec[r]) >> 2, int(rec[r]) & 3
            off = int(offsets[r])
            if code == 0:
                right += fp - off >= band
                left += off > 0 and (fp < off or fp - k == off - 1)
                break
            fp -= k + (code == 3)
            r -= 1
    return right, left


def _check_replay(records, starts, reads, refs, want_raw, want_objs, params, alg):
    """``replay_batch`` of the records == the host decode of the pointer
    words, every column and every Alignment field; ``replay_one`` == both on
    a few pairs."""
    start_r, start_f, scores = (x.numpy() for x in starts)
    got = walks.replay_batch(records, reads, refs, start_r, start_f, scores, params, alg,
                             raw=True)
    for col in ("meta", "cigar", "read_gapped", "ref_gapped"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want_raw, col))
    objs = walks.replay_batch(records, reads, refs, start_r, start_f, scores, params, alg)
    assert [_fields(a) for a in objs] == [_fields(a) for a in want_objs]
    for k in range(4):
        one = walks.replay_one(records[k], reads[k], refs[k], start_r[k], start_f[k],
                               scores[k], params, alg)
        assert _fields(one) == _fields(want_objs[k])


def _dense_case(reads, refs, params, alg, tie):
    b, m = reads.shape
    n = refs.shape[1]
    affine = params.affine
    local = alg == Algorithm.SMITH_WATERMAN
    mrp = cuda_align.last_valid_pos(reads, tie, params.matrix)
    mxp = cuda_align.last_valid_pos(refs, tie, params.matrix)
    ptr, aux, hsel = cuda_align.fill(torch.from_numpy(reads), torch.from_numpy(refs),
                                     torch.from_numpy(mrp), params, alg, tie)
    plain_walk = walks.walk_dense_affine if affine else walks.walk_dense
    records, *starts = plain_walk(ptr, aux, hsel, torch.from_numpy(mrp),
                                  torch.from_numpy(mxp), n, local)
    jax_fn = jax_walk.walk_blocks_affine if affine else jax_walk.walk_blocks
    want = jax_fn(_block(ptr.numpy()), _block(aux.numpy()),
                  None if hsel is None else _block(hsel.numpy()), _block(mrp, -1),
                  _block(mxp, -1), m=m, n=n, pack=8 if affine else 16, local=local)
    np.testing.assert_array_equal(records.numpy(), _unblock(want[0], b))
    for got, w in zip(starts, want[1:]):
        np.testing.assert_array_equal(got.numpy(), _unblock(w, b))
    assert (records.numpy() != 0).any()
    pack = cuda_align.AFFINE_PACK if affine else cuda_align.PACK
    sr, sf, sc = cuda_align.start_cells(aux.numpy(), None if hsel is None else hsel.numpy(),
                                        mrp, refs, tie, local, params.matrix)
    decode = lambda raw: decode_batch_native(  # noqa: E731
        (ptr.numpy(), pack), reads, refs, sr, sf, params, alg, sc, affine=affine, raw=raw)
    _check_replay(records.numpy(), starts, reads, refs, decode(True), decode(False), params,
                  alg)


@pytest.mark.parametrize("tie", list(TieBreak))
@pytest.mark.parametrize("alg", list(Algorithm))
@pytest.mark.parametrize("gap", list(_GAPS))
def test_dense_walk_matches_jax(gap, alg, tie):
    params = _GAPS[gap]
    seed = 3 * int(alg) + int(tie) + 50 * params.affine
    reads, refs = _dense_pairs(np.random.default_rng(seed), *_DENSE_SHAPE, params)
    _dense_case(reads, refs, params, alg, tie)


def test_dense_walk_matches_jax_blosum62():
    reads, refs = _dense_pairs(np.random.default_rng(100), *_DENSE_SHAPE, BLOSUM62)
    _dense_case(reads, refs, BLOSUM62, Algorithm.SMITH_WATERMAN, TieBreak.DIAG_UP_LEFT)


@pytest.mark.parametrize("tie", list(TieBreak))
@pytest.mark.parametrize("alg", list(Algorithm))
@pytest.mark.parametrize("gap", list(_GAPS))
def test_banded_walk_matches_jax(gap, alg, tie):
    b, m, n = _BANDED_SHAPE
    band = 8 if tie == TieBreak.DIAG_UP_LEFT else 12
    params = _GAPS[gap]
    affine = params.affine
    local = alg == Algorithm.SMITH_WATERMAN
    reads, refs = _banded_pairs(np.random.default_rng(70 + 3 * int(alg) + int(tie)), b, m, n)
    offsets = band_offsets(m, m, n, band)
    mrp = cuda_align.last_valid_pos(reads, tie, params.matrix)
    mxp = cuda_align.last_valid_pos(refs, tie, params.matrix)
    ptr, best, keep = plain_banded.banded_fill(torch.from_numpy(reads), torch.from_numpy(refs),
                                               offsets, torch.from_numpy(mrp), params, alg,
                                               tie, band)
    plain_walk = walks.walk_banded_affine if affine else walks.walk_banded
    records, *starts = plain_walk(ptr, best, keep, torch.from_numpy(mrp),
                                  torch.from_numpy(mxp), torch.from_numpy(offsets), n, band,
                                  local)
    jax_fn = jax_walk.walk_blocks_banded_affine if affine else jax_walk.walk_blocks_banded
    zeros = np.zeros((b, 4 if local else band), np.int32)
    want = jax_fn(_block(ptr.numpy()), _block(zeros if best is None else best.numpy()),
                  _block(zeros if keep is None else keep.numpy()), _block(mrp, -1),
                  _block(mxp, -1), jnp.asarray(offsets), jnp.asarray(offsets),
                  m=m, n=n, band=band, local=local)
    np.testing.assert_array_equal(records.numpy(), _unblock(want[0], b))
    for got, w in zip(starts, want[1:]):
        np.testing.assert_array_equal(got.numpy(), _unblock(w, b))
    # The host walk's start cells: SW the best registers, NW nw_end_cells.
    if local:
        sr, sf, sc = (best.numpy()[:, i] for i in (1, 2, 0))
    else:
        sr, sf, sc = plain_banded.nw_end_cells(keep.numpy(), mrp, mxp, offsets, band, n)
    for got, w in zip(starts, (sr, sf, sc)):
        np.testing.assert_array_equal(got.numpy(), w)
    decode = lambda raw: decode_banded_native(  # noqa: E731
        ptr.numpy(), band, ptr.shape[2] * 8, offsets, offsets, reads, refs, sr, sf, params,
        alg, sc, raw=raw)
    _check_replay(records.numpy(), starts, reads, refs, decode(True), decode(False), params,
                  alg)


@pytest.mark.parametrize("alg", list(Algorithm))
@pytest.mark.parametrize("gap", list(_GAPS))
def test_banded_walk_on_random_words_matches_jax(gap, alg):
    """Random band-relative words (LEFT runs across words, random Gotoh
    extend bits) and random start cells, whose walks leave the band on both
    edges, which a fill's words reach only at the matrix's column -1."""
    b, m, n = 64, 40, 52
    band = 8 if gap == "linear" else 12
    affine = gap == "affine"
    local = alg == Algorithm.SMITH_WATERMAN
    rng = np.random.default_rng(90 + 2 * int(alg) + affine)
    offsets = band_offsets(m, m, n, band)
    nw = -(-band // 8)
    ptr = _random_words(rng, b, m, nw, band, affine)
    rows = rng.integers(0, m, b)
    best = np.stack([rng.integers(0, 50, b), rows, offsets[rows] + rng.integers(0, band, b),
                     np.zeros(b, np.int64)], axis=1).astype(np.int32)
    keep = rng.integers(-20, 20, (b, band)).astype(np.int32)
    mrp = np.where(rng.random(b) < 0.1, -1, rows).astype(np.int32)
    mxp = rng.integers(-1, n, b).astype(np.int32)
    records, *starts = (walks.walk_banded_affine if affine else walks.walk_banded)(
        ptr, torch.from_numpy(best), torch.from_numpy(keep), torch.from_numpy(mrp),
        torch.from_numpy(mxp), torch.from_numpy(offsets), n, band, local)
    jax_fn = jax_walk.walk_blocks_banded_affine if affine else jax_walk.walk_blocks_banded
    want = jax_fn(_block(ptr.numpy()), _block(best), _block(keep), _block(mrp, -1),
                  _block(mxp, -1), jnp.asarray(offsets), jnp.asarray(offsets),
                  m=m, n=n, band=band, local=local)
    np.testing.assert_array_equal(records.numpy(), _unblock(want[0], b))
    for got, w in zip(starts, want[1:]):
        np.testing.assert_array_equal(got.numpy(), _unblock(w, b))
    right, left = _band_exits(records.numpy(), *(x.numpy() for x in starts[:2]), offsets, band)
    assert right > 0 and left > 0, (right, left)
    # The host decode stops where the walk does on these words too.
    reads, refs = random_codes(rng, b, m), random_codes(rng, b, n)
    params = AFFINE if affine else LINEAR
    sr, sf, sc = (x.numpy() for x in starts)
    decode = lambda raw: decode_banded_native(  # noqa: E731
        ptr.numpy(), band, nw * 8, offsets, offsets, reads, refs, sr, sf, params, alg, sc,
        raw=raw)
    _check_replay(records.numpy(), starts, reads, refs, decode(True), decode(False), params,
                  alg)


def test_replay_checks_record_shape():
    reads = np.ones((2, 5), np.uint8)
    with pytest.raises(ValueError, match="walk records"):
        replay_records_native(np.zeros((2, 4), np.int32), reads, reads, np.zeros(2),
                              np.zeros(2), np.zeros(2), LINEAR, Algorithm.SMITH_WATERMAN)


def test_resolve_device_walk():
    # None walks on the card for CUDA and on the host for the CPU, as the
    # JAX package walks on the device when compiled and on the host in
    # interpret mode; True and False stay as given.
    resolve = cuda_walk.resolve_device_walk
    assert resolve(None, torch.device("cuda")) is True
    assert resolve(None, torch.device("cuda", 1)) is True
    assert resolve(None, torch.device("cpu")) is False
    assert resolve(None, "cpu") is False
    for dev in ("cpu", "cuda"):
        assert resolve(True, dev) is True and resolve(False, dev) is False


def test_defaults_walk_where_the_device_says(monkeypatch):
    """On the CPU the default engine, backend, model and banded path walk on
    the host; ``device_walk=True`` takes the plain walk, with the same
    output."""
    calls = []
    for name in ("walk", "banded_walk"):
        fn = getattr(cuda_walk, name)
        monkeypatch.setattr(cuda_walk, name,
                            lambda *a, _fn=fn, _name=name, **kw: calls.append(_name) or _fn(*a, **kw))
    rng = np.random.default_rng(3)
    reads = random_codes(rng, 5, 14, padded=True, n_prob=0.05)
    refs = random_codes(rng, 5, 19, padded=True, n_prob=0.05)
    from versalignlib_tpu_torch import models
    from versalignlib_tpu_torch.ops.banded import banded_align_batch

    alg = Algorithm.NEEDLEMAN_WUNSCH
    host = AlignmentEngine(AFFINE, device="cpu").compute_alignments(alg, reads, refs)
    assert AlignmentEngine(AFFINE, device="cpu").device_walk is None
    assert CudaBackend("cpu").compute_alignments(alg, reads, refs, AFFINE,
                                                 TieBreak.DIAG_UP_LEFT) == host
    assert models.banded_smith_waterman(band=8).align(reads, refs, device="cpu")
    assert banded_align_batch(reads, refs, LINEAR, alg, band=8, device="cpu")
    assert calls == []
    walked = AlignmentEngine(AFFINE, device="cpu", device_walk=True).compute_alignments(
        alg, reads, refs)
    assert walked == host and calls == ["walk"]
    banded = models.banded_smith_waterman(band=8)
    assert dataclasses.replace(banded, device_walk=True).align(reads, refs, device="cpu") == \
        banded.align(reads, refs, device="cpu")
    assert calls == ["walk", "banded_walk"]


@pytest.mark.parametrize("params", [LINEAR, AFFINE], ids=["linear", "affine"])
def test_align_batch_walks_on_request(params):
    """``cuda_align.align_batch`` keeps the host walk as its default; with
    ``device_walk=True`` it replays the walk's records into the same output,
    in chunks, with texts and without the gapped strings."""
    rng = np.random.default_rng(8 + params.affine)
    reads = random_codes(rng, 9, 23, padded=True, n_prob=0.05)
    refs = random_codes(rng, 9, 30, padded=True, n_prob=0.05)
    texts = (["r%d" % k * 5 for k in range(9)], ["f%d" % k * 8 for k in range(9)])
    for alg in Algorithm:
        for tie in TieBreak:
            args = (reads, refs, params, alg, tie, "cpu", 4)
            for kw in ({}, {"read_texts": texts[0], "ref_texts": texts[1]}):
                assert cuda_align.align_batch(*args, device_walk=True, **kw) == \
                    cuda_align.align_batch(*args, **kw)
            got = cuda_align.align_batch(*args, raw=True, device_walk=True, gapped=False)
            want = cuda_align.align_batch(*args, raw=True, gapped=False)
            for col in ("meta", "cigar"):
                np.testing.assert_array_equal(getattr(got, col), getattr(want, col))
            assert got.read_gapped is None


def test_wrappers_take_the_plain_walk_on_the_cpu():
    rng = np.random.default_rng(5)
    reads = random_codes(rng, 4, 12, padded=True)
    refs = random_codes(rng, 4, 17, padded=True)
    mrp = torch.from_numpy(cuda_align.last_valid_pos(reads, TieBreak.DIAG_UP_LEFT))
    mxp = torch.from_numpy(cuda_align.last_valid_pos(refs, TieBreak.DIAG_UP_LEFT))
    r, f = torch.from_numpy(reads), torch.from_numpy(refs)
    before = (cuda_walk.WALK_KERNEL.launches, cuda_walk.BANDED_WALK_KERNEL.launches)
    out = plain.align_batch(r, f, mrp, LINEAR, Algorithm.NEEDLEMAN_WUNSCH,
                            TieBreak.DIAG_UP_LEFT)
    got = cuda_walk.walk(*out, mrp, mxp, 17, False, False)
    want = walks.walk_dense(*out, mrp, mxp, 17, False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        cuda_walk.walk(out[0], out[1], None, mrp, mxp, 17, False, False)
    with pytest.raises(ValueError):
        cuda_walk.walk(*out, mrp, mxp, 17, False, True)  # 16 codes a word, not 8
    offsets = band_offsets(12, 12, 17, 6)
    out = plain_banded.banded_fill(r, f, offsets, mrp, AFFINE, Algorithm.SMITH_WATERMAN,
                                   TieBreak.DIAG_UP_LEFT, 6)
    got = cuda_walk.banded_walk(*out, mrp, mxp, offsets, 17, 6, True, True)
    want = walks.walk_banded_affine(*out, mrp, mxp, torch.from_numpy(offsets), 17, 6, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        cuda_walk.banded_walk(*out, mrp, mxp, offsets[:-1], 17, 6, True, True)
    assert (cuda_walk.WALK_KERNEL.launches, cuda_walk.BANDED_WALK_KERNEL.launches) == before


def test_plans_count_the_walk():
    # Dense: the fill's bytes, then 4 bytes of records a row, the three
    # start outputs and mxp (16 bytes) a pair; dense_fits follows it.
    m = n = 512
    fill = (m + n) + 4 + 4 * m * 32 + 16 + 4 * (n + 1)
    assert cuda_align.align_mem_plan(m, n, 1) == fill + 4 * m + 16
    plan = cuda_align.align_mem_plan(m, n, 32)
    caps = DeviceCapabilities("card", 132, plan, None)
    assert caps.dense_fits(m, n, "align")
    assert not dataclasses.replace(caps, memory_bytes=plan - 1).dense_fits(m, n, "align")
    # Banded rounds with the walk on the device are sized by device memory
    # (16 GiB of pointer words), not by the 2.25 GiB page-locked cap, in
    # whole waves of four pairs per SM.
    assert cuda_banded.WALK_CHUNK_PTR_BYTES == 1 << 34
    for m, want, capped in ((16000, 3696, 528), (100_000, 528, 94)):
        pairs = cuda_banded.chunk_pairs_for(m, 512, 132, cuda_banded.WALK_CHUNK_PTR_BYTES)
        assert pairs == want and pairs * 4 * m * 64 <= cuda_banded.WALK_CHUNK_PTR_BYTES
        assert cuda_banded.chunk_pairs_for(m, 512, 132) == capped
