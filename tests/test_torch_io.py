"""The port's IO layer against the JAX package's on the same inputs: FASTA,
FASTQ, SAM (single-end, batch and paired, unmapped rows), BAM, the native
FASTA parser and SAM formatter, and device staging on the CPU. Every check
is ``==`` or a bytes comparison."""

import inspect
import io

import numpy as np
import pytest
import torch

from versalignlib_tpu import native as jax_native
from versalignlib_tpu.io import bam as jax_bam
from versalignlib_tpu.io import fasta as jax_fasta
from versalignlib_tpu.io import fastq as jax_fastq
from versalignlib_tpu.io import sam as jax_sam
from versalignlib_tpu.io.staging import prefetch_to_device as jax_prefetch
from versalignlib_tpu.types import Alignment as JaxAlignment
from versalignlib_tpu_torch import AlignmentEngine, AlignmentParameters, native
from versalignlib_tpu_torch.alphabet import decode, pad_and_encode
from versalignlib_tpu_torch.io import bam, fasta, fastq, sam
from versalignlib_tpu_torch.io.staging import prefetch_to_device
from versalignlib_tpu_torch.types import Algorithm, Alignment

_FASTA = (">a\nACGTacgt\nNNTT\n>bad\nAC GT\nACGT\n>b desc\nGGGG\n\nignored\n"
          ">c\nc\n>d\nTTGCAXYZ\n>e")
_FASTQ = "@r0 x\nACGT\n+\nII!I\n\n@r1\nGG\n+r1\n#J\n@ \nAC\n+\nII\n"


def _jax_aln(a: Alignment) -> JaxAlignment:
    return JaxAlignment(**vars(a))


@pytest.fixture
def files(tmp_path):
    fa, fq = tmp_path / "x.fa", tmp_path / "x.fq"
    fa.write_text(_FASTA)
    fq.write_text(_FASTQ)
    return fa, fq


def test_fasta_and_fastq_parsers_match(files, tmp_path):
    fa, fq = files
    for name in ("parse_fasta", "parse_fasta_with_names"):
        assert getattr(fasta, name)(fa) == getattr(jax_fasta, name)(fa)
    assert list(fasta.iter_fasta(fa)) == list(jax_fasta.iter_fasta(fa))
    assert (list(fasta.iter_fasta_chunks(fa, 2))
            == list(jax_fasta.iter_fasta_chunks(fa, 2)))
    crlf = _FASTA.replace("\n", "\r\n")
    assert fasta.parse_fasta(io.StringIO(crlf)) == jax_fasta.parse_fasta(io.StringIO(crlf))
    assert (list(fasta.iter_fasta(io.StringIO(crlf)))
            == list(jax_fasta.iter_fasta(io.StringIO(crlf))))
    for path in (fa, fq):
        for name in ("sniff_format", "parse_sequences", "parse_sequences_with_names",
                     "parse_records", "count_sequences"):
            assert getattr(fastq, name)(path) == getattr(jax_fastq, name)(path), name
        assert (list(fastq.iter_sequence_chunks(path, 2))
                == list(jax_fastq.iter_sequence_chunks(path, 2)))
    assert fastq.parse_fastq_with_names(fq) == jax_fastq.parse_fastq_with_names(fq)
    assert (fastq.parse_fastq_with_names(io.StringIO(_FASTQ.replace("\n", "\r\n")))
            == jax_fastq.parse_fastq_with_names(io.StringIO(_FASTQ.replace("\n", "\r\n"))))
    assert fastq.parse_records(fq)[0] == ("r0", "ACGT", "II!I")


@pytest.mark.parametrize("text, match", [
    ("not_a_header\nACGT\n+\nIIII\n", "@"),
    ("@r0\nACGT\nIIII\nACGT\n", r"\+"),
    ("@r0\nACGT\n+\nII\n", "length"),
    ("@r0\nACGT\n", "truncated"),
])
def test_fastq_rejects_what_the_jax_parser_rejects(tmp_path, text, match):
    path = tmp_path / "bad.fq"
    path.write_text(text)
    with pytest.raises(ValueError, match=match) as got:
        fastq.parse_fastq(path)
    with pytest.raises(ValueError) as want:
        jax_fastq.parse_fastq(path)
    assert str(got.value) == str(want.value)


def test_fasta_and_fastq_writers_match(tmp_path):
    seqs = ["ACGT" * 30, "TT", ""]
    quals = ["I" * 120, "#J", ""]
    for mod, jmod, ext in ((fasta, jax_fasta, "fa"), (fastq, jax_fastq, "fq")):
        got, want = tmp_path / f"got.{ext}", tmp_path / f"want.{ext}"
        if mod is fasta:
            mod.write_fasta(got, seqs, names=["r1", "r2", "r3"], width=7)
            jmod.write_fasta(want, seqs, names=["r1", "r2", "r3"], width=7)
        else:
            mod.write_fastq(got, seqs, qualities=quals)
            jmod.write_fastq(want, seqs, qualities=quals)
        assert got.read_bytes() == want.read_bytes()
    with pytest.raises(ValueError, match="quality length"):
        fastq.write_fastq(tmp_path / "bad.fq", ["ACGT"], qualities=["II"])


def test_native_fasta_parser(files):
    fa, _ = files
    assert native.available()
    codes, lengths = native.parse_fasta_codes(fa)
    want_codes, want_lengths = jax_native.parse_fasta_codes(fa)
    np.testing.assert_array_equal(codes, want_codes)
    np.testing.assert_array_equal(lengths, want_lengths)
    seqs = fasta.parse_fasta(fa)
    np.testing.assert_array_equal(codes, pad_and_encode(seqs))
    assert list(lengths) == [len(s) for s in seqs]
    with pytest.raises(OSError):
        native.parse_fasta_codes(fa.parent / "nope.fa")


def test_native_available_is_false_when_the_build_fails(monkeypatch):
    def fail():
        raise RuntimeError("native decoder build failed")

    monkeypatch.setattr(native, "_load", fail)
    assert native.available() is False


@pytest.mark.parametrize("name, extra", [
    ("decode_batch_native", ()), ("decode_banded_native", ("gapped",)),
    ("replay_records_native", ()), ("parse_fasta_codes", ()),
    ("format_sam_native", ())])
def test_native_signatures_match(name, extra):
    """Same parameter names, order, kinds and defaults as the JAX package;
    ``decode_banded_native`` adds ``gapped`` last, by design."""
    def params(fn):
        return [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()]

    port = params(getattr(native, name))
    assert port[:len(port) - len(extra)] == params(getattr(jax_native, name))
    assert [p[0] for p in port[len(port) - len(extra):]] == list(extra)


def _batch_case(rng, params, algorithm, b=24, low=0):
    """Random pairs with codes from ``low`` (0: padding inside sequences, as
    the JAX package's formatter test makes them; 1: valid SEQ fields)."""
    reads = rng.integers(low, 6, size=(b, 30)).astype(np.uint8)
    refs = rng.integers(low, 6, size=(b, 40)).astype(np.uint8)
    reads[0, :] = 0  # all padding: an unmapped record
    batch = AlignmentEngine(params, device="cpu").compute_alignments(
        algorithm, reads, refs, raw=True)
    seqs = [decode(r) for r in reads]
    cols = dict(read_names=[f"q{i}" for i in range(b)],
                ref_names=[f"c{i % 3}" for i in range(b)],
                strands=[i % 2 for i in range(b)],
                mapqs=[int(v) for v in rng.integers(0, 61, size=b)],
                quals=["".join(chr(33 + int(x)) for x in rng.integers(0, 40, size=len(s)))
                       for s in seqs])
    return batch, seqs, [decode(f) for f in refs], cols


_AFFINE = dict(score_match=2, score_mismatch=-1, score_gap_read=-1, score_gap_ref=-1,
               gap_open_read=-4, gap_open_ref=-4)


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("algorithm", list(Algorithm))
def test_sam_writers_match(affine, algorithm):
    """write_sam on Alignment objects, write_sam_batch through the native
    formatter (1 and 8 threads) and through the Python path, with and
    without qualities: the JAX writer's bytes."""
    rng = np.random.default_rng(7 + 2 * int(algorithm) + affine)
    params = AlignmentParameters(**_AFFINE) if affine else AlignmentParameters()
    batch, seqs, refs, cols = _batch_case(rng, params, algorithm)
    for kw in (cols, {k: cols[k] for k in ("read_names", "ref_names")}):
        want = io.StringIO()
        jax_sam.write_sam(want, [_jax_aln(a) for a in batch], seqs, refs, **kw)
        got = io.StringIO()
        sam.write_sam(got, list(batch), seqs, refs, **kw)
        assert got.getvalue() == want.getvalue()
        got = io.StringIO()
        sam.write_sam_batch(got, batch, seqs, refs, **kw)
        assert got.getvalue() == want.getvalue()
    strands = cols["strands"]
    args = (batch, seqs, cols["read_names"], cols["ref_names"],
            np.array([16 if s else 0 for s in strands], np.int32),
            np.full(len(seqs), 4, np.int32), np.asarray(cols["mapqs"]))
    one = native.format_sam_native(*args, quals=cols["quals"], n_threads=1)
    assert one == native.format_sam_native(*args, quals=cols["quals"], n_threads=8)
    assert one == jax_native.format_sam_native(*args, quals=cols["quals"])
    assert native.format_sam_native(batch.slice(0, 0), [], [], [], *args[4:]) == b""


def test_sam_batch_python_path_matches(monkeypatch):
    rng = np.random.default_rng(3)
    batch, seqs, refs, cols = _batch_case(rng, AlignmentParameters(),
                                          Algorithm.NEEDLEMAN_WUNSCH)
    want = io.StringIO()
    sam.write_sam_batch(want, batch, seqs, refs, **cols)
    monkeypatch.setattr(native, "available", lambda: False)
    got = io.StringIO()
    sam.write_sam_batch(got, batch, seqs, refs, **cols)
    assert got.getvalue() == want.getvalue()


_EDGE_ALIGNMENTS = [
    (Alignment("--ACGT", "TTACGT", 8, "2D4M", 0, 4, 0, 6), "ACGTGG", None),
    (Alignment("ACGTT", "ACGT-", 6, "4M1I", 1, 6, 0, 4), "GACGTT", "IIIIII"),
    (Alignment("--", "TT", 0, "2D", 0, 2, 0, 2), "AC", None),
    (Alignment("ACTTGG--CT", "ACCT--GACT", 5, "4M2I2D2M", 1, 9, 0, 8), "AACTTGGCTA",
     "IIIIIIIIII"),
    (Alignment("AAAA", "ACCA", 2, "4M", 0, 4, 0, 4), "AAAA", None),
    (Alignment("", "", 0, "", -1, -1, -1, -1), "ACGT", None),
]


def test_sam_records_and_paired_writer_match():
    for aln, seq, qual in _EDGE_ALIGNMENTS:
        for kw in ({}, dict(reverse=True, mapq=17, flag_bits=0x41, rnext="=", pnext=4,
                            tlen=-30)):
            assert (sam.sam_record(aln, seq, "r", "c", qual=qual, **kw)
                    == jax_sam.sam_record(_jax_aln(aln), seq, "r", "c", qual=qual, **kw))
        assert sam.ref_span(aln, len(seq)) == jax_sam.ref_span(_jax_aln(aln), len(seq))
    with pytest.raises(ValueError, match="quality length"):
        sam.sam_record(_EDGE_ALIGNMENTS[4][0], "AAAA", "r", "c", qual="II")
    # Paired: both mapped either way round, one or both mates unmapped.
    alns = [a for a, _, _ in _EDGE_ALIGNMENTS]
    seqs = [s for _, s, _ in _EDGE_ALIGNMENTS]
    order = [1, 0, 3, 2, 5, 4]
    a2, s2 = [alns[i] for i in order], [seqs[i] for i in order]
    refs = ["TTACGTACGTTTGACCTGACT"] * len(alns)
    kw = dict(ref_names=["chr1", "chr1", "chr2", "chr2", "chr3", "chr3"],
              strands1=[0, 1, 0, 1, 0, 1], strands2=[1, 0, 1, 0, 0, 1],
              mapqs=[60, 3, 0, 255, 7, 9], quals1=[q for _, _, q in _EDGE_ALIGNMENTS])
    want = io.StringIO()
    jax_sam.write_sam_paired(want, [_jax_aln(a) for a in alns], [_jax_aln(a) for a in a2],
                             seqs, s2, refs, **kw)
    got = io.StringIO()
    sam.write_sam_paired(got, alns, a2, seqs, s2, refs, **kw)
    assert got.getvalue() == want.getvalue()
    with pytest.raises(ValueError, match="length mismatch"):
        sam.write_sam_paired(io.StringIO(), alns, a2[:2], seqs, s2, refs)


def test_bam_matches_and_round_trips(tmp_path):
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, size=200_000).astype(np.uint8).tobytes()
    assert bam.bgzf_compress(data) == jax_bam.bgzf_compress(data)
    assert bam.bgzf_compress(b"") == bam.BGZF_EOF == jax_bam.BGZF_EOF
    for beg, end in ((0, 1), (0, 1 << 14), (1 << 14, (1 << 14) + 1), (0, (1 << 14) + 1),
                     (0, 1 << 29), (5_000_000, 5_000_100)):
        assert bam.reg2bin(beg, end) == jax_bam.reg2bin(beg, end)
    batch, seqs, refs, cols = _batch_case(rng, AlignmentParameters(),
                                          Algorithm.SMITH_WATERMAN, low=1)
    text = io.StringIO()
    sam.write_sam_batch(text, batch, seqs, refs, **cols)
    paired = io.StringIO()
    alns = [a for a, _, _ in _EDGE_ALIGNMENTS]
    seqs2 = [s for _, s, _ in _EDGE_ALIGNMENTS]
    sam.write_sam_paired(paired, alns, alns[::-1], seqs2, seqs2[::-1],
                         ["TTACGTACGTTT"] * len(alns), ref_names=["c"] * len(alns))
    for sam_text in (text.getvalue(), paired.getvalue()):
        blob = bam.sam_to_bam(sam_text)
        assert blob == jax_bam.sam_to_bam(sam_text)
        assert bam.read_bam(blob) == sam_text == jax_bam.read_bam(blob)
        bam.write_bam(tmp_path / "x.bam", sam_text)
        assert bam.read_bam(tmp_path / "x.bam") == sam_text
    with pytest.raises(ValueError, match="not a BAM"):
        bam.read_bam(jax_bam.gzip.compress(b"nope"))


def _chunks(rng):
    return [(c, f"meta{c}", rng.integers(0, 9, size=(4, 6)).astype(np.uint8),
             rng.integers(0, 9, size=(4, 7)).astype(np.int32)) for c in range(5)]


@pytest.mark.parametrize("depth", [1, 2, 9])
def test_prefetch_to_device_on_the_cpu(depth):
    chunks = _chunks(np.random.default_rng(depth))
    got = list(prefetch_to_device(iter(chunks), depth=depth, device="cpu"))
    want = list(jax_prefetch(iter(chunks), depth=depth))
    assert [g[:2] for g in got] == [w[:2] for w in want] == [c[:2] for c in chunks]
    for g, w in zip(got, want):
        for k in (2, 3):
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def test_prefetch_to_device_order_of_staging_and_errors(monkeypatch):
    """``depth`` chunks are staged before the first is taken, then one a
    step; ``depth < 1`` raises; an empty stream yields nothing; without a
    card the default device raises."""
    seen = []

    def source():
        for c in range(4):
            seen.append(c)
            yield (c,)

    it = prefetch_to_device(source(), depth=2, device="cpu")
    assert next(it) == (0,) and seen == [0, 1, 2]
    assert list(it) == [(1,), (2,), (3,)]
    assert list(prefetch_to_device(iter([]), depth=2, device="cpu")) == []
    with pytest.raises(ValueError, match="depth"):
        next(prefetch_to_device(iter([(1,)]), depth=0, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(prefetch_to_device(iter([(np.zeros(3),)])))


def test_char_table_and_profiling_helpers(tmp_path):
    from versalignlib_tpu.alphabet import char_to_code_table as jax_table
    from versalignlib_tpu.utils.profiling import GcupsMeter as JaxMeter
    from versalignlib_tpu_torch.alphabet import char_to_code_table
    from versalignlib_tpu_torch.utils.profiling import GcupsMeter, annotate, trace

    table = char_to_code_table()
    np.testing.assert_array_equal(table, jax_table())
    table[ord("A")] = 9
    assert char_to_code_table()[ord("A")] == 1
    meter, want = GcupsMeter(), JaxMeter()
    for m in (meter, want):
        m.cells, m.seconds, m.calls = 3 * 10**9, 1.5, 2
    assert meter.report() == want.report() and meter.gcups == want.gcups == 2.0
    with meter.measure(10):
        pass
    assert meter.calls == 3 and meter.cells == 3 * 10**9 + 10
    with trace(str(tmp_path / "trace")) as prof:
        with annotate("val_region"):
            torch.ones(8).sum()
    assert "val_region" in {e.key for e in prof.key_averages()}
    assert len(list((tmp_path / "trace").glob("trace_*.json"))) == 1
