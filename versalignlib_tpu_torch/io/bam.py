"""BAM output: BGZF-compressed binary SAM (production interop surface; the
port's copy of ``versalignlib_tpu/io/bam.py``).

ADDITIVE — the reference emits only its own text format
(src/impl/main.cpp:146-155). Downstream genomics tooling
consumes BAM; this module converts the SAM this framework already emits
(io/sam.py) into spec-conformant BAM (SAM/BAM spec v1.6, section 4):

- **BGZF** container: a sequence of <= 64KB gzip members, each carrying the
  ``BC`` extra subfield with the compressed block size, terminated by the
  fixed 28-byte EOF block. Every BGZF file is a valid multi-member gzip
  stream (``gzip.decompress`` reads it — the tests exploit this).
- **BAM records**: binary-encoded alignment rows — 4-bit packed SEQ
  ("=ACMGRSVTWYHKDBN"), 28+4-bit CIGAR ops, reg2bin index bin, and typed
  tags (``i``/``Z``/``A``/``f``).

The writer is deliberately a SAM **converter** (text in, BAM out): the SAM
layer is the single source of record semantics (FLAG bookkeeping, edge-op
normalization, NM/MD), so BAM can never drift from it. ``read_bam`` is an
independent decoder used by the round-trip tests; it reconstructs the SAM
text and must reproduce the input byte-for-byte.
"""

from __future__ import annotations

import gzip
import io
import pathlib
import struct
import zlib

#: 4-bit SEQ codes, SAM spec table ("=ACMGRSVTWYHKDBN").
_SEQ_NIBBLES = "=ACMGRSVTWYHKDBN"
_NIBBLE_OF = {c: i for i, c in enumerate(_SEQ_NIBBLES)}
_CIGAR_OPS = "MIDNSHP=X"
_CIGAR_OF = {c: i for i, c in enumerate(_CIGAR_OPS)}

#: Fixed BGZF end-of-file marker block (SAM spec 4.1.2).
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_MAX_BLOCK = 0xFF00  # uncompressed bytes per BGZF block


def _bgzf_block(payload: bytes) -> bytes:
    """One BGZF block: gzip member with the BC/BSIZE extra subfield."""
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = comp.compress(payload) + comp.flush()
    bsize = len(cdata) + 25 + 1  # header(12) + extra(6) + crc/isize(8) - 1
    if bsize >= 1 << 16:
        raise ValueError("BGZF block overflow (incompressible payload)")
    return (
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"  # gzip hdr, FEXTRA
        + struct.pack("<H", 6)                       # XLEN
        + b"BC" + struct.pack("<HH", 2, bsize)       # BC subfield: BSIZE-1
        + cdata
        + struct.pack("<II", zlib.crc32(payload), len(payload) & 0xFFFFFFFF)
    )


def bgzf_compress(data: bytes) -> bytes:
    """Whole-stream BGZF: <=64KB blocks + the EOF marker."""
    out = []
    for lo in range(0, len(data), _MAX_BLOCK):
        out.append(_bgzf_block(data[lo : lo + _MAX_BLOCK]))
    out.append(BGZF_EOF)
    return b"".join(out)


def reg2bin(beg: int, end: int) -> int:
    """SAM spec 4.2.1: the smallest R-tree bin containing [beg, end)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _encode_tag(tag: str) -> bytes:
    """SAM text tag (``XX:T:value``) -> BAM binary tag."""
    name, typ, val = tag.split(":", 2)
    out = name.encode()
    if typ == "i":
        return out + b"i" + struct.pack("<i", int(val))
    if typ == "f":
        return out + b"f" + struct.pack("<f", float(val))
    if typ == "A":
        return out + b"A" + val[:1].encode()
    if typ == "Z":
        return out + b"Z" + val.encode() + b"\x00"
    raise ValueError(f"unsupported SAM tag type {typ!r} in {tag!r}")


def _encode_record(fields: list[str], ref_index: dict[str, int]) -> bytes:
    """One SAM text record (split fields) -> one BAM alignment block."""
    qname, flag, rname, pos_s, mapq, cigar, rnext, pnext_s, tlen, seq, qual \
        = fields[:11]
    pos = int(pos_s) - 1
    refid = ref_index.get(rname, -1)
    cig = []
    if cigar != "*":
        num = ""
        for ch in cigar:
            if ch.isdigit():
                num += ch
            else:
                cig.append((int(num) << 4) | _CIGAR_OF[ch])
                num = ""
    ref_span = sum(n >> 4 for n in cig if (n & 0xF) in (0, 2, 3, 7, 8))
    l_seq = 0 if seq == "*" else len(seq)
    if rnext == "=":
        next_refid = refid
    else:
        next_refid = ref_index.get(rnext, -1)
    body = struct.pack(
        "<iiBBHHHiiii",
        refid, pos,
        len(qname) + 1,
        int(mapq),
        reg2bin(max(pos, 0), max(pos, 0) + max(ref_span, 1)),
        len(cig),
        int(flag),
        l_seq,
        next_refid,
        int(pnext_s) - 1,
        int(tlen),
    )
    body += qname.encode() + b"\x00"
    body += struct.pack(f"<{len(cig)}I", *cig)
    packed = bytearray((l_seq + 1) // 2)
    for i in range(l_seq):
        nib = _NIBBLE_OF.get(seq[i].upper(), 15)  # unknown -> N
        packed[i // 2] |= nib << (4 if i % 2 == 0 else 0)
    body += bytes(packed)
    if qual == "*":
        body += b"\xff" * l_seq
    else:
        body += bytes(ord(c) - 33 for c in qual)
    for tag in fields[11:]:
        body += _encode_tag(tag)
    return struct.pack("<i", len(body)) + body


def sam_to_bam(sam_text: str) -> bytes:
    """Convert SAM text (with @SQ headers) to a complete BAM byte stream."""
    lines = sam_text.splitlines()
    header_lines = [l for l in lines if l.startswith("@")]
    records = [l for l in lines if l and not l.startswith("@")]
    refs: list[tuple[str, int]] = []
    for l in header_lines:
        if l.startswith("@SQ"):
            f = dict(kv.split(":", 1) for kv in l.split("\t")[1:])
            refs.append((f["SN"], int(f["LN"])))
    ref_index = {name: i for i, (name, _) in enumerate(refs)}
    text = ("\n".join(header_lines) + "\n").encode()
    payload = io.BytesIO()
    payload.write(b"BAM\x01")
    payload.write(struct.pack("<i", len(text)))
    payload.write(text)
    payload.write(struct.pack("<i", len(refs)))
    for name, length in refs:
        nb = name.encode() + b"\x00"
        payload.write(struct.pack("<i", len(nb)) + nb
                      + struct.pack("<i", length))
    for rec in records:
        payload.write(_encode_record(rec.split("\t"), ref_index))
    return bgzf_compress(payload.getvalue())


def write_bam(path, sam_text: str) -> None:
    """Write SAM text as a BAM file (BGZF + binary records)."""
    data = sam_to_bam(sam_text)
    if isinstance(path, (str, pathlib.Path)):
        pathlib.Path(path).write_bytes(data)
    else:
        path.write(data)


# ---------------------------------------------------------------------------
# Independent decoder (round-trip validation; not a general-purpose reader)
# ---------------------------------------------------------------------------

def read_bam(path_or_bytes) -> str:
    """Decode a BAM stream back to SAM text (headers + records).

    Written independently from the encoder against the spec so the
    round-trip test is meaningful. Supports the tag types the encoder
    emits (``i``/``f``/``A``/``Z``).
    """
    raw = (path_or_bytes if isinstance(path_or_bytes, bytes)
           else pathlib.Path(path_or_bytes).read_bytes())
    data = gzip.decompress(raw)  # BGZF is a multi-member gzip stream
    if data[:4] != b"BAM\x01":
        raise ValueError("not a BAM stream")
    off = 4
    (l_text,) = struct.unpack_from("<i", data, off)
    off += 4
    text = data[off : off + l_text].decode().rstrip("\x00")
    off += l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    ref_names = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4
        ref_names.append(data[off : off + l_name - 1].decode())
        off += l_name + 4  # skip l_ref
    out = [text.rstrip("\n")] if text else []
    while off < len(data):
        (block_size,) = struct.unpack_from("<i", data, off)
        off += 4
        end = off + block_size
        (refid, pos, l_qname, mapq, _bin, n_cig, flag, l_seq, next_refid,
         next_pos, tlen) = struct.unpack_from("<iiBBHHHiiii", data, off)
        off += 32
        qname = data[off : off + l_qname - 1].decode()
        off += l_qname
        cig = struct.unpack_from(f"<{n_cig}I", data, off)
        off += 4 * n_cig
        cigar = "".join(f"{c >> 4}{_CIGAR_OPS[c & 0xF]}" for c in cig) or "*"
        seq = ""
        for i in range(l_seq):
            b = data[off + i // 2]
            seq += _SEQ_NIBBLES[(b >> 4) if i % 2 == 0 else (b & 0xF)]
        off += (l_seq + 1) // 2
        qual_b = data[off : off + l_seq]
        off += l_seq
        qual = ("*" if l_seq == 0 or all(q == 0xFF for q in qual_b)
                else "".join(chr(q + 33) for q in qual_b))
        tags = []
        while off < end:
            name = data[off : off + 2].decode()
            typ = chr(data[off + 2])
            off += 3
            if typ == "i":
                (v,) = struct.unpack_from("<i", data, off)
                off += 4
                tags.append(f"{name}:i:{v}")
            elif typ == "f":
                (v,) = struct.unpack_from("<f", data, off)
                off += 4
                tags.append(f"{name}:f:{v}")
            elif typ == "A":
                tags.append(f"{name}:A:{chr(data[off])}")
                off += 1
            elif typ == "Z":
                z_end = data.index(b"\x00", off)
                tags.append(f"{name}:Z:{data[off:z_end].decode()}")
                off = z_end + 1
            else:
                raise ValueError(f"unsupported BAM tag type {typ!r}")
        rname = ref_names[refid] if refid >= 0 else "*"
        if next_refid < 0:
            rnext = "*"
        elif next_refid == refid:
            rnext = "="
        else:
            rnext = ref_names[next_refid]
        out.append("\t".join(
            [qname, str(flag), rname, str(pos + 1), str(mapq), cigar,
             rnext, str(next_pos + 1), str(tlen), seq or "*", qual] + tags))
    return "\n".join(out) + "\n"
