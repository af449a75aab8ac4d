"""Six-frame translation and translated protein search (blastx-style) — the
port of ``versalignlib_tpu/translate.py``.

DNA reads are translated in all six reading frames (three forward, three
reverse complement), every translation is scored against a protein panel
with a substitution matrix (BLOSUM62 by default) through the one-vs-many
kernel (``search.score_matrix``), and each read's best (frame, panel entry)
is reported. Conventions follow NCBI: stop codons translate to ``'*'``,
codons with any non-ACGT base (N, padding) to ``'X'``. Frames are +1/+2/+3
and -1/-2/-3; a reverse frame's protein reads along the reverse complement.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from versalignlib_tpu_torch.alphabet import (PROTEIN_ALPHABET, blosum62, encode,
                                             encode_custom, pad_and_encode)
from versalignlib_tpu_torch.dispatch import _resolve_device
from versalignlib_tpu_torch.ops import cuda_align
from versalignlib_tpu_torch.params import AlignmentParameters
from versalignlib_tpu_torch.search import score_matrix
from versalignlib_tpu_torch.stats import calibrate_scores
from versalignlib_tpu_torch.types import Algorithm, TieBreak

#: Standard genetic code, codon (DNA letters) -> amino acid letter.
GENETIC_CODE = {
    "TTT": "F", "TTC": "F", "TTA": "L", "TTG": "L",
    "CTT": "L", "CTC": "L", "CTA": "L", "CTG": "L",
    "ATT": "I", "ATC": "I", "ATA": "I", "ATG": "M",
    "GTT": "V", "GTC": "V", "GTA": "V", "GTG": "V",
    "TCT": "S", "TCC": "S", "TCA": "S", "TCG": "S",
    "CCT": "P", "CCC": "P", "CCA": "P", "CCG": "P",
    "ACT": "T", "ACC": "T", "ACA": "T", "ACG": "T",
    "GCT": "A", "GCC": "A", "GCA": "A", "GCG": "A",
    "TAT": "Y", "TAC": "Y", "TAA": "*", "TAG": "*",
    "CAT": "H", "CAC": "H", "CAA": "Q", "CAG": "Q",
    "AAT": "N", "AAC": "N", "AAA": "K", "AAG": "K",
    "GAT": "D", "GAC": "D", "GAA": "E", "GAG": "E",
    "TGT": "C", "TGC": "C", "TGA": "*", "TGG": "W",
    "CGT": "R", "CGC": "R", "CGA": "R", "CGG": "R",
    "AGT": "S", "AGC": "S", "AGA": "R", "AGG": "R",
    "GGT": "G", "GGC": "G", "GGA": "G", "GGG": "G",
}

# DNA code layout (alphabet.py): A=1, T=2, C=3, G=4; N=5; pad/other=0.
_CODE_BASE = "\0ATCGN"
#: (6, 6, 6) codon-code -> amino letter; any non-ACGT component -> 'X'.
_CODON_AA = np.full((6, 6, 6), "X", dtype="U1")
for _c1 in range(1, 5):
    for _c2 in range(1, 5):
        for _c3 in range(1, 5):
            _CODON_AA[_c1, _c2, _c3] = GENETIC_CODE[
                _CODE_BASE[_c1] + _CODE_BASE[_c2] + _CODE_BASE[_c3]]

#: Complement in code space: A(1)<->T(2), C(3)<->G(4); N/pad fixed.
_COMPLEMENT = np.array([0, 2, 1, 4, 3, 5], dtype=np.uint8)

FRAMES = (1, 2, 3, -1, -2, -3)


def translate_codes(codes: np.ndarray, frame: int) -> str:
    """Translate one encoded DNA sequence in one frame -> protein string.

    ``frame``: +1/+2/+3 read forward from offset frame-1; -1/-2/-3 read the
    reverse complement from offset |frame|-1. Trailing bases short of a
    full codon are dropped (NCBI convention).
    """
    codes = np.asarray(codes, dtype=np.uint8)
    if frame < 0:
        codes = _COMPLEMENT[codes[::-1]]
    off = abs(frame) - 1
    usable = (codes.size - off) // 3
    if usable <= 0:
        return ""
    c = codes[off:off + usable * 3].reshape(usable, 3)
    return "".join(_CODON_AA[c[:, 0], c[:, 1], c[:, 2]])


def translate_six_frames(seq) -> list[tuple[int, str]]:
    """DNA string or (L,) code array -> [(frame, protein), ...] for all 6."""
    codes = encode(seq) if isinstance(seq, str) else np.asarray(seq, dtype=np.uint8)
    return [(f, translate_codes(codes, f)) for f in FRAMES]


#: blastx-flavor defaults: BLOSUM62 with affine gaps (open 10, extend 1).
TRANSLATED_PARAMETERS = AlignmentParameters(
    score_gap_read=-1, score_gap_ref=-1, gap_open_read=-10, gap_open_ref=-10,
    matrix=blosum62())


@dataclasses.dataclass
class TranslatedHits:
    """Per-read best translated hit. ``scores`` is the full (B, 6, R) score
    tensor (frames in :data:`FRAMES` order), None with ``panel_chunk``.

    ``translated_search(..., alignments=True)`` fills the coordinate fields:
    the winning frame's protein-level alignment and its mapping back to DNA
    read coordinates, 0-based inclusive [dna_start, dna_end] on the forward
    strand of the read as given, ``strand`` '-' for reverse frames, and
    ``dna_cigar`` the protein CIGAR with counts x3. ``evalue``/``bitscore``
    come from a :func:`calibrate_translated` fit.
    """

    index: np.ndarray    # (B,) best panel entry
    frame: np.ndarray    # (B,) best reading frame (+-1/2/3)
    score: np.ndarray    # (B,) int32 best score
    scores: np.ndarray   # (B, 6, R) int32
    proteins: list[list[str]]  # per read, the 6 frame translations
    alignments: list | None = None      # (B,) types.Alignment (protein-level)
    dna_start: np.ndarray | None = None  # (B,) 0-based read coord of hit
    dna_end: np.ndarray | None = None    # (B,) inclusive end read coord
    strand: np.ndarray | None = None     # (B,) '+'/'-'
    dna_cigar: list[str] | None = None   # (B,) codon-scaled CIGAR
    evalue: np.ndarray | None = None     # (B,) float
    bitscore: np.ndarray | None = None   # (B,) float

    def __len__(self) -> int:
        return self.index.shape[0]


def _scale_cigar_dna(cigar: str) -> str:
    """Protein CIGAR -> DNA CIGAR: every run length x3 (codon granularity)."""
    out = []
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            out.append(f"{3 * int(num)}{ch}")
            num = ""
    return "".join(out)


def map_protein_to_dna(frame: int, read_len: int, prot_start: int,
                       prot_end: int) -> tuple[int, int, str]:
    """Map an inclusive protein-coordinate range of one reading frame back
    to 0-based inclusive forward-strand read coordinates."""
    if frame > 0:
        off = frame - 1
        return off + 3 * prot_start, off + 3 * prot_end + 2, "+"
    off = -frame - 1
    rc_lo = off + 3 * prot_start
    rc_hi = off + 3 * prot_end + 2
    return read_len - 1 - rc_hi, read_len - 1 - rc_lo, "-"


def translated_search(
    reads,
    panel,
    params: AlignmentParameters | None = None,
    algorithm: Algorithm = Algorithm.SMITH_WATERMAN,
    device: torch.device | str = "cuda",
    alignments: bool = False,
    calibration=None,
    panel_chunk: int | None = None,
) -> TranslatedHits:
    """Score DNA reads against a protein panel in all six reading frames.

    ``reads``: DNA strings or a (B, L) uint8 code array; ``panel``: protein
    strings or an (R, n) uint8 code array (PROTEIN_ALPHABET). All 6*B
    translations are scored against the panel in one
    :func:`~versalignlib_tpu_torch.search.score_matrix` sweep; ties keep the
    earlier frame in :data:`FRAMES` order, then the lower panel index.

    ``alignments=True`` aligns each read's winning (frame, entry) pair
    protein-vs-protein through the port's align path (one batched fill on
    the card) and maps the hit back to DNA read coordinates with a
    codon-scaled CIGAR. ``calibration`` (:func:`calibrate_translated`) adds
    E-value and bitscore. ``panel_chunk``: fold the best hit per read across
    panel chunks instead of keeping the (B, 6, R) host tensor (``scores`` is
    None then; the fold is lexicographic in (score, frame, panel index)).
    """
    params = TRANSLATED_PARAMETERS if params is None else params
    if params.matrix is None:
        raise ValueError(
            "translated_search needs a protein substitution matrix "
            "(params.matrix); default TRANSLATED_PARAMETERS uses BLOSUM62")
    device = _resolve_device(device)
    if isinstance(reads, np.ndarray) and reads.ndim == 2:
        read_codes = reads.astype(np.uint8)
    else:
        read_codes = pad_and_encode(list(reads))
    b = read_codes.shape[0]
    # Translate each read's trimmed codes: in a padded batch, reverse frames
    # would otherwise move the trailing padding to the front.
    read_lens = [int(nz.max()) + 1 if (nz := np.flatnonzero(read_codes[i])).size else 0
                 for i in range(b)]
    proteins = [[translate_codes(read_codes[i][:read_lens[i]], f) for f in FRAMES]
                for i in range(b)]
    queries = encode_custom([p for per_read in proteins for p in per_read], PROTEIN_ALPHABET)
    if isinstance(panel, np.ndarray) and panel.ndim == 2:
        panel_codes = panel.astype(np.uint8)
        panel_texts = None
    else:
        panel_texts = list(panel)
        panel_codes = encode_custom(panel_texts, PROTEIN_ALPHABET)
    n_panel = panel_codes.shape[0]

    def fold_chunk(scores, lo):
        """(B, 6, Rc) -> per-read (score, frame_pos, panel_index): best panel
        entry per (read, frame), then best frame; argmax keeps the first
        maximum, giving FRAMES-order then scan-order ties."""
        best_j = scores.argmax(axis=2)                        # (B, 6)
        best_per_frame = np.take_along_axis(scores, best_j[:, :, None], axis=2)[:, :, 0]
        best_f = best_per_frame.argmax(axis=1)                # (B,)
        rows = np.arange(scores.shape[0])
        return (best_per_frame[rows, best_f].astype(np.int32), best_f.astype(np.int32),
                (best_j[rows, best_f] + lo).astype(np.int32))

    if panel_chunk is None:
        scores = score_matrix(queries, panel_codes, params, algorithm, device=device)
        scores = np.asarray(scores, dtype=np.int32).reshape(b, len(FRAMES), n_panel)
        best_s, best_f, idx = fold_chunk(scores, 0)
    else:
        # Chunks ascend in panel index, so "strictly greater score, or equal
        # score with strictly earlier frame" reproduces the unchunked
        # (score, frame, index) tie order.
        scores = None
        best_s = np.full(b, np.iinfo(np.int32).min, np.int32)
        best_f = np.zeros(b, np.int32)
        idx = np.zeros(b, np.int32)
        for lo in range(0, n_panel, panel_chunk):
            pc = panel_codes[lo:lo + panel_chunk]
            sc = np.asarray(score_matrix(queries, pc, params, algorithm, device=device),
                            dtype=np.int32).reshape(b, len(FRAMES), pc.shape[0])
            cs, cf, cj = fold_chunk(sc, lo)
            take = (cs > best_s) | ((cs == best_s) & (cf < best_f))
            best_s = np.where(take, cs, best_s)
            best_f = np.where(take, cf, best_f)
            idx = np.where(take, cj, idx)
    hits = TranslatedHits(index=idx.astype(np.int32),
                          frame=np.array([FRAMES[f] for f in best_f], dtype=np.int32),
                          score=best_s.astype(np.int32), scores=scores, proteins=proteins)
    if calibration is not None:
        db_len = int(np.count_nonzero(panel_codes))
        qlens = np.maximum([len(proteins[i][best_f[i]]) for i in range(b)], 1)
        hits.bitscore = np.asarray(calibration.bit_score(hits.score))
        hits.evalue = np.asarray([calibration.evalue(int(s), int(q), db_len)
                                  for s, q in zip(hits.score, qlens)])
    if not alignments:
        return hits

    # The winning pairs, in one batched matrix-mode align on the card (the
    # affine default goes through the Gotoh fill).
    win_prots = [proteins[i][best_f[i]] for i in range(b)]
    alns = cuda_align.align_batch(
        encode_custom(win_prots, PROTEIN_ALPHABET), panel_codes[idx], params,
        Algorithm(algorithm), TieBreak.DIAG_UP_LEFT, device=device,
        read_texts=win_prots,
        ref_texts=[panel_texts[j] for j in idx] if panel_texts is not None else None)
    dna_start = np.zeros(b, dtype=np.int32)
    dna_end = np.zeros(b, dtype=np.int32)
    strand = np.empty(b, dtype="U1")
    dna_cigar = []
    for i, a in enumerate(alns):
        # Alignment.read_end is exclusive; the DNA mapper wants the
        # inclusive last aligned protein position.
        ds, de, st = map_protein_to_dna(int(hits.frame[i]), read_lens[i], a.read_start,
                                        max(a.read_end - 1, a.read_start))
        dna_start[i], dna_end[i], strand[i] = ds, de, st
        dna_cigar.append(_scale_cigar_dna(a.cigar))
    hits.alignments = alns
    hits.dna_start = dna_start
    hits.dna_end = dna_end
    hits.strand = strand
    hits.dna_cigar = dna_cigar
    return hits


def calibrate_translated(panel, params: AlignmentParameters | None = None,
                         read_len: int = 300, samples: int = 256, seed: int = 0,
                         device: torch.device | str = "cuda"):
    """Gumbel calibration for translated-search scores: E-values for
    :func:`translated_search` hits.

    Runs random uniform-ACGT reads of ``read_len`` through the same
    six-frame pipeline against the panel and fits the extreme-value law to
    the per-(read, entry) best-over-frames scores. Effective search space
    per comparison: ``read_len//3`` query residues x the median panel entry
    length.
    """
    params = TRANSLATED_PARAMETERS if params is None else params
    if isinstance(panel, np.ndarray) and panel.ndim == 2:
        panel_codes = panel.astype(np.uint8)
    else:
        panel_codes = encode_custom(list(panel), PROTEIN_ALPHABET)
    rng = np.random.default_rng(seed)
    reads = rng.integers(1, 5, size=(samples, read_len)).astype(np.uint8)
    th = translated_search(reads, panel_codes, params, device=device)
    null = th.scores.max(axis=1).reshape(-1)
    n_eff = int(np.median((panel_codes != 0).sum(axis=1))) or 1
    return calibrate_scores(null, max(read_len // 3, 1), n_eff, samples=null.size)
