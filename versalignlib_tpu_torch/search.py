"""Database search: score every read against a reference panel, align hits.

The port of ``versalignlib_tpu/search.py``. The reference's API is strictly pairwise
1:1 (AlignmentKernel.h:34-44); the classic production use of a pairwise
aligner is one-vs-many: map each read against a panel of references, keep
the best hit(s), and trace back only the winners (filter-then-align).

On the card the cross product never materialises: the one-vs-many kernel
(``csrc/search.cu`` through ``ops/cuda_search.py``) holds the B reads and
the R panel entries, and writes the (B, R) scores. The panel streams
through in chunks bounded by ``max_pairs``; each chunk's top-2 is taken on
the card with a stable order (equal scores keep the lower panel index, as
``lax.top_k`` does), and the running best folds on the host between chunks.
Alignment happens once per read, on the winning pair only, through the
port's backend (``csrc/align.cu`` or ``csrc/align_affine.cu``).

Entry points run on the card (``device="cuda"``, raising without one);
``device="cpu"`` runs the plain PyTorch path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from versalignlib_tpu_torch.alphabet import pad_and_encode, reverse_complement_codes
from versalignlib_tpu_torch.dispatch import _resolve_placement, get_backend
from versalignlib_tpu_torch.ops import cuda_search
from versalignlib_tpu_torch.parallel.distributed import (distributed_align_batch, gather,
                                                         on_device, put, put_shards,
                                                         shard_rows)
from versalignlib_tpu_torch.parallel.mesh import Mesh
from versalignlib_tpu_torch.params import DEFAULT_PARAMETERS, AlignmentParameters
from versalignlib_tpu_torch.types import Algorithm, Alignment, TieBreak
from versalignlib_tpu_torch.utils.capabilities import check_search_budget
from versalignlib_tpu_torch.utils.profiling import annotate

NEG32 = np.iinfo(np.int32).min


def unmapped_alignment() -> Alignment:
    """Placeholder for a read with no candidate (empty panel): empty gapped
    strings and sentinel coordinates. Keeps ``align=True`` results
    index-aligned with the per-read hit arrays whatever the panel size."""
    return Alignment(read="", ref="", score=0, cigar="",
                     read_start=-1, read_end=-1, ref_start=-1, ref_end=-1)


def _encode(seqs) -> np.ndarray:
    if isinstance(seqs, np.ndarray) and seqs.dtype == np.uint8 and seqs.ndim == 2:
        return seqs
    return pad_and_encode(seqs)


def _topk(s: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable top-k of each row of (B, Rc) scores, on their device: (values
    (B, k) int32, indices (B, k) int64), by descending score and, among
    equal scores, ascending index. ``torch.topk`` promises no order among
    equal values, so it ranks the total key ``score * (Rc + 1) - index``."""
    rc = s.shape[1]
    key = s.to(torch.int64) * (rc + 1) - torch.arange(rc, device=s.device)
    idx = torch.topk(key, k, dim=1).indices
    return torch.gather(s, 1, idx), idx


class _Reads:
    """A batch of read codes staged once for every panel chunk of a search,
    over the devices of ``mesh``, or of a one-device mesh of ``device``:
    with ``panel_axis`` "reads" each device holds its row shard of the reads
    and gets the whole chunk, with "panel" each device holds all the reads
    and gets its shard of the chunk. Every shard's scores come from the
    one-vs-many kernel (``cuda_search.cross_scores_device``) on its device,
    all launched before any result is waited for; the trailing copy to the
    host is the only communication."""

    def __init__(self, reads_enc: np.ndarray, params, algorithm, device: torch.device,
                 mesh=None, panel_axis: str = "reads"):
        if panel_axis not in ("reads", "panel"):
            raise ValueError(f"panel_axis must be 'reads' or 'panel', got {panel_axis!r}")
        self.b = reads_enc.shape[0]
        self.params, self.algorithm = params, algorithm
        self.mesh = mesh if mesh is not None else Mesh((device,))
        self.panel_sharded = panel_axis == "panel"
        with annotate("search.stage"):
            if self.panel_sharded:
                self.shards = self._replicas(reads_enc)
            else:
                self.shards = put_shards(reads_enc, self.mesh)

    def _replicas(self, x: np.ndarray) -> list[torch.Tensor]:
        """``x`` on every device of the mesh, copied once a distinct device."""
        copies = {dev: put(x, dev) for dev in dict.fromkeys(self.mesh.devices)}
        return [copies[dev] for dev in self.mesh.devices]

    def _cross(self, pc: np.ndarray, min_per: int = 1) -> list[torch.Tensor]:
        """Every shard's (B_d, Rc_d) int32 scores against the chunk ``pc`` on
        its device; a sharded chunk is padded to ``min_per`` rows a shard."""
        if self.panel_sharded:
            pools = [put(x, dev) for x, dev in zip(shard_rows(pc, self.mesh.size, min_per),
                                                   self.mesh.devices)]
        else:
            pools = self._replicas(pc)
        out = []
        for r, pool, dev in zip(self.shards, pools, self.mesh.devices):
            with on_device(dev):
                out.append(cuda_search.cross_scores_device(r, pool, self.params,
                                                           self.algorithm))
        return out

    def scores(self, pc: np.ndarray) -> np.ndarray:
        """The (B, Rc) int32 score block of the chunk ``pc``, on the host."""
        with annotate("search.scores"):
            parts = self._cross(pc)
            if self.panel_sharded:
                return gather(parts, dim=1)[:, :pc.shape[0]]
            return gather(parts)[:self.b]

    def topk(self, pc: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Top ``k`` (<= Rc) of the chunk ``pc`` for each read, on the host:
        (values (B, k) int64 descending, chunk-local indices (B, k) int64),
        equal scores in ascending index. Each shard takes its top-k on its
        device (:func:`_topk`); a sharded panel's candidates carry
        their chunk-wide index, the pad rows are dropped and the shards'
        pools merge by (-score, index) on the host."""
        with annotate("search.scores"):
            if not self.panel_sharded:
                tops = [_topk(s, k) for s in self._cross(pc)]
                return (gather([v for v, _ in tops])[:self.b].astype(np.int64),
                        gather([i for _, i in tops])[:self.b])
            rc = pc.shape[0]
            parts = self._cross(pc, min_per=k)
            per = parts[0].shape[1]
            tops = [_topk(s, k) for s in parts]
            v = gather([v for v, _ in tops], dim=1).astype(np.int64)
            i = gather([i + d * per for d, (_, i) in enumerate(tops)], dim=1)
        with annotate("search.merge"):
            v = np.where(i < rc, v, np.int64(NEG32))
            order = np.lexsort((i, -v), axis=1)[:, :k]
            return np.take_along_axis(v, order, axis=1), np.take_along_axis(i, order, axis=1)


def _stream_best(reads_enc, panel_enc, params, algorithm, device, chunk, mesh=None,
                 panel_axis: str = "reads"):
    """Running top-2 fold over panel chunks.

    Returns (arg (B,), best (B,), second (B,)): the best entry's index and
    score plus the second-best score over different panel entries (int32
    min when the panel has a single entry), the input to the MAPQ gap.
    """
    b = reads_enc.shape[0]
    r = panel_enc.shape[0]
    reads = _Reads(reads_enc, params, algorithm, device, mesh, panel_axis)
    best = np.full(b, NEG32, dtype=np.int32)
    second = np.full(b, NEG32, dtype=np.int32)
    arg = np.zeros(b, dtype=np.int32)
    for lo in range(0, r, chunk):
        pc = panel_enc[lo:lo + chunk]
        kk = min(2, pc.shape[0])
        v, i = reads.topk(pc, kk)
        with annotate("search.merge"):
            c_arg = i[:, 0]
            c_best = v[:, 0].astype(np.int32)
            c_second = v[:, 1] if kk >= 2 else np.full(b, NEG32, np.int64)
            upd = c_best > best                    # strict >: earlier chunk wins ties
            # Top-2 merge of two disjoint candidate pools (exact).
            second = np.maximum(np.minimum(best.astype(np.int64), c_best),
                                np.maximum(second.astype(np.int64), c_second)
                                ).astype(np.int32)
            best = np.where(upd, c_best, best)
            arg = np.where(upd, lo + c_arg, arg).astype(np.int32)
    return arg, best, second


def _check_budget(m: int, n: int, pairs: int, affine: bool, device: torch.device,
                  mesh) -> None:
    """``check_search_budget`` of a launch of ``pairs`` on ``device``, or on
    every device of ``mesh`` (each checked for the whole chunk)."""
    with annotate("search.budget"):
        for dev in (dict.fromkeys(mesh.devices) if mesh is not None else (device,)):
            check_search_budget(m, n, pairs, affine, dev)


def _chunk_for(b: int, r: int, max_pairs: int) -> int:
    return max(1, min(r, max_pairs // max(b, 1)))


def score_matrix(
    reads,
    panel,
    params: AlignmentParameters = DEFAULT_PARAMETERS,
    algorithm: Algorithm = Algorithm.SMITH_WATERMAN,
    device: torch.device | str = "cuda",
    max_pairs: int = 1 << 20,
    mesh=None,
    panel_axis: str = "reads",
) -> np.ndarray:
    """All-vs-all scores: (B,) reads x (R,) panel -> (B, R) int32.

    ``max_pairs`` bounds the pairs of one launch (the panel streams through
    in ``ceil(B*R / max_pairs)`` chunks). ``mesh``: a
    :class:`~versalignlib_tpu_torch.parallel.mesh.Mesh` to run on in place
    of ``device``; ``panel_axis`` picks the side that shards over it:
    ``"reads"`` (default) shards the reads and replicates each panel chunk,
    ``"panel"`` shards each panel chunk and replicates the reads, for when
    the many side dominates memory (genome window sets). Neither mode
    communicates between devices; the result gather is the only copy.
    """
    reads_enc = _encode(reads)
    panel_enc = _encode(panel)
    b = reads_enc.shape[0]
    r = panel_enc.shape[0]
    device = _resolve_placement(device, mesh)
    if b == 0 or r == 0:
        return np.zeros((b, r), dtype=np.int32)
    algorithm = Algorithm(algorithm)
    chunk = _chunk_for(b, r, max_pairs)
    _check_budget(reads_enc.shape[1], panel_enc.shape[1], b * chunk, params.affine,
                  device, mesh)
    staged = _Reads(reads_enc, params, algorithm, device, mesh, panel_axis)
    out = np.empty((b, r), dtype=np.int32)
    for lo in range(0, r, chunk):
        pc = panel_enc[lo:lo + chunk]
        out[:, lo:lo + pc.shape[0]] = staged.scores(pc)
    return out


def _align_pairs(reads_enc, refs_enc, params, algorithm, tie, backend, device, mesh=None):
    """Each read against its chosen ref: through ``backend`` on ``device``,
    or with a mesh sharded over it (``distributed_align_batch``)."""
    if mesh is not None:
        return distributed_align_batch(reads_enc, refs_enc, params, algorithm, tie,
                                       mesh=mesh)
    return get_backend(backend, device).compute_alignments(
        algorithm, reads_enc, refs_enc, params, tie)


def best_hits(
    reads,
    panel,
    params: AlignmentParameters = DEFAULT_PARAMETERS,
    algorithm: Algorithm = Algorithm.SMITH_WATERMAN,
    device: torch.device | str = "cuda",
    max_pairs: int = 1 << 20,
    align: bool = True,
    backend: str = "auto",
    tie: TieBreak = TieBreak.DIAG_UP_LEFT,
    mesh=None,
    panel_axis: str = "reads",
) -> tuple[np.ndarray, np.ndarray, list[Alignment] | None]:
    """Best panel hit per read: (hit_index (B,), score (B,), alignments).

    Ties resolve to the lowest panel index (scan order, the reference
    kernels' first-win argmax convention). ``align=True`` runs the full
    traceback only on each read's winning pair. An empty panel yields hit
    index -1 and int32-min scores. ``mesh`` and ``panel_axis`` as in
    :func:`score_matrix`; ``panel_axis="panel"`` takes each device's top-k
    on the device and merges the shards' pools on the host.
    """
    reads_enc = _encode(reads)
    panel_enc = _encode(panel)
    b = reads_enc.shape[0]
    r = panel_enc.shape[0]
    device = _resolve_placement(device, mesh)
    if b == 0 or r == 0:
        return (np.full(b, -1, np.int32), np.full(b, NEG32, np.int32),
                [unmapped_alignment() for _ in range(b)] if align else None)
    algorithm = Algorithm(algorithm)
    chunk = _chunk_for(b, r, max_pairs)
    _check_budget(reads_enc.shape[1], panel_enc.shape[1], b * chunk, params.affine,
                  device, mesh)
    arg, best, _ = _stream_best(reads_enc, panel_enc, params, algorithm, device, chunk,
                                mesh, panel_axis)
    if not align:
        return arg, best, None
    alns = _align_pairs(reads_enc, panel_enc[arg], params, algorithm, tie,
                        backend, device, mesh)
    return arg, best, alns


@dataclasses.dataclass
class SearchHits:
    """Per-read best-hit results from :func:`map_reads`."""

    index: np.ndarray       # (B,) best panel entry (-1 when the panel is empty)
    score: np.ndarray       # (B,) int32 DP score of the best hit
    strand: np.ndarray      # (B,) 0 = forward, 1 = reverse complement
    alignments: list[Alignment] | None  # best-pair tracebacks (align=True)
    #: (B,) uint8 mapping-quality heuristic from the best-vs-second-best
    #: score gap: min(60, 6*gap/match_unit); 0 on exact ties, 60 when the
    #: panel offers no second candidate.
    mapq: np.ndarray = None

    def __len__(self) -> int:
        return self.index.shape[0]


def _mapq_from_gap(best, second, params) -> np.ndarray:
    unit = (params.score_match if params.matrix is None
            else max(max(r) for r in params.matrix))
    unit = max(int(unit), 1)
    gap = np.maximum(best.astype(np.int64) - second.astype(np.int64), 0)
    q = np.minimum(60, (6 * gap) // unit)
    return np.where(second == NEG32, 60, q).astype(np.uint8)


@dataclasses.dataclass
class PairedHits:
    """Per-fragment best-hit results from :func:`map_read_pairs`."""

    index: np.ndarray       # (B,) best panel entry (-1 when the panel is empty)
    score: np.ndarray       # (B,) int64 combined pair score (mate1 + mate2)
    #: (B,) fragment orientation: 0 = FR (mate1 forward, mate2 reverse
    #: complement, the standard Illumina layout), 1 = RF (the converse).
    orient: np.ndarray
    alignments1: list[Alignment] | None  # mate-1 tracebacks (align=True)
    alignments2: list[Alignment] | None
    mapq: np.ndarray = None  # (B,) pair-level MAPQ heuristic (see map_reads)

    @property
    def strand1(self) -> np.ndarray:
        """(B,) mate-1 strand: reverse iff the fragment mapped RF."""
        return (self.orient == 1).astype(np.int8)

    @property
    def strand2(self) -> np.ndarray:
        """(B,) mate-2 strand: reverse iff the fragment mapped FR."""
        return (self.orient == 0).astype(np.int8)

    def __len__(self) -> int:
        return self.index.shape[0]


def map_read_pairs(
    reads1,
    reads2,
    panel,
    params: AlignmentParameters = DEFAULT_PARAMETERS,
    algorithm: Algorithm = Algorithm.SMITH_WATERMAN,
    device: torch.device | str = "cuda",
    max_pairs: int = 1 << 20,
    align: bool = True,
    backend: str = "auto",
    tie: TieBreak = TieBreak.DIAG_UP_LEFT,
    mesh=None,
) -> PairedHits:
    """Paired-end mapping: best panel entry for each (mate1, mate2) pair.

    Both layouts are scored, FR (mate1 forward + mate2 reverse complement)
    and RF, and per panel entry the better layout's combined score competes
    in the argmax. FR wins layout ties; earlier panel entries win score ties.
    MAPQ comes from the combined-score gap to the second-best panel entry.
    DNA only (needs the complement), like ``map_reads(both_strands=True)``.
    ``mesh``: shard each mate batch over its devices (the reads axis of
    :func:`score_matrix`).
    """
    if params.matrix is not None:
        raise ValueError("paired-end mapping is DNA-only (custom "
                         "substitution matrices have no complement)")
    f1_enc = _encode(reads1)
    f2_enc = _encode(reads2)
    if f1_enc.shape[0] != f2_enc.shape[0]:
        raise ValueError(f"mate counts differ: {f1_enc.shape[0]} vs {f2_enc.shape[0]}")
    panel_enc = _encode(panel)
    b = f1_enc.shape[0]
    r = panel_enc.shape[0]
    device = _resolve_placement(device, mesh)
    if b == 0 or r == 0:
        def empty():
            return [unmapped_alignment() for _ in range(b)] if align else None

        return PairedHits(np.full(b, -1, np.int32),
                          np.full(b, np.iinfo(np.int64).min, np.int64),
                          np.zeros(b, np.int8), empty(), empty(),
                          np.zeros(b, np.uint8))
    algorithm = Algorithm(algorithm)
    r1_enc = reverse_complement_codes(f1_enc)
    r2_enc = reverse_complement_codes(f2_enc)
    # Four oriented mate batches stream the panel together; halve the chunk
    # so the device batch stays within max_pairs across the two mates.
    chunk = max(1, min(r, max_pairs // (2 * max(b, 1))))
    _check_budget(max(f1_enc.shape[1], f2_enc.shape[1]), panel_enc.shape[1], b * chunk,
                  params.affine, device, mesh)
    mates = tuple(_Reads(x, params, algorithm, device, mesh)
                  for x in (f1_enc, r1_enc, f2_enc, r2_enc))
    NEG = np.int64(np.iinfo(np.int64).min // 4)  # safe against adds
    best = np.full(b, NEG, dtype=np.int64)
    second = np.full(b, NEG, dtype=np.int64)
    arg = np.zeros(b, dtype=np.int32)
    orient = np.zeros(b, dtype=np.int8)
    rows = np.arange(b)
    for lo in range(0, r, chunk):
        pc = panel_enc[lo:lo + chunk]
        s_f1, s_r1, s_f2, s_r2 = (mate.scores(pc).astype(np.int64) for mate in mates)
        with annotate("search.merge"):
            fr = s_f1 + s_r2
            rf = s_r1 + s_f2
            c_comb = np.maximum(fr, rf)
            c_orient = rf > fr                     # FR wins layout ties
            c_arg = np.argmax(c_comb, axis=1)      # first-win within the chunk
            c_best = c_comb[rows, c_arg]
            c_second = (np.partition(c_comb, -2, axis=1)[:, -2]
                        if c_comb.shape[1] >= 2 else np.full(b, NEG))
            upd = c_best > best                    # strict >: earlier chunk wins ties
            second = np.maximum(np.minimum(best, c_best), np.maximum(second, c_second))
            best = np.where(upd, c_best, best)
            arg = np.where(upd, lo + c_arg, arg).astype(np.int32)
            orient = np.where(upd, c_orient[rows, c_arg], orient).astype(np.int8)
    mapq = _mapq_from_gap(best, np.where(second == NEG, NEG32, second), params)
    alns1 = alns2 = None
    if align:
        rev = orient.astype(bool)
        oriented1 = np.where(rev[:, None], r1_enc, f1_enc)
        oriented2 = np.where(rev[:, None], f2_enc, r2_enc)
        refs_sel = panel_enc[arg]
        alns1 = _align_pairs(oriented1, refs_sel, params, algorithm, tie, backend, device,
                             mesh)
        alns2 = _align_pairs(oriented2, refs_sel, params, algorithm, tie, backend, device,
                             mesh)
    return PairedHits(arg, best, orient, alns1, alns2, mapq)


def map_reads(
    reads,
    panel,
    params: AlignmentParameters = DEFAULT_PARAMETERS,
    algorithm: Algorithm = Algorithm.SMITH_WATERMAN,
    device: torch.device | str = "cuda",
    max_pairs: int = 1 << 20,
    align: bool = True,
    backend: str = "auto",
    tie: TieBreak = TieBreak.DIAG_UP_LEFT,
    mesh=None,
    both_strands: bool = True,
    panel_axis: str = "reads",
) -> SearchHits:
    """Strand-aware read mapping: best panel hit over both orientations.

    The read and its padding-aware reverse complement are scored (DNA
    only); the forward strand wins score ties. ``align=True`` traces back
    each read's winning (orientation, panel entry) pair only; reverse-strand
    alignments are in reverse-complement read coordinates (the SAM
    convention). ``mesh`` and ``panel_axis`` as in :func:`best_hits`.
    """
    with annotate("search.map_reads"):
        if params.matrix is not None and both_strands:
            raise ValueError("both_strands mapping is DNA-only (custom "
                             "substitution matrices have no complement)")
        reads_enc = _encode(reads)
        panel_enc = _encode(panel)
        b = reads_enc.shape[0]
        r = panel_enc.shape[0]
        device = _resolve_placement(device, mesh)
        if b == 0 or r == 0:
            return SearchHits(np.full(b, -1, np.int32), np.full(b, NEG32, np.int32),
                              np.zeros(b, np.int8),
                              [unmapped_alignment() for _ in range(b)] if align else None,
                              np.zeros(b, np.uint8))
        algorithm = Algorithm(algorithm)
        chunk = _chunk_for(b, r, max_pairs)
        _check_budget(reads_enc.shape[1], panel_enc.shape[1], b * chunk, params.affine,
                      device, mesh)
        arg, best, second = _stream_best(reads_enc, panel_enc, params, algorithm,
                                         device, chunk, mesh, panel_axis)
        strand = np.zeros(b, dtype=np.int8)
        if both_strands:
            rc_enc = reverse_complement_codes(reads_enc)
            rc_arg, rc_best, rc_second = _stream_best(rc_enc, panel_enc, params,
                                                      algorithm, device, chunk, mesh,
                                                      panel_axis)
            rev = rc_best > best            # strict >: forward wins ties
            # Top-2 merge across the two orientations' candidate pools.
            second = np.maximum(np.minimum(best.astype(np.int64), rc_best),
                                np.maximum(second.astype(np.int64), rc_second)
                                ).astype(np.int32)
            arg = np.where(rev, rc_arg, arg).astype(np.int32)
            best = np.where(rev, rc_best, best)
            strand = rev.astype(np.int8)
            oriented = np.where(rev[:, None], rc_enc, reads_enc)
        else:
            oriented = reads_enc
        alns = None
        if align:
            alns = _align_pairs(oriented, panel_enc[arg], params, algorithm, tie,
                                backend, device, mesh)
        return SearchHits(arg, best, strand, alns, _mapq_from_gap(best, second, params))
