"""A 16S panel and its V4 amplicon reads, drawn from ``--seed``, and the
plain reference of ``search.map_reads`` against such a panel.

The panel (a configuration's ``panel`` block): one random root of
``length_max`` bases; entry i is the root with substitutions at a rate
drawn uniformly in [``divergence_min``, ``divergence_max``], cut at its 3'
end to a length uniform in [``length_min``, ``length_max``] and padded
with 0; every ``v4_twin_every``-th entry (16, 32, ...) takes its
predecessor's V4 region (``reads.v4``, 0-based, end excluded) unchanged,
as V4 cannot tell many genera apart.

The reads (``reads`` block): each from a uniformly chosen entry, a forward
read ``entry[v4[0]:v4[0] + length]`` or, with ``reverse_rate``, the reverse
complement of ``entry[v4[1] - length:v4[1]]`` (R1 and R2 of a 2 x length
run, mapped singly), with ``sub_rate`` substitutions and ``n_rate`` N.

The reference imports nothing of the measured program: it works the
answers out again from the codes with :mod:`vbench.reference`.
"""

from __future__ import annotations

import zlib

import numpy as np

from vbench import gen, reference

#: The panel's stream under ``gen.REFERENCE`` (:func:`vbench.gen.rng_for`).
STREAM = zlib.crc32(b"panel")


def make_panel(rng: np.random.Generator, spec: dict, v4) -> np.ndarray:
    """(entries, length_max) uint8 codes as the ``panel`` block describes."""
    count, lo, hi = spec["entries"], spec["length_min"], spec["length_max"]
    start, end = v4
    if not 0 <= start < end <= lo <= hi:
        raise ValueError(f"V4 {list(v4)} must lie inside the shortest entry ({lo})")
    root = gen.bases(rng, hi)
    rates = rng.uniform(spec["divergence_min"], spec["divergence_max"], size=count)
    lens = rng.integers(lo, hi + 1, size=count)
    panel = np.stack([gen.mutate(rng, root, float(rate), 0.0) for rate in rates])
    every = spec["v4_twin_every"]
    for i in range(every, count, every):
        panel[i, start:end] = panel[i - 1, start:end]
    return gen.pad_tail(panel, lens)


def make_reads(rng: np.random.Generator, spec: dict, panel: np.ndarray, count: int) -> dict:
    """``count`` reads as the ``reads`` block describes, with where each
    came from (``entry``, ``reverse``)."""
    length = spec["length"]
    start, end = spec["v4"]
    if length > end - start:
        raise ValueError(f"reads of {length} do not fit V4 {list(spec['v4'])}")
    entry = rng.integers(0, panel.shape[0], size=count)
    reverse = rng.random(count) < spec["reverse_rate"]
    offset = np.where(reverse, end - length, start)
    reads = panel[entry[:, None], offset[:, None] + np.arange(length)[None, :]]
    reads = gen.mutate(rng, reads, spec["sub_rate"], spec["n_rate"])
    reads[reverse] = gen.reverse_complement(reads[reverse])
    return {"reads": reads, "entry": entry, "reverse": reverse}


def map_panel(reads: np.ndarray, panel: np.ndarray, sc: reference.Scoring, device="cpu",
              cell_bits: int = 32) -> dict:
    """``search.map_reads``' answer for ``reads`` against every entry of
    ``panel``, both strands, Smith-Waterman (its defaults otherwise). The
    rules, each with the lines of ``versalignlib_tpu_torch/search.py`` it
    mirrors:

    - each read and its reverse complement are scored against every entry
      (``map_reads``: ``_stream_best`` of ``reads_enc`` and of ``rc_enc``);
    - on a strand, the best entry is the lowest index with the best score
      (``_topk``'s stable order within a chunk, and ``upd = c_best > best``
      in ``_stream_best``: an earlier chunk wins ties);
    - the hit is the forward strand's best entry unless the reverse
      strand's best score is strictly higher (``rev = rc_best > best``);
    - ``second`` is the second largest of all 2R (strand, entry) scores
      (the top-2 merges in ``_stream_best`` and across strands in
      ``map_reads``), so an entry tied with the winner gives MAPQ 0;
    - MAPQ is ``reference.mapq(best, second, score_match)``
      (``_mapq_from_gap``);
    - the alignment is the oriented read against the winning entry's row
      as the panel holds it, padding included (``_align_pairs(oriented,
      panel_enc[arg], ...)``).

    ``cell_bits`` as in :func:`vbench.reference.cross_scores`."""
    q = reads.shape[0]
    rc = gen.reverse_complement(reads)
    both = reference.cross_scores(np.concatenate([reads, rc]), panel, sc, device, cell_bits)
    fwd, rev_s = both[:q], both[q:]
    best_f, best_r = fwd.max(1), rev_s.max(1)
    rev = best_r > best_f
    index = np.where(rev, rev_s.argmax(1), fwd.argmax(1))
    best = np.where(rev, best_r, best_f)
    second = np.partition(np.concatenate([fwd, rev_s], axis=1), -2, axis=1)[:, -2]
    oriented = np.where(rev[:, None], rc, reads)
    return {"index": index, "score": best, "strand": rev.astype(np.int64),
            "mapq": reference.mapq(best, second, sc.match),
            "alignments": [reference.align(oriented[i], panel[index[i]], sc)
                           for i in range(q)]}
