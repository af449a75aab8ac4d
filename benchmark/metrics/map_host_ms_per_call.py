"""Host milliseconds a call in the program's spans ``refmap.rank`` (the
strand choice, the distinct-locus second best, MAPQ) and ``refmap.shift``
(the alignments' window coordinates shifted to the reference's)."""

from vbench import program


def read(run):
    return program.span_ms_per_call(run, {"refmap.rank", "refmap.shift"})
