"""Host milliseconds a call in the program's span ``align.decode``: the
host replay of the walks' records (or the decode of the pointer words) and
the alignments built from it."""

from vbench import program


def read(run):
    return program.span_ms_per_call(run, {"align.decode"})
