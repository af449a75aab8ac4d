"""Host milliseconds a call in the program's span ``search.merge``: the
host fold of each window chunk's top-k into the running candidates, with
the card idle until the next chunk is launched."""

from vbench import program


def read(run):
    return program.span_ms_per_call(run, {"search.merge"})
