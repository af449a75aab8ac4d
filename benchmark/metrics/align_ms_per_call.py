"""Host milliseconds a call in the program's span ``align.batch``
(``ops/cuda_align.py::align_batch``: copies in, fill, walk, copies back,
the wait and the replay), which adds no synchronise of its own."""

from vbench import program


def read(run):
    return program.span_ms_per_call(run, {"align.batch"})
