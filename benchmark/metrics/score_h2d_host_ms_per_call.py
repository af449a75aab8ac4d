"""Host milliseconds a call in the program's span ``score.h2d``: the two
copies of a call's codes to the card (``ops/cuda_score.py::CudaScorer``),
pageable, which the host stages and waits for."""

from vbench import program


def read(run):
    return program.span_ms_per_call(run, {"score.h2d"})
