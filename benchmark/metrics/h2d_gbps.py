"""Gigabytes a second of the window's host-to-device copies: the bytes the
program counts as copied to the card (counter ``h2d_bytes``) over the
device seconds of the trace's host-to-device copies in the window."""

from vbench import program


def read(run):
    if run.trace is None or not run.units.get("calls"):
        return None
    nbytes = program.counter("h2d_bytes")
    seconds = sum(t - s for s, t, name, cat in run.trace.device
                  if cat == "gpu_memcpy" and "HtoD" in name) / 1e6
    if not nbytes or seconds <= 0:
        return None
    return nbytes / seconds / 1e9
