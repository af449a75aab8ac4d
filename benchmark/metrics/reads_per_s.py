"""Reads a second: the reads of every call completed in the window, mapped
or not, over the window's seconds."""


def read(run):
    if not run.units.get("reads"):
        return None
    return run.units["reads"] / run.window_s
