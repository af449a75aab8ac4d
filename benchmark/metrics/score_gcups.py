"""Billions of DP cells a second over the window: the padded shape of
every call or chunk completed (pairs x m x n, as the reference program's
harness counts) over the window's seconds."""


def read(run):
    if not run.units.get("padded_cells"):
        return None
    return run.units["padded_cells"] / run.window_s / 1e9
