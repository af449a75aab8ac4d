"""The share of the cells the score path computed (the program's counter
``cells.score``: B x m x n of every batch scored) that the window's inputs
need (read x ref length, trailing padding excluded; vbench/roofline.py)."""

from vbench import program


def read(run):
    if run.trace is None or not run.units.get("b1_cells"):
        return None
    computed = program.counter("cells.score")
    if not computed:
        return None
    return 100.0 * run.units["b1_cells"] / computed
