"""The share of the cells the one-vs-many path computed (the program's
counter ``cells.search``: B x R x m x n of every score block, on the padded
shapes) that the window's inputs need (``b4_cells``: read x pool row
length, trailing padding excluded; vbench/roofline.py): what padding every
row of a score block to its longest costs B4."""

from vbench import program


def read(run):
    if run.trace is None or not run.units.get("b4_cells"):
        return None
    computed = program.counter("cells.search")
    if not computed:
        return None
    return 100.0 * run.units["b4_cells"] / computed
