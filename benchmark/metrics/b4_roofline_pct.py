"""The one-vs-many kernel B4's (csrc/search.cu) share of its roofline: the
least time the cells the window's inputs need could take, both strands,
no coordinates (vbench/roofline.py), over B4's device time in the traced
window."""

from vbench import roofline


def read(run):
    if run.trace is None or not run.units.get("b4_cells"):
        return None
    scoring = run.config["scoring"]
    affine = bool(scoring.get("gap_open_read") or scoring.get("gap_open_ref"))
    ops = run.units["b4_cells"] * roofline.ops_per_cell(
        "search", affine, True, run.config["algorithm"] == "smith_waterman")
    return roofline.share_pct(ops, run.units["b4_bytes"], run.trace.seconds("search.cu"))
