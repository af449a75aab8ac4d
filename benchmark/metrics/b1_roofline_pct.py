"""The score kernel B1's (csrc/score.cu) share of its roofline: the least
time the cells the window's inputs need could take (vbench/roofline.py)
over B1's device time in the traced window."""

from vbench import roofline


def read(run):
    if run.trace is None or not run.units.get("b1_cells"):
        return None
    scoring = run.config["scoring"]
    affine = bool(scoring.get("gap_open_read") or scoring.get("gap_open_ref"))
    ops = run.units["b1_cells"] * roofline.ops_per_cell(
        "score", affine, "matrix" in scoring, run.config["algorithm"] == "smith_waterman")
    return roofline.share_pct(ops, run.units["b1_bytes"], run.trace.seconds("score.cu"))
