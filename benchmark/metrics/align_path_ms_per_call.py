"""Host milliseconds a call inside the align path, the search module's
_align_pairs (B3 fill, B8 walk, the records' copy back and their replay),
as each entry looks it up; the span waits for the card before it
closes."""

SPANS = {"align_path": [("versalignlib_tpu_torch.search", "_align_pairs", True),
                        ("versalignlib_tpu_torch.refmap", "_align_pairs", True)]}


def read(run):
    spans = run.spans.get("align_path")
    if not spans or not run.units.get("calls"):
        return None
    return 1e3 * sum(spans) / run.units["calls"]
