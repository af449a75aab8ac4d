"""Host milliseconds a call in the native replay of the walks' records
(native.replay_records_native)."""

SPANS = {"replay": [("versalignlib_tpu_torch.native", "replay_records_native", False)]}


def read(run):
    spans = run.spans.get("replay")
    if not spans or not run.units.get("calls"):
        return None
    return 1e3 * sum(spans) / run.units["calls"]
