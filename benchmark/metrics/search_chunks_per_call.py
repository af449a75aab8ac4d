"""Panel chunks a call that ``search._stream_best`` folds into its running
top-2 (the program's counter ``search.chunks``), both strands together:
each is one launch of the one-vs-many kernel B4 and one host merge."""

from vbench import program


def read(run):
    if run.trace is None or not run.units.get("calls"):
        return None
    chunks = program.counter("search.chunks")
    if not chunks:
        return None
    return chunks / run.units["calls"]
