"""sweeps_per_iter: the sweeps run_iterative ran (its chunks and the
replayed singles, perf/spans.py), summed over the traced solves, over the
iterations they kept: above 1 by the work the chunking wastes."""

from czb.spans import traced


def read(facts):
    recs = traced(facts)
    if recs is None:
        return None
    sweeps, iters = sum(r.sweeps for r in recs), sum(r.iters for r in recs)
    if not sweeps or not iters:
        return None
    return sweeps / iters
