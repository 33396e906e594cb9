"""sync_idle_pct: the device's idle across the program's host syncs (the
CUDA event pairs of perf/spans.py: the end of the work queued before each
wait to the first span entered after it), summed over the traced solves,
over their summed wall times, in %."""

from czb.spans import traced


def read(facts):
    recs = traced(facts)
    if recs is None or any(r.sync_idle_s is None for r in recs):
        return None
    wall = sum(s.seconds for s in facts["traced"])
    return 100.0 * sum(r.sync_idle_s for r in recs) / wall
