"""syncs_per_solve: the device-to-host waits on the program's solve path
(perf/spans.py ``spans.wait``: run_iterative's chunk check and stop, the
Krylov loop's fetch, the route's checks), summed over the traced solves,
over their number."""

from czb.spans import traced


def read(facts):
    recs = traced(facts)
    if recs is None:
        return None
    return sum(r.syncs for r in recs) / len(recs)
