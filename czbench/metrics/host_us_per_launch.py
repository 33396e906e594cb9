"""host_us_per_launch: the host's own time in the step calls (the self time
of the ``steps.labeled`` spans, perf/spans.py), summed over the traced
solves, over the kernel launches the wrappers counted in them, in us."""

from czb.spans import traced


def read(facts):
    recs = traced(facts)
    if recs is None:
        return None
    launches = sum(r.launches for r in recs)
    if not launches:
        return None
    return 1e-3 * sum(r.spans[n].self_ns for r in recs for n in r.steps) / launches
