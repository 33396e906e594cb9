"""The program's own records of the traced solves: the spans and counters
that ``cubez_tpu_torch.perf.spans`` keeps of each solve it records.

The program records a solve that starts while torch.profiler records, so
in a traced run it records the profiler's warm-up solve and then the
traced window's solves, and nothing after them.  This file imports
nothing of the program: it takes the module the program has loaded from
``sys.modules`` (czb/program.py stays the only file that imports it), and
a program without the module gives nothing.
"""

from __future__ import annotations

import sys

MODULE = "cubez_tpu_torch.perf.spans"


def traced(facts):
    """The program's records of the traced window's solves, oldest first:
    the last ``len(facts["traced"])`` it kept.  None where the program
    keeps none, where their count or their iterations, one by one, do not
    match the traced solves, or where the traced window has no device
    record (on the CPU: a wait on the host's own tensors is no device
    sync)."""
    tr, solves = facts.get("trace"), facts.get("traced")
    mod = sys.modules.get(MODULE)
    if tr is None or not tr["records"] or not solves or mod is None:
        return None
    recs = mod.solves()[-len(solves):]
    if len(recs) != len(solves):
        return None
    if any(r.iters != s.iters for r, s in zip(recs, solves)):
        return None
    return recs
