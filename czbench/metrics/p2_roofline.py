"""p2_roofline: the least time of the sweeps of kernel P2 in the traced
solves (the sweeps ``run_iterative`` ran, chunks and replay, from the
program's records, times czb/lines.py's least time a sweep) over the
device time of the trace's kernels named ``pcr_gs_`` (the lagged launch
and the one-sweep launch), in %.  Nothing for a card the table does not
know, without the program's records, or where no P2 kernel ran."""

from czb.lines import sweep_least_seconds
from czb.spans import traced

KERNEL = "pcr_gs_"


def read(facts):
    tr, peaks, cfg = facts["trace"], facts["peaks"], facts["config"]
    recs = traced(facts)
    if recs is None or peaks is None:
        return None
    busy = sum(s for name, s in tr["breakdown"]["device_ops"] if KERNEL in name)
    sweeps = sum(r.sweeps for r in recs)
    if busy <= 0 or not sweeps:
        return None
    least = sweeps * sweep_least_seconds(facts["n"], cfg["dtype"], peaks)
    return 100.0 * least / busy
