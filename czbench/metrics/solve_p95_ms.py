"""solve_p95_ms: the 95th percentile of the wall times of the window's
untraced solves, each from the call to the device's synchronize, in ms.
End to end, it is read in untraced runs, where that is every solve."""

import statistics


def read(facts):
    t = [1e3 * s.seconds for s in facts["solves"][len(facts["traced"]):]]
    if not t:
        return None
    if len(t) < 2:
        return t[0]
    return statistics.quantiles(t, n=100, method="inclusive")[94]
