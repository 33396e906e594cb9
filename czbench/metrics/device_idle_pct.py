"""device_idle_pct: the share of the traced window with no kernel, copy or
set on the device (the union of their intervals), in %."""


def read(facts):
    tr = facts["trace"]
    if tr is None or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
