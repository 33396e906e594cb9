"""kernels_roofline: the least time the traced solves' work could take on
the card (czb/work.py: the larger of the operations over the peak rate of
the configuration's type and the bytes a solve must move over HBM), over
the device's busy time in the traced window, in %.  Nothing for a card the
table does not know or a configuration with no work model."""

from czb.work import least_seconds


def read(facts):
    tr, peaks, cfg = facts["trace"], facts["peaks"], facts["config"]
    if tr is None or peaks is None or "work" not in cfg or tr["busy_s"] <= 0:
        return None
    least = sum(least_seconds(cfg["work"], facts["n"], cfg["dtype"], s.iters,
                              peaks) for s in facts["traced"])
    return 100.0 * least / tr["busy_s"] if least > 0 else None
