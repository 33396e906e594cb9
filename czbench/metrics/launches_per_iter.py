"""launches_per_iter: the device's kernel, copy and set records in the
traced window, over the iterations its solves ran."""


def read(facts):
    tr, traced = facts["trace"], facts["traced"]
    iters = sum(s.iters for s in traced)
    if tr is None or not tr["records"] or iters == 0:
        return None
    return tr["records"] / iters
