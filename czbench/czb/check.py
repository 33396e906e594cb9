"""What decides ``correct``: the sampled solves of the window against the
plain reference, run once the window has closed on the same starts.

Each sampled solve gives these numbers, and a run's number is the largest
over its sample:

* ``iters_gap``: |program's stopping iteration - reference's|;
* ``hist_gap``: the largest relative gap between the two residual
  histories over the iterations both ran, and ``hist_head_gap`` the same
  over the first ``HEAD`` iterations;
* ``field_gap``: the largest gap between the two returned fields, over the
  reference field's largest magnitude;
* ``true_res``, where the reference has a ``residual``: the true residual
  of the program's field, which the solve's stopping test bounds by eps.

A cell compares the numbers its workloads/<cell>.json gives a limit, each
set from the program's readings and from the control's (the reference in
the next lower precision in the program's place): PERF.md gives both.
BiCGSTAB amplifies rounding about tenfold every three or four iterations,
so its late residuals, its stopping iteration and its field (which eps
pins down only to about eps over the operator's least eigenvalue) differ
between two sound implementations; its cell compares the head of the
history and the true residual.  Every number is printed for every sampled
solve.
"""

from __future__ import annotations

from . import spec
from .inputs import DTYPES

HEAD = 8


def gaps(iters, hist, x, ref) -> dict:
    """The gaps of one solve against ``ref`` = (iters, history, field) of
    the reference."""
    r_iters, r_hist, r_x = ref
    m = min(len(hist), len(r_hist))
    rel = ((hist[:m].double().cpu() - r_hist[:m].double().cpu()).abs()
           / r_hist[:m].double().cpu().abs())
    # histories that share no iteration while one is longer are apart
    apart = 0.0 if len(hist) == len(r_hist) else float("inf")
    xd = x.to(r_x.dtype) - r_x
    return {"iters_gap": abs(int(iters) - int(r_iters)),
            "hist_gap": float(rel.max()) if m else apart,
            "hist_head_gap": float(rel[:HEAD].max()) if m else apart,
            "field_gap": float(xd.abs().max()) / float(r_x.abs().max())}


def reference_solve(config: dict, x0, rhs, dtype=None):
    """The configuration's plain reference from ``x0`` and ``rhs``, in the
    configuration's type or ``dtype`` (the control)."""
    ref = spec.reference(config["reference"])
    dt = DTYPES[dtype or config["dtype"]]
    return ref.solve(x0.to(dt), rhs.to(dt), omega=config["omega"],
                     itr_max=config["itr_max"], eps=config["eps"],
                     precond=config.get("precond"))


def readings(config: dict, iters, hist, x, rhs, ref) -> dict:
    """The numbers of one solve against ``ref``, the reference's (iters,
    history, field) from the same start."""
    out = gaps(iters, hist, x, ref)
    residual = getattr(spec.reference(config["reference"]), "residual", None)
    if residual is not None:
        out["true_res"] = residual(x, rhs)
    return out


def worst(readings: list) -> dict:
    """The largest of each number over a sample's readings."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers ``limits``
    names; NaN fails."""
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def check_sample(config: dict, inputs, sample: list, limits: dict):
    """Run the reference over each sampled (index, result) and judge.
    Returns (correct, checks, readings)."""
    found = []
    for index, r in sample:
        ref = reference_solve(config, inputs.start(index), inputs.rhs)
        found.append(readings(config, r.iters, r.history, r.x, inputs.rhs,
                              ref))
        del ref
    if not found:
        return False, {}, found
    ok, checks = judge(worst(found), limits)
    return ok, checks, found
