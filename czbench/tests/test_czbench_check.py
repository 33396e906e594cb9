"""The check that decides ``correct`` has to fail what is wrong.

The faults a cell can have, planted in the program under a whole run on
the CPU (the look for a card skipped, the grid at 16^3): a step that
returns its state unchanged, a step that leaves half of its field out, and
an answer altered where it is produced.  Each makes ``correct`` false,
where the unbroken program at the same size passes.  (The cells run on one
chip: there is no exchange between chips to leave out.)

The control, the plain reference one precision lower than the
configuration states in the program's place, fails the cell's limits too:
at 16^3 here, and at the cell's own size on a card (marked ``cuda``).
"""

import dataclasses

import pytest
import torch

import control
from czb import cell as cell_mod
from czb import check, spec
from cubez_tpu_torch.solvers import api, bicgstab

CELLS = ("sor2sma-124", "pbicgstab_sor2sma-256-f64", "sor2sma-512")
N = 16
SEED = 2 ** 32 + 7


def _route_fault(kind):
    """relaxation_route with its step broken by ``kind``."""
    route = api.relaxation_route

    def broken_route(*a, **k):
        step, pre, post = route(*a, **k)

        def broken(x, b):
            keep = x.clone()
            y, r2 = step(x, b)
            if kind == "unchanged":
                return keep, r2
            flat = y.view(-1)
            flat[: flat.numel() // 2] = keep.view(-1)[: flat.numel() // 2]
            return y, r2

        for attr in ("iters_per_call", "check_every_default", "pad", "unpad"):
            if hasattr(step, attr):
                setattr(broken, attr, getattr(step, attr))
        broken.single = broken
        return broken, pre, post

    return broken_route


def _altered_solve(*a, **k):
    r = _solve(*a, **k)
    x = r.x.clone()
    x[N // 2, N // 2, N // 2] += 0.01
    return dataclasses.replace(r, x=x)


_solve = api.solve


def _run(workload, monkeypatch, fault):
    cell = spec.load(workload)
    # a fault that never converges runs to itr_max: keep it short here
    cell.config = dict(cell.config, itr_max=min(cell.config["itr_max"], 400))
    if fault in ("unchanged", "half"):
        monkeypatch.setattr(api, "relaxation_route", _route_fault(fault))
        monkeypatch.setattr(bicgstab, "relaxation_route", _route_fault(fault))
    elif fault == "altered":
        monkeypatch.setattr(api, "solve", _altered_solve)
    return cell_mod.run_cell(cell, SEED, 0.2, False, device="cpu", n=N)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", (None, "unchanged", "half", "altered"))
def test_fault_makes_correct_false(workload, fault, monkeypatch):
    torch.set_num_threads(1)
    out = _run(workload, monkeypatch, fault)
    assert out["correct"] is (fault is None), out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits(workload):
    torch.set_num_threads(1)
    cell = spec.load(workload)
    for seed in (1, 2, 3):
        ok, checks = check.judge(
            check.worst(control.control_readings(cell, seed, "cpu", n=N)),
            cell.check["limits"])
        assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits_at_cell_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = spec.load(workload)
    ok, checks = check.judge(
        check.worst(control.control_readings(cell, 11, "cuda")),
        cell.check["limits"])
    assert not ok, checks
