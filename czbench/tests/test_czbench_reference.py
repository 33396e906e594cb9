"""The plain references against the program's own CPU solve (its plain
twins) at 16^3, from the benchmark's seeded starts: the same stopping
iteration, the residual histories and the fields within rounding.  This
ties the references to the program's semantics; on the card, the check of
each run ties the kernels to the references."""

import pytest
import torch

from czb import check, spec
from czb.inputs import Inputs
from czb.program import Program

CASES = (("sor2sma-124", 16, 1e-3, 1e-5), ("sor2sma-124", 17, 1e-3, 1e-5),
         ("pbicgstab_sor2sma-256-f64", 16, 1e-9, 1e-12),
         ("pbicgstab_sor2sma-256-f64", 17, 1e-9, 1e-12))


@pytest.mark.parametrize("workload,n,hist_tol,field_tol", CASES)
@pytest.mark.parametrize("seed", (1, -(2 ** 40) - 3))
def test_reference_matches_program_on_cpu(workload, n, hist_tol, field_tol,
                                          seed):
    torch.set_num_threads(1)
    cell = spec.load(workload)
    cfg = cell.config
    inputs = Inputs(n, getattr(torch, cfg["dtype"]), "cpu", seed)
    prog = Program(cfg, n, "cpu")
    for index in (0, 5):
        x0 = inputs.start(index)
        r = prog.solve(x0, inputs.rhs)
        assert r.res < cfg["eps"]
        g = check.gaps(r.iters, r.history, r.x,
                       check.reference_solve(cfg, x0, inputs.rhs))
        assert g["iters_gap"] == 0
        assert g["hist_gap"] < hist_tol
        assert g["field_gap"] < field_tol


def test_start_is_seeded_and_keeps_the_boundary():
    a = Inputs(12, torch.float32, "cpu", 2 ** 33 + 1)
    x, y = a.start(3), a.start(3)
    assert torch.equal(x, y)
    assert not torch.equal(x, a.start(4))
    assert not torch.equal(x, Inputs(12, torch.float32, "cpu", 2).start(3))
    inner = x[1:-1, 1:-1, 1:-1]
    assert float(inner.min()) >= 0.0 and float(inner.max()) < 1.0
    shell = x.clone()
    shell[1:-1, 1:-1, 1:-1] = 0
    assert torch.equal(shell, a.bc)
    assert torch.equal(a.rhs[1:-1, 1:-1, 1:-1], torch.zeros_like(inner))
