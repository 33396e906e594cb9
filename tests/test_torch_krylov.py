"""The port's Krylov solvers (solvers/bicgstab.py, solvers/cg.py) on the
CPU: pbicgstab against the oracle histories and against the JAX package's
jnp solve, cg against the JAX package's cg, the breakdown rule, the
preconditioner's contract (8 sweeps, a result of its own, unported names
naming their slice) and the stretched grid's h^2 band.

The preconditioner takes the port's own ``solve`` route for its name with
a streamed b (the kernel steps' twins here on the CPU; K2's pair for
sor2sma, K4 for jacobi, K5 for pcr_rb, K6 for pcr_j_esa), in float32 and
float64 and for MAF names alike.  The JAX package fuses it only for float32
non-MAF names and runs its jnp steps otherwise: the port departs from those
routes on purpose, as its ``solve`` does, so the comparisons are banded.

BiCGSTAB amplifies rounding by about 1e3-1e5 an iteration once its residual
stalls (float64 runs of the port and the JAX package agree to 1e-15 for the
first iterations and drift apart later), so float32 curves are compared
only where the preconditioner is a contraction: jacobi at its documented
omega 0.8 and pcr_j_esa at 1.0 (over-relaxed Jacobi at 1.1 diverges as a
sweep and makes the float32 trajectory chaotic).  Without a preconditioner
the curve is chaotic in either precision near its stop, and counts are
compared."""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubez_tpu import Problem as JProblem
from cubez_tpu import solve as jsolve

import cubez_tpu_torch as czt
from cubez_tpu_torch.ops import blas
from cubez_tpu_torch.solvers import bicgstab, cg, steps

torch.set_num_threads(1)

HIST = pathlib.Path(__file__).resolve().parent / "ref_histories"
TOL = {"float32": 1e-3, "float64": 1e-4}


def load(name):
    rows = (HIST / name).read_text().splitlines()[1:]
    return np.array([float(ln.split(",")[1]) for ln in rows])


def _tdt(dtype):
    return getattr(torch, dtype)


def _against(r, ref, rtol, band=1):
    """Count within ``band`` of the reference's, the history to ``rtol``
    but for the last entry, which straddles eps."""
    assert abs(r.iters - len(ref)) <= band, (r.iters, len(ref))
    m = min(r.iters, len(ref)) - 1
    np.testing.assert_allclose(np.asarray(r.history[:m]), np.asarray(ref[:m]),
                               rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pbicgstab_32_matches_oracle(dtype):
    ref = load(f"f{dtype[-2:]}_pbicgstab_sor2sma_32_w1.1.txt")
    p = czt.Problem.poisson_cube(32, dtype=_tdt(dtype), device="cpu")
    r = czt.solve(p, "pbicgstab", omega=1.1, itr_max=4000, precond="sor2sma")
    _against(r, ref, TOL[dtype])
    assert r.res < 1e-5 and r.history.dtype == torch.float64
    assert r.x.dtype == _tdt(dtype) and bool(torch.isfinite(r.x).all())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pbicgstab_maf_32_matches_oracle(dtype):
    """pbicgstab_maf on the uniform cube's MAF coefficients (calc_rk_maf's
    pivot scaling), preconditioned by sor2sma_maf (K2's MAF pair twin)."""
    ref = load(f"f{dtype[-2:]}_pbicgstab_maf_sor2sma_maf_32_w1.1.txt")
    p = czt.Problem.poisson_cube(32, dtype=_tdt(dtype), device="cpu", maf=True)
    r = czt.solve(p, "pbicgstab_maf", omega=1.1, itr_max=4000,
                  precond="sor2sma_maf")
    _against(r, ref, TOL[dtype])


def test_pbicgstab_none_64_f64_matches_oracle_count():
    """Without a preconditioner the 64^3 curve turns chaotic near its stop
    in float64 too: the JAX package's jnp solve stops at 46 against the
    oracle's 44, and the port at 44 or 46 by the order of torch's CPU sum
    (its thread count).  The count is held within 2 of the oracle's."""
    ref = load("f64_pbicgstab_none_64_w1.1.txt")
    p = czt.Problem.poisson_cube(64, dtype=torch.float64, device="cpu")
    r = czt.solve(p, "pbicgstab", omega=1.1, itr_max=4000, precond="none")
    assert abs(r.iters - len(ref)) <= 2 and r.res < 1e-5


@pytest.mark.parametrize("precond,omega", [
    ("sor2sma", 1.1), ("jacobi", 0.8), ("pcr_rb", 1.1), ("pcr_j_esa", 1.0),
    ("none", 1.1),
])
def test_pbicgstab_matches_jax(precond, omega):
    """float32 at 32^3, one jnp solve each: counts +-1, histories to rtol
    1e-3 but for the last entry (counts only without a preconditioner; see
    the module docstring)."""
    jr = jsolve(JProblem.poisson_cube(32, dtype=jnp.float32), "pbicgstab",
                omega=omega, itr_max=4000, precond=precond, impl="jnp")
    p = czt.Problem.poisson_cube(32, device="cpu")
    r = czt.solve(p, "pbicgstab", omega=omega, itr_max=4000, precond=precond)
    assert r.res < 1e-5
    if precond == "none":
        assert abs(r.iters - jr.iters) <= 1
    else:
        _against(r, np.asarray(jr.history), 1e-3)


@pytest.mark.parametrize("dtype,precond", [
    ("float32", "jacobi"), ("float64", "jacobi"), ("float32", None),
    ("float64", None),
])
def test_cg_matches_jax(dtype, precond):
    """cg with jacobi (omega 0.8) holds the JAX package's curve (float32 to
    rtol 1e-3, float64 to 1e-10, but for the last entry); without a
    preconditioner the count +-1."""
    jr = jsolve(JProblem.poisson_cube(32, dtype=getattr(jnp, dtype)), "cg",
                omega=0.8, itr_max=4000, precond=precond, impl="jnp")
    p = czt.Problem.poisson_cube(32, dtype=_tdt(dtype), device="cpu")
    r = czt.solve(p, "cg", omega=0.8, itr_max=4000, precond=precond)
    assert r.res < 1e-5
    if precond is None:
        assert abs(r.iters - jr.iters) <= 1
    else:
        _against(r, np.asarray(jr.history),
                 1e-3 if dtype == "float32" else 1e-10)


def _solved_problem(n=12):
    """A problem whose x0 is the discrete solution: r = b - A x0 is zero, so
    rho = 0 before the first iteration."""
    p = czt.Problem.poisson_cube(n, dtype=torch.float64, device="cpu")
    x0 = p.x0 + 0.25 * p.msk  # an interior the iterations would change
    b = blas.calc_ax(x0, p.msk) + p.rhs * (1.0 - p.msk)
    return dataclasses.replace(p, x0=x0, rhs=b, rhs_inner_zero=False)


@pytest.mark.parametrize("solver,precond", [
    ("pbicgstab", "none"), ("pbicgstab", "sor2sma"), ("cg", "jacobi"),
    ("cg", None),
])
def test_rho_breakdown_stops_before_touching_x(solver, precond):
    """|rho| < FLT_MIN stops before the iteration updates any state and
    reports 0 iterations (cz_Poisson.cpp:379-383)."""
    p = _solved_problem()
    r = czt.solve(p, solver, omega=1.1 if precond != "jacobi" else 0.8,
                  itr_max=50, precond=precond)
    assert r.iters == 0 and len(r.history) == 0
    assert torch.equal(r.x, p.x0)


def test_zero_problem_breaks_down_at_once():
    """b = 0 and x0 = 0: r = 0, so both solvers break down before their
    first iteration and hand back x0."""
    p = czt.Problem.poisson_cube(10, dtype=torch.float32, device="cpu")
    z = torch.zeros_like(p.x0)
    p = dataclasses.replace(p, x0=z, rhs=z.clone())
    for solver, pc in (("pbicgstab", "jacobi"), ("cg", "jacobi")):
        r = czt.solve(p, solver, omega=0.8, itr_max=20, precond=pc)
        assert r.iters == 0 and torch.equal(r.x, z)


class _PingPong:
    """A step that, as the CUDA steps do, returns one of two buffers it
    owns (the one that is not x) and never writes x."""

    iters_per_call = 2

    def __init__(self):
        self.bufs = []
        self.sweeps = 0

    def __call__(self, x, b):
        if not self.bufs:
            self.bufs = [torch.empty_like(x), torch.empty_like(x)]
        out = self.bufs[1] if x.data_ptr() == self.bufs[0].data_ptr() else self.bufs[0]
        torch.add(x, b, out=out)
        self.sweeps += self.iters_per_call
        return out, torch.zeros(())


def test_precon_result_is_its_own():
    """precon(p) followed by precon(s) leaves the first result bit for bit
    as it was, for a step that owns its buffers (the aliasing trap: BiCGSTAB
    reads precon(p) after precon(s) has run) and for each kernel route."""
    step = _PingPong()
    precon = bicgstab.sweeps_precon(step)
    p, s = torch.ones(4, 4, 4), torch.full((4, 4, 4), 3.0)
    first = precon(p)
    kept = first.clone()
    precon(s)
    # 8 sweeps are 4 calls of 2, each adding b
    assert torch.equal(first, kept) and torch.equal(first, 4 * p)
    prob = czt.Problem.poisson_cube((12, 12, 12), device="cpu")
    rng = np.random.default_rng(3)
    v, w = (torch.from_numpy(rng.standard_normal((12, 12, 12)).astype(np.float32))
            * prob.msk for _ in range(2))
    for name in ("sor2sma", "jacobi", "pcr_rb", "pcr_j_esa"):
        precon = bicgstab.make_precon(prob, name, 0.8)
        first = precon(v)
        kept = first.clone()
        again = precon(w)
        assert torch.equal(first, kept), name
        assert first.data_ptr() != again.data_ptr(), name


@pytest.mark.parametrize("ipc", [1, 2, 4, 8])
def test_precon_runs_exactly_8_sweeps(ipc):
    step = _PingPong()
    step.iters_per_call = ipc
    bicgstab.sweeps_precon(step)(torch.ones(3, 3, 3))
    assert step.sweeps == bicgstab.PRECOND_SWEEPS == 8


@pytest.mark.parametrize("ipc", [3, 5, 16])
def test_precon_refuses_a_step_that_cannot_run_8(ipc):
    step = _PingPong()
    step.iters_per_call = ipc
    with pytest.raises(ValueError, match="8 sweeps"):
        bicgstab.sweeps_precon(step)


def test_precon_kernel_steps_divide_8():
    """Every kernel route of the preconditioner runs whole calls to 8."""
    from cubez_tpu_torch.cuda_kernels import sweeps
    assert bicgstab.PRECOND_SWEEPS % sweeps.JACOBI_N == 0
    prob = czt.Problem.poisson_cube(12, device="cpu")
    for name in ("sor2sma", "jacobi", "pcr_rb", "pcr_j_esa"):
        bicgstab.make_precon(prob, name, 0.8)  # raises if it could not


@pytest.mark.parametrize("solver", ["pbicgstab", "cg"])
@pytest.mark.parametrize("precond,where", [
    ("psor", "slice 6"), ("pcr", "slice 6"), ("pcr_eda", "slice 6"),
    ("pcr_esa", "slice 6"), ("mg", "slice 7"), ("fmg", "slice 7"),
    ("fd", "slice 7"),
])
def test_unported_preconditioners_name_their_slice(solver, precond, where):
    """pbicgstab refuses each unported name with its slice, and takes slice
    6's names, which it refused so until they were ported; cg refuses the
    nonsymmetric ones first (ValueError, as the JAX package's cg) and fd,
    its symmetric one, with slice 7."""
    p = czt.Problem.poisson_cube(8, device="cpu")
    if solver == "cg" and precond != "fd":
        with pytest.raises(ValueError, match="symmetric"):
            czt.solve(p, solver, omega=1.0, itr_max=10, precond=precond)
        return
    if where == "slice 6":
        r = czt.solve(p, solver, omega=1.0, itr_max=10, precond=precond)
        assert r.res < 1e-5 and 0 < r.iters < 10
        return
    with pytest.raises(NotImplementedError, match=where):
        czt.solve(p, solver, omega=1.0, itr_max=10, precond=precond)


def test_krylov_names_are_not_preconditioners_nor_sweeps():
    p = czt.Problem.poisson_cube(8, device="cpu")
    with pytest.raises(ValueError, match="not a preconditioner"):
        czt.solve(p, "pbicgstab", omega=1.0, itr_max=10, precond="cg")
    for name in ("pbicgstab", "pbicgstab_maf", "cg"):
        with pytest.raises(ValueError, match="driver, not a sweep"):
            steps.make_step(p, name, 1.0)


@pytest.mark.parametrize("precond", ["sor2sma", "pcr_rb", "jacobi_maf"])
def test_cg_value_errors(precond):
    """cg refuses a MAF problem ("constant-coefficient") and a nonsymmetric
    preconditioner ("symmetric"), with the JAX package's messages."""
    p = czt.Problem.poisson_cube(8, device="cpu", maf=True)
    with pytest.raises(ValueError, match="constant-coefficient"):
        czt.solve(p, "cg", omega=0.8, itr_max=10, precond="jacobi")
    p = czt.Problem.poisson_cube(8, device="cpu")
    with pytest.raises(ValueError, match="symmetric"):
        czt.solve(p, "cg", omega=0.8, itr_max=10, precond=precond)
    assert cg.SYMMETRIC_PRECONDS == ("jacobi", "fd")


def test_maf_name_needs_coefficients():
    p = czt.Problem.poisson_cube(8, device="cpu")
    with pytest.raises(ValueError, match="MafCoeffs"):
        czt.solve(p, "pbicgstab_maf", omega=1.1, itr_max=10, precond="none")
    with pytest.raises(ValueError, match="MafCoeffs"):
        czt.solve(p, "pbicgstab", omega=1.1, itr_max=10, precond="sor2sma_maf")


def test_itr_max_and_history_file(tmp_path):
    """At most max(itr_max - 1, 1) iterations (cz_Poisson.cpp:373); the
    history file in the reference's format; 'plain' and 'auto' agree bit
    for bit on the CPU."""
    p = czt.Problem.poisson_cube(16, device="cpu")
    r = czt.solve(p, "pbicgstab", omega=1.1, itr_max=3, precond="sor2sma",
                  history_path=tmp_path / "h.txt")
    assert r.iters == 2 and r.res > 1e-5 and len(r.history) == 2
    rows = (tmp_path / "h.txt").read_text().splitlines()
    assert rows[0] == "Itration      Residual" and len(rows) == 3
    assert czt.solve(p, "cg", omega=0.8, itr_max=1, precond=None).iters == 1
    q = czt.solve(p, "pbicgstab", omega=1.1, itr_max=3, precond="sor2sma",
                  impl="plain")
    assert torch.equal(q.x, r.x) and torch.equal(q.history, r.history)


def test_nonstandard_mask_runs_the_plain_sweeps():
    """A mask other than the standard one has no kernel step: the
    preconditioner runs steps.make_step with the problem's mask."""
    p = czt.Problem.poisson_cube(16, dtype=torch.float64, device="cpu")
    msk = p.msk.clone()
    msk[5:8, 5:8, 5:8] = 0.0
    q = dataclasses.replace(p, msk=msk)
    assert not q.msk_is_standard()
    r = czt.solve(q, "pbicgstab", omega=1.1, itr_max=200, precond="sor2sma")
    assert r.res < 1e-5 and 0 < r.iters < 50
    assert torch.equal(r.x[5:8, 5:8, 5:8], q.x0[5:8, 5:8, 5:8])


def test_stretched_krylov_h2_convergence():
    """pbicgstab_maf with sor2sma_maf on the stretched grid's "krylov" sign
    (L x = b; the preconditioner's sweeps solve -L x = b and the sign is
    not flipped), float64, eps 1e-9: the 24^3/48^3 error ratio in the h^2
    band of tests/test_maf_stretched.py."""
    errs = {}
    for n in (24, 48):
        p, u = czt.Problem.manufactured_stretched(n, dtype=torch.float64,
                                                  family="krylov", device="cpu")
        r = czt.solve(p, "pbicgstab_maf", omega=1.1, itr_max=40000, eps=1e-9,
                      precond="sor2sma_maf")
        assert r.res < 1e-8
        errs[n] = float(((r.x - u).abs() * p.msk).max())
    assert 3.4 < errs[24] / errs[48] < 5.0
