"""The port's fast-diagonalization solver (cubez_tpu_torch/solvers/
direct.py) on the CPU, against the JAX package's (cubez_tpu/solvers/
direct.py) on the same problems.

The eigen tables come from the same numpy on the same float64 inputs, so
they are held bitwise.  One step is the same six contractions summed in
another order (``torch.matmul`` against ``jnp.einsum`` at HIGHEST), so
the fields agree to 1e-12 in float64 and 1e-5 in float32 (fields of
order 1).  A solve reaches the float32 roundoff floor in its one
iteration (the JAX package's test_fd_one_shot_machine_residual), so only
the count and ``res`` below eps are compared there, not the history.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cubez_tpu_torch as czt
from cubez_tpu import Problem as JProblem
from cubez_tpu import solve as jsolve
from cubez_tpu.solvers import direct as jdirect
from cubez_tpu_torch.solvers import direct as tdirect

torch.set_num_threads(1)

SHAPE = (17, 20, 23)  # (K, I, J)
DT = {"f32": (torch.float32, jnp.float32), "f64": (torch.float64, jnp.float64)}
STEP_ATOL = {"f32": 1e-5, "f64": 1e-12}


def _problems(dt, maf):
    K, I, J = SHAPE
    tdt, jdt = DT[dt]
    if maf:
        return (czt.Problem.manufactured_stretched((I, J, K), dtype=tdt,
                                                   device="cpu")[0],
                JProblem.manufactured_stretched((I, J, K), dtype=jdt)[0])
    return (czt.Problem.poisson_cube((I, J, K), dtype=tdt, device="cpu"),
            JProblem.poisson_cube((I, J, K), dtype=jdt))


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("maf", [False, True])
def test_axis_tables_bitwise(maf, dt):
    tp, jp = _problems(dt, maf)
    tt = tdirect._axis_tables(tp.grid, tp.mc if maf else None)
    jt = jdirect._axis_tables(jp.grid, jp.mc if maf else None)
    for t, j in zip(tt, jt):
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("maf", [False, True])
def test_one_step_matches_jax(maf, dt):
    """One fd step from a seeded field with a seeded b, on a non-cubic
    grid.  Its residual sits at the roundoff floor on both sides, so it is
    held below that floor's reach (res under 1e-5 in float32 and 1e-12 in
    float64, from an initial residual of order 1), not to JAX's value."""
    tp, jp = _problems(dt, maf)
    rng = np.random.default_rng(20261017)
    msk = tp.msk.numpy().astype(np.float64)
    npdt = np.float64 if dt == "f64" else np.float32
    x = (rng.standard_normal(SHAPE) * msk + tp.x0.numpy()).astype(npdt)
    b = (rng.standard_normal(SHAPE) * msk).astype(npdt)
    xt, rt = tdirect.make_fd_step(tp, maf=maf)(torch.tensor(x), torch.tensor(b))
    with jax.disable_jit():
        xj, rj = jdirect.make_fd_step(jp, maf=maf)(jnp.asarray(x), jnp.asarray(b))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=STEP_ATOL[dt])
    assert rt.dtype == torch.float64
    floor = 1e-5 if dt == "f32" else 1e-12
    for r2 in (float(rt), float(rj)):
        assert (r2 * tp.grid.res_normal) ** 0.5 < floor


@pytest.mark.parametrize("n", [32, 33, (20, 26, 17)])
@pytest.mark.parametrize("name", ["fd", "fd_maf"])
def test_solve_matches_jax(name, n):
    maf = name.endswith("_maf")
    tp = czt.Problem.poisson_cube(n, device="cpu", maf=maf)
    r = czt.solve(tp, name, omega=1.0, itr_max=100)
    with jax.disable_jit():
        rj = jsolve(JProblem.poisson_cube(n, dtype=jnp.float32, maf=maf), name,
                    omega=1.0, itr_max=100)
    assert r.iters == rj.iters == 1
    assert r.res < 1e-6 and float(rj.res) < 1e-6
    assert r.x.dtype == torch.float32
    np.testing.assert_allclose(r.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-5)
    if isinstance(n, int):  # the analytic solution is the cube's
        assert czt.max_error(tp.grid, r.x) < 1e-3


@pytest.mark.parametrize("solver,precond", [
    ("cg", "fd"), ("pbicgstab", "fd"), ("pbicgstab_maf", "fd_maf")])
def test_krylov_fd_precond_matches_jax(solver, precond):
    """One fd solve an application: JAX's count."""
    maf = solver.endswith("_maf")
    r = czt.solve(czt.Problem.poisson_cube(32, device="cpu", maf=maf), solver,
                  omega=1.1, itr_max=20, precond=precond)
    with jax.disable_jit():
        rj = jsolve(JProblem.poisson_cube(32, dtype=jnp.float32, maf=maf),
                    solver, omega=1.1, itr_max=20, precond=precond)
    assert r.iters == rj.iters and r.res < 1e-5


def test_refusals():
    """A custom mask, a non-separable MAF operator, a _maf name without
    coefficients, and cg with a _maf preconditioner or a MAF problem raise
    ValueError, with the JAX package's messages."""
    p = czt.Problem.poisson_cube(12, device="cpu")
    pm = czt.Problem.poisson_cube(12, device="cpu", maf=True)
    msk = p.msk.clone()
    msk[5, 6, 7] = 0.0
    for name, q in (("fd", p), ("fd_maf", pm)):
        with pytest.raises(ValueError, match="standard cube inner mask"):
            czt.solve(dataclasses.replace(q, msk=msk), name, omega=1.0,
                      itr_max=2)
    full = dataclasses.replace(pm.mc, c3=pm.mc.c3.expand(12, 12, 12))
    with pytest.raises(ValueError, match="non-separable"):
        czt.solve(dataclasses.replace(pm, mc=full), "fd_maf", omega=1.0,
                  itr_max=2)
    with pytest.raises(ValueError, match="MafCoeffs"):
        czt.solve(p, "fd_maf", omega=1.0, itr_max=2)
    with pytest.raises(ValueError, match="symmetric"):
        czt.solve(p, "cg", omega=1.0, itr_max=2, precond="fd_maf")
    with pytest.raises(ValueError, match="constant-coefficient"):
        czt.solve(pm, "cg", omega=1.0, itr_max=2, precond="fd")


def test_ieee_fp32_holds_and_restores_the_callers_setting():
    """The step pins IEEE FP32 matmuls and restores the caller's setting
    (made here with set_float32_matmul_precision("high"), which allows
    TF32 on a card); the result is the same under either setting."""
    p = czt.Problem.poisson_cube(20, device="cpu")
    mm = torch.backends.cuda.matmul
    before = mm.fp32_precision
    ref = czt.solve(p, "fd", omega=1.0, itr_max=3, eps=1e-30)
    try:
        torch.set_float32_matmul_precision("high")
        assert mm.fp32_precision == "tf32"
        with tdirect.ieee_fp32():
            assert mm.fp32_precision == "ieee"
        assert mm.fp32_precision == "tf32"
        r = czt.solve(p, "fd", omega=1.0, itr_max=3, eps=1e-30)
        assert mm.fp32_precision == "tf32"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        mm.fp32_precision = before
    assert torch.equal(r.x, ref.x) and torch.equal(r.history, ref.history)


@pytest.mark.parametrize("name", ["fd", "fd_maf"])
def test_solve_dist_is_the_serial_solve(name):
    p = czt.Problem.poisson_cube(16, device="cpu", maf=name.endswith("_maf"))
    cm = czt.make_mesh((16,) * 3, devices=["cpu"] * 8, div=(2, 2, 2))
    rs = czt.solve(p, name, omega=1.0, itr_max=10, eps=1e-30)
    rd = czt.solve_dist(p, cm, name, omega=1.0, itr_max=10, eps=1e-30)
    assert rd.iters == rs.iters == 10
    assert torch.equal(rd.x, rs.x) and torch.equal(rd.history, rs.history)
    if name == "fd":
        r = czt.solve_dist(p, cm, "cg", omega=1.0, itr_max=10, precond="fd")
        rs = czt.solve(p, "cg", omega=1.0, itr_max=10, precond="fd")
        assert r.iters == rs.iters and r.res < 1e-5
