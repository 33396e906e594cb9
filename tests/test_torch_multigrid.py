"""The port's multigrid (cubez_tpu_torch/solvers/multigrid.py) on the CPU,
against the JAX package's (cubez_tpu/solvers/multigrid.py) on the same
inputs, seeded with numpy.

The transfers and the level hierarchy are held bitwise.  A V-cycle and an
F-cycle differ from the JAX package's XLA smoother only in the finest
level's arithmetic: the port smooths there with K4's twin, whose update
multiplies by a rounded 1/6 in a fused multiply-add where the XLA sweep
divides by 6 (cuda_kernels/rbpack.py's contracts), so they agree to a few
ulps a sweep: float64 to 1e-12, float32 to 2e-5 (fields of order 1).
Whole solves run the JAX package's own ``solve`` under
``jax.disable_jit()`` (op by op: compiling its unrolled V-cycle takes XLA
about 30 s on a CPU) with ``check_every=1``, so its field is the one at
the stopping iteration, as the port's is: the counts are equal, the
float32 histories within rtol 1e-3 (the repo's float32 band; every entry
lies above the float32 roundoff floor, the last near 1e-6) and the fields
within 1e-5.
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
from cubez_tpu.solvers import multigrid as jmg
from cubez_tpu_torch.solvers import bicgstab
from cubez_tpu_torch.solvers import multigrid as tmg

torch.set_num_threads(1)

SEED = 20261017
DT = {"f32": (torch.float32, jnp.float32), "f64": (torch.float64, jnp.float64)}
NP = {"f32": np.float32, "f64": np.float64}
# one V-cycle or F-cycle against the XLA smoother (module docstring)
CYCLE_ATOL = {"f32": 2e-5, "f64": 1e-12}


def _problems(shape, dt, maf):
    """The port's and the JAX package's problem on the grid of ``shape``
    (K, I, J): the reference's Laplace cube, or under MAF the stretched
    manufactured problem (coordinates that coarsen unevenly)."""
    K, I, J = shape
    tdt, jdt = DT[dt]
    if maf:
        tp, _ = czt.Problem.manufactured_stretched((I, J, K), dtype=tdt,
                                                   device="cpu")
        jp, _ = JProblem.manufactured_stretched((I, J, K), dtype=jdt)
    else:
        tp = czt.Problem.poisson_cube((I, J, K), dtype=tdt, device="cpu")
        jp = JProblem.poisson_cube((I, J, K), dtype=jdt)
    return tp, jp


def _seeded(shape, n, dtype):
    rng = np.random.default_rng(SEED)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(n)]


@pytest.mark.parametrize("shape,dt", [
    ((33, 33, 33), "f64"), ((18, 20, 24), "f32"), ((17, 26, 21), "f64")])
def test_transfers_and_levels_bitwise(shape, dt):
    """restrict_fw, prolong, _inject_coarse, build_levels (shapes, masks,
    MAF coefficients of the coarsened coordinates) and _coarsen_coords
    equal the JAX package's bit for bit."""
    tdt, jdt = DT[dt]
    tp, jp = _problems(shape, dt, maf=True)
    tl = tmg.build_levels(shape, tdt, "cpu",
                          coords=(tp.grid.zc, tp.grid.xc, tp.grid.yc))
    jl = jmg.build_levels(shape, jdt,
                          coords=(jp.grid.zc, jp.grid.xc, jp.grid.yc))
    assert [lv.shape for lv in tl] == [lv.shape for lv in jl]
    assert len(tl) >= 2
    for t, j in zip(tl, jl):
        np.testing.assert_array_equal(t.msk.numpy(), np.asarray(j.msk))
        for c in range(2):
            np.testing.assert_array_equal(
                t.cmasks[c].numpy(), np.asarray(j.msk * j.cmasks[c]))
        for f in ("c1", "c7", "c2", "c8", "c3", "c9"):
            np.testing.assert_array_equal(getattr(t.mc, f).numpy(),
                                          np.asarray(getattr(j.mc, f)))
    for tc, jc, m in zip((tp.grid.zc, tp.grid.xc, tp.grid.yc),
                         (jp.grid.zc, jp.grid.xc, jp.grid.yc),
                         (s - 2 for s in shape)):
        np.testing.assert_array_equal(tmg._coarsen_coords(tc, m).numpy(),
                                      np.asarray(jmg._coarsen_coords(jc, m)))
    coarse = tl[1].shape
    f, e = _seeded(shape, 1, NP[dt])[0], _seeded(coarse, 1, NP[dt])[0]
    np.testing.assert_array_equal(
        tmg.restrict_fw(torch.tensor(f), coarse).numpy(),
        np.asarray(jmg.restrict_fw(jnp.asarray(f), coarse)))
    np.testing.assert_array_equal(
        tmg.prolong(torch.tensor(e), shape).numpy(),
        np.asarray(jmg.prolong(jnp.asarray(e), shape)))
    np.testing.assert_array_equal(
        tmg._inject_coarse(torch.tensor(f), coarse).numpy(),
        np.asarray(jmg._inject_coarse(jnp.asarray(f), coarse)))


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("maf", [False, True])
def test_one_vcycle_and_fmg_init_match_jax(maf, dt):
    """One V-cycle from a seeded field with a seeded b, and one F-cycle
    from the stretched problem's RHS, against make_mg_step(...,
    smoother="xla") at a non-cubic shape, with the residual sum to rtol
    1e-5 (float32) or 1e-12."""
    shape = (18, 20, 24)
    tp, jp = _problems(shape, dt, maf)
    x, b = _seeded(shape, 2, np.float64)
    msk = tp.msk.numpy().astype(np.float64)
    x = (x * msk + tp.x0.numpy()).astype(NP[dt])
    b = (b * msk).astype(NP[dt])
    ts = tmg.make_mg_step(tp.grid, omega=1.0, maf=maf, fmg=True,
                          bc_shell=tp.x0 * (1.0 - tp.msk))
    js = jmg.make_mg_step(jp.grid, omega=1.0, smoother="xla", maf=maf,
                          fmg=True, bc_shell=jp.x0 * (1.0 - jp.msk))
    with jax.disable_jit():
        xj, rj = js(jnp.asarray(x), jnp.asarray(b))
        ij = js.fmg_init(jp.rhs)
    xt, rt = ts(torch.tensor(x), torch.tensor(b))
    it = ts.fmg_init(tp.rhs)
    atol = CYCLE_ATOL[dt]
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=atol)
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=0, atol=atol)
    assert rt.dtype == torch.float64
    np.testing.assert_allclose(float(rt), float(rj),
                               rtol=1e-5 if dt == "f32" else 1e-12)
    assert ts.check_every_default == 2


@pytest.mark.parametrize("n", [32, 33])
@pytest.mark.parametrize("name", ["mg", "mg_maf", "fmg", "fmg_maf"])
def test_solve_matches_jax(name, n):
    """Whole float32 solves at omega 1.0: JAX's count, its history within
    rtol 1e-3 and its field at the stop within 1e-5.  (float64 is held
    per cycle above: a whole float64 solve costs JAX's op-by-op run twice
    the compilations.)"""
    maf = name.endswith("_maf")
    r = czt.solve(czt.Problem.poisson_cube(n, device="cpu", maf=maf), name,
                  omega=1.0, itr_max=100)
    with jax.disable_jit():
        rj = jsolve(JProblem.poisson_cube(n, dtype=jnp.float32, maf=maf),
                    name, omega=1.0, itr_max=100, check_every=1)
    assert r.iters == rj.iters and r.res < 1e-5
    np.testing.assert_allclose(r.history.numpy(), np.asarray(rj.history),
                               rtol=1e-3)
    np.testing.assert_allclose(r.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("solver,precond", [
    ("pbicgstab", "mg"), ("pbicgstab", "fmg"), ("pbicgstab_maf", "mg_maf"),
])
def test_krylov_mg_precond_matches_jax(solver, precond):
    """One V-cycle an application at omega 1.0 (fmg maps to mg): JAX's
    count, history within rtol 1e-3."""
    maf = solver.endswith("_maf")
    r = czt.solve(czt.Problem.poisson_cube(32, device="cpu", maf=maf), solver,
                  omega=1.1, itr_max=50, precond=precond)
    with jax.disable_jit():
        rj = jsolve(JProblem.poisson_cube(32, dtype=jnp.float32, maf=maf),
                    solver, omega=1.1, itr_max=50, precond=precond)
    assert r.iters == rj.iters and r.res < 1e-5
    np.testing.assert_allclose(r.history.numpy(), np.asarray(rj.history),
                               rtol=1e-3)


def test_fmg_precond_is_one_mg_vcycle():
    p = czt.Problem.poisson_cube(16, device="cpu")
    assert bicgstab.precon_plan("fmg_maf", 1.7) == ("mg_maf", 1.0, 1)
    assert bicgstab.precon_plan("fd", 1.7) == ("fd", 1.0, 1)
    assert bicgstab.precon_plan("sor2sma", 1.7) == ("sor2sma", 1.7, 8)
    ra = czt.solve(p, "pbicgstab", omega=1.1, itr_max=50, precond="fmg")
    rb = czt.solve(p, "pbicgstab", omega=1.1, itr_max=50, precond="mg")
    assert ra.iters == rb.iters and torch.equal(ra.x, rb.x)


@pytest.mark.parametrize("div", [(2, 2, 2), (1, 2, 2)])
@pytest.mark.parametrize("name", ["mg", "fmg_maf"])
def test_solve_dist_is_the_serial_solve(name, div):
    """solve_dist runs the serial step on the gathered field: the serial
    count, history and field bit for bit."""
    p = czt.Problem.poisson_cube(16, device="cpu", maf=name.endswith("_maf"))
    cm = czt.make_mesh((16,) * 3, devices=["cpu"] * 8 if div == (2, 2, 2)
                       else ["cpu"] * 4, div=div)
    rs = czt.solve(p, name, omega=1.0, itr_max=100)
    rd = czt.solve_dist(p, cm, name, omega=1.0, itr_max=100)
    assert rd.iters == rs.iters and rs.res < 1e-5
    assert torch.equal(rd.x, rs.x) and torch.equal(rd.history, rs.history)
    with pytest.raises(ValueError, match="pack"):
        czt.solve_dist(p, cm, name, omega=1.0, itr_max=4, sync="pack")


def test_refusals():
    """A custom mask, foreign MAF coefficients, fmg from an x0 with an
    interior, and a _maf name without coefficients raise ValueError, with
    the JAX package's messages."""
    p = czt.Problem.poisson_cube(12, device="cpu")
    msk = p.msk.clone()
    msk[5, 6, 7] = 0.0
    for name in ("mg", "fmg"):
        with pytest.raises(ValueError, match="standard cube inner mask"):
            czt.solve(dataclasses.replace(p, msk=msk), name, omega=1.0,
                      itr_max=4)
    stretched, _ = czt.Problem.manufactured_stretched(12, dtype=torch.float32,
                                                      device="cpu")
    pm = czt.Problem.poisson_cube(12, device="cpu", maf=True)
    foreign = dataclasses.replace(pm, mc=stretched.mc)
    for name in ("mg_maf", "fmg_maf"):
        with pytest.raises(ValueError, match="own coordinate arrays"):
            czt.solve(foreign, name, omega=1.0, itr_max=4)
    with pytest.raises(ValueError, match="MafCoeffs"):
        czt.solve(p, "mg_maf", omega=1.0, itr_max=4)
    restarted = dataclasses.replace(p, x0=p.x0 + 0.5 * p.msk)
    with pytest.raises(ValueError, match="'mg'"):
        czt.solve(restarted, "fmg", omega=1.0, itr_max=4)
    r = czt.solve(restarted, "mg", omega=1.0, itr_max=4)
    assert r.iters == 4


def test_mg_results_are_their_own():
    """Two mg preconditioner applications: the first result stays intact;
    a solve's field is not rewritten by a later solve either (on CUDA,
    where K4 alternates between two buffers of its own, the same test runs
    in tests/test_torch_cuda_kernels.py)."""
    p = czt.Problem.poisson_cube(20, device="cpu")
    pre = bicgstab.make_precon(p, "mg", 1.0)
    v, w = (torch.tensor(a) * p.msk
            for a in _seeded((20,) * 3, 2, np.float32))
    first = pre(v)
    kept = first.clone()
    pre(w)
    assert torch.equal(first, kept)
    r1 = czt.solve(p, "mg", omega=1.0, itr_max=3)
    x1 = r1.x.clone()
    czt.solve(dataclasses.replace(p, x0=r1.x), "mg", omega=1.0, itr_max=3)
    assert torch.equal(r1.x, x1)
