"""The port's ghosted-block distributed steps (K8) against the JAX package
on the conftest's eight CPU devices: K8's twin bitwise against the
interpreted ``make_block_sweep`` on one block with nonzero offsets, the
fused steps against JAX's jnp shard_map steps (the tolerance of
tests/test_dist_fused.py: field within 1e-6, r2 within rtol 1e-5 for
jacobi and 1e-4 for sor2sma), the 'iter' cadence bitwise against JAX's
interpreted fused step, the dryrun's convergence proofs at 32^3, the
routes of parallel/dist.py and K9 against JAX's solve_dist, and the
refusals of what the port does not run yet."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubez_tpu import Problem as JProblem
from cubez_tpu.pallas_kernels import dist_sweeps as jds
from cubez_tpu.parallel import dist_fused as jdf
from cubez_tpu.parallel.dist import make_dist_step as j_make_dist_step
from cubez_tpu.parallel.mesh import make_mesh as j_make_mesh

import cubez_tpu_torch as czt
from cubez_tpu_torch.cuda_kernels import dist_sweeps as tds
from cubez_tpu_torch.parallel import dist_fused

torch.set_num_threads(1)

OMEGA = 1.5
N = 16
BS, GS, ORIGIN = (8, 10, 12), (16, 20, 24), (8, 0, 12)


def _jmesh(n, div):
    return j_make_mesh((n, n, n), devices=jax.devices("cpu")[:8], div=div)


def _tmesh(n, div):
    nd = div[0] * div[1] * div[2]
    return czt.make_mesh((n, n, n), devices=["cpu"] * nd, div=div)


@pytest.mark.parametrize("div", [(2, 2, 2), (2, 4, 1), (1, 1, 1)])
def test_block_state_roundtrip(div):
    x = torch.tensor(np.random.default_rng(1).standard_normal((N, N, N)),
                     dtype=torch.float32)
    cm = _tmesh(N, div)
    st = dist_fused.to_block_state(cm, x)
    lk, li, lj = cm.block_shape((N, N, N))
    assert all(s.shape == (lk + 2, li + 2, lj + 2) for s in st)
    assert torch.equal(dist_fused.from_block_state(cm, st, (N, N, N)), x)


@functools.lru_cache(maxsize=None)
def _jsweep(kind, color, shrink, with_b):
    return jds.make_block_sweep(kind, BS, GS, jnp.float32,
                                omega=0.8 if kind == "jacobi" else OMEGA,
                                color=color, shrink_shell=shrink,
                                b_is_zero=not with_b, interpret=True)


@pytest.mark.parametrize("with_b", [False, True])
@pytest.mark.parametrize("kind,color,shrink", [
    ("jacobi", None, False), ("sor2sma", 0, False), ("sor2sma", 1, False),
    ("sor2sma", None, False), ("sor2sma", 0, True), ("sor2sma", 1, True),
])
def test_k8_twin_matches_interpreted_kernel(kind, color, shrink, with_b):
    """One pass on a block at a nonzero origin whose faces include the
    physical boundary, random ghosts: owned cells bitwise, r2 to rtol 1e-5
    (JAX sums dp^2 per tile in float32)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(tuple(s + 2 for s in BS)).astype(np.float32)
    b = rng.standard_normal(x.shape).astype(np.float32)
    kp, ip, jp = jds.block_layout(BS)

    def to_jax(a):  # (lk+2, li+2, lj+2) -> JAX's (lk+4, Ip, Jp)
        out = np.zeros((kp, ip, jp), np.float32)
        out[1:-1, :a.shape[1], :a.shape[2]] = a
        return jnp.asarray(out)

    offs = jnp.asarray([ORIGIN], jnp.int32)
    xj, rj = _jsweep(kind, color, shrink, with_b)(to_jax(x), to_jax(b), offs)
    tsweep = tds.make_block_sweep(kind, BS, GS, omega=0.8 if kind == "jacobi"
                                  else OMEGA, color=color, b_is_zero=not with_b,
                                  region="interior" if shrink else "all")
    xt, rt = tsweep(torch.tensor(x), torch.tensor(b), ORIGIN)
    lk, li, lj = BS
    np.testing.assert_array_equal(
        np.asarray(xj)[2:lk + 2, 1:li + 1, 1:lj + 1], xt[1:-1, 1:-1, 1:-1].numpy())
    np.testing.assert_allclose(float(rt), float(rj), rtol=1e-5)


def test_k8_shell_and_interior_partition_the_colour():
    """The overlap step's two passes, interior then shell, give the field
    of the one full colour pass bitwise."""
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.standard_normal(tuple(s + 2 for s in BS)),
                     dtype=torch.float32)
    geom = (*ORIGIN, *GS, 0)
    for c in (0, 1):
        full, r_full = tds.block_sweep(x.clone(), None, "sor2sma", c, OMEGA, geom)
        part, r_in = tds.block_sweep(x.clone(), None, "sor2sma", c, OMEGA, geom,
                                     "interior")
        part, r_sh = tds.block_sweep(part, None, "sor2sma", c, OMEGA, geom, "shell")
        assert torch.equal(full, part)
        torch.testing.assert_close(r_in + r_sh, r_full, rtol=1e-12, atol=0)


@pytest.mark.parametrize("kind,omega,rtol", [("jacobi", 0.8, 1e-5),
                                             ("sor2sma", OMEGA, 1e-4)])
def test_fused_step_matches_jax_dist_step(kind, omega, rtol):
    """Four steps on (2, 2, 2) at 16^3 (sor2sma with sync='color') against
    JAX's jnp shard_map step: field within 1e-6, r2 within ``rtol``."""
    jp = JProblem.poisson_cube(N, dtype=jnp.float32)
    jm = _jmesh(N, (2, 2, 2))
    jstep = jax.jit(j_make_dist_step(jp, jm, kind, omega))
    tp = czt.Problem.poisson_cube(N, device="cpu")
    tm = _tmesh(N, (2, 2, 2))
    tstep = dist_fused.make_dist_fused_step(tp, tm, kind, omega, b_is_zero=True)
    xj, bj = jm.shard(jp.x0), jm.shard(jp.rhs)
    xt = dist_fused.to_block_state(tm, tp.x0)
    for _ in range(4):
        xj, rj = jstep(xj, bj)
        xt, rt = tstep(xt, None)
    got = dist_fused.from_block_state(tm, xt, (N, N, N))
    assert float(np.abs(got.numpy() - np.asarray(xj)).max()) < 1e-6
    np.testing.assert_allclose(float(rt), float(rj), rtol=rtol)


def test_iter_sync_matches_jax_fused_step():
    """sync='iter' (both colours per exchange, the reference's cadence) on
    (2, 2, 2): two steps bitwise JAX's interpreted fused step."""
    jp = JProblem.poisson_cube(N, dtype=jnp.float32)
    jm = _jmesh(N, (2, 2, 2))
    jstep = jax.jit(jdf.make_dist_fused_step(jp, jm, "sor2sma", OMEGA,
                                             sync="iter", b_is_zero=True,
                                             interpret=True))
    tp = czt.Problem.poisson_cube(N, device="cpu")
    tm = _tmesh(N, (2, 2, 2))
    tstep = dist_fused.make_dist_fused_step(tp, tm, "sor2sma", OMEGA,
                                            b_is_zero=True, sync="iter")
    xj = jdf.to_block_state(jm, jp.x0)
    xt = dist_fused.to_block_state(tm, tp.x0)
    for _ in range(2):
        xj, rj = jstep(xj, xj)
        xt, rt = tstep(xt, None)
    want = np.asarray(jdf.from_block_state(jm, xj, (N, N, N)))
    np.testing.assert_array_equal(
        dist_fused.from_block_state(tm, xt, (N, N, N)).numpy(), want)
    np.testing.assert_allclose(float(rt), float(rj), rtol=1e-5)


def test_dryrun_fused_proofs_at_32():
    """The dryrun's proofs at 32^3 over (2, 2, 2), on the twins: sor2sma
    'color' at the serial 199, 'overlap' within one of it with the 'color'
    field bit for bit, jacobi at omega 0.8 at the serial 1015."""
    p = czt.Problem.poisson_cube(32, device="cpu")
    cm = _tmesh(32, (2, 2, 2))
    rc = czt.solve_dist(p, cm, "sor2sma", omega=OMEGA, itr_max=2000, sync="color")
    ro = czt.solve_dist(p, cm, "sor2sma", omega=OMEGA, itr_max=2000,
                        sync="overlap")
    assert rc.iters == 199 and abs(ro.iters - 199) <= 1
    if ro.iters == rc.iters:
        assert torch.equal(ro.x, rc.x)
    rj = czt.solve_dist(p, cm, "jacobi", omega=0.8, itr_max=3000)
    assert rj.iters == czt.solve(p, "jacobi", omega=0.8, itr_max=3000).iters == 1015
    assert czt.max_error(p.grid, rc.x) < 3e-4


@pytest.mark.parametrize("solver,kw,exc,match", [
    ("mg", {}, NotImplementedError, "slice 7"),
    ("psor", {}, NotImplementedError, "slice 6"),
    ("pcr", {}, NotImplementedError, "slice 6"),
    ("sor2sma", {"impl": "pallas"}, ValueError, "impl"),
    ("sor2sma", {"sync": "lowsync"}, ValueError, "sync"),
    ("sor2sma", {"sync": "pack", "dtype": torch.float64}, ValueError, "pack"),
])
def test_unported_paths_raise(solver, kw, exc, match):
    """What the JAX package reaches only through auto-SPMD (the exact
    serial orders, slice 6, and the extensions, slice 7) raised naming its
    slice until it was ported; it now runs the serial step on the gathered
    field, the serial solve bit for bit.  Bad options raise ValueError."""
    p = czt.Problem.poisson_cube(N, dtype=kw.pop("dtype", torch.float32),
                                 device="cpu", maf=solver.endswith("_maf"))
    if match in ("slice 6", "slice 7"):
        rd = czt.solve_dist(p, _tmesh(N, (2, 2, 2)), solver, omega=1.0,
                            itr_max=4, **kw)
        rs = czt.solve(p, solver, omega=1.0, itr_max=4)
        assert rd.iters == rs.iters == 4 and torch.equal(rd.x, rs.x)
        return
    with pytest.raises(exc, match=match):
        czt.solve_dist(p, _tmesh(N, (2, 2, 2)), solver, omega=1.0, itr_max=4,
                       **kw)


@pytest.mark.parametrize("solver,omega,kw", [
    ("pcr_rb", OMEGA, {}),
    ("pcr_j_esa", 1.0, {}),
    ("jacobi_maf", 0.8, {}),
    ("sor2sma_maf", OMEGA, {"sync": "color"}),
    ("jacobi", 0.8, {"sync": "overlap"}),
    ("sor2sma", OMEGA, {"dtype": torch.float64}),
    ("sor2sma", OMEGA, {"mask": True}),
])
def test_dist_paths_match_jax_solve_dist(solver, omega, kw):
    """The routes this file's earlier refusals covered now run: the line
    solvers on K9's twins, the rest on parallel/dist.py, each to tolerance
    at 16^3 over (2, 2, 2) with the JAX package's count (its jnp dist
    steps) and history within rtol 1e-3 (1e-9 in float64)."""
    dtype = kw.pop("dtype", torch.float32)
    maf = solver.endswith("_maf")
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jp = JProblem.poisson_cube(N, dtype=jdt, maf=maf)
    p = czt.Problem.poisson_cube(N, dtype=dtype, device="cpu", maf=maf)
    if kw.pop("mask", False):
        msk = np.asarray(jp.msk).copy()
        msk[5, 6, 7] = 0.0
        jp = dataclasses.replace(jp, msk=jnp.asarray(msk))
        p = czt.Problem(grid=p.grid, x0=p.x0, rhs=p.rhs, msk=torch.tensor(msk),
                        rhs_inner_zero=True)
    from cubez_tpu.parallel.api import solve_dist as j_solve_dist

    rj = j_solve_dist(jp, _jmesh(N, (2, 2, 2)), solver, omega=omega,
                      itr_max=3000, **kw)
    rt = czt.solve_dist(p, _tmesh(N, (2, 2, 2)), solver, omega=omega,
                        itr_max=3000, **kw)
    assert rt.iters == rj.iters
    np.testing.assert_allclose(rt.history.numpy(), np.asarray(rj.history),
                               rtol=1e-9 if dtype == torch.float64 else 1e-3)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert float(np.abs(rt.x.numpy() - np.asarray(rj.x)).max()) < tol
