"""The batched distributed path on CPU blocks: the twins of the launches
that take every block of a card at once (K8's ``sweep_blocks``, K9's
``pcr_blocks``, the face exchange and the residual fold of
cuda_kernels/dist_halo.py), the dist steps built on them against the JAX
package's ``solve_dist`` (``impl="jnp"``, the conftest's eight CPU
devices), and the serial ``solve`` with a non-standard mask or a line
solver with K - 2 < 2 against JAX's ``solve``, which runs its jnp step
there as the port now does.

Tolerances: the batched twins loop over the per-block twins, so they are
bitwise equal to them; the exchange twin equals ``refresh_ghosts`` on
every face ghost cell exactly (both copy); the fold twin sums in float64
like ``psum_all`` (rtol 1e-15, the order of the float64 adds); the
masked solves' fields within 2e-6 of JAX's (f32 roundoff: XLA contracts
its jitted sweep into fused multiply-adds, the port rounds each torch
operation), their counts exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubez_tpu import Problem as JProblem
from cubez_tpu import solve as j_solve
from cubez_tpu.parallel.api import solve_dist as j_solve_dist
from cubez_tpu.parallel.mesh import make_mesh as j_make_mesh

import cubez_tpu_torch as czt
from cubez_tpu_torch.cuda_kernels import dist_halo
from cubez_tpu_torch.cuda_kernels import dist_pcr as k9
from cubez_tpu_torch.cuda_kernels import dist_sweeps as k8
from cubez_tpu_torch.parallel import dist_fused
from cubez_tpu_torch.parallel.halo import FaceExchange, psum_all, refresh_ghosts

torch.set_num_threads(2)

OMEGA = 1.5
# (global shape, division): cubic blocks over (2, 2, 2), K-unsplit blocks
# over (1, 2, 2), and non-cubic (12, 14, 16) blocks
MESHES = [((16, 16, 16), (2, 2, 2)), ((16, 16, 16), (1, 2, 2)),
          ((24, 28, 32), (2, 2, 2))]
K8_VARIANTS = [("jacobi", None, "all"), ("sor2sma", 0, "all"),
               ("sor2sma", 1, "all"), ("sor2sma", None, "all"),
               ("sor2sma", 0, "interior"), ("sor2sma", 1, "shell")]
K9_VARIANTS = [(form, colour, maf) for form in ("pcr", "fastdiag")
               for colour in (0, 1, None) for maf in (False, True)]


def _mesh(gshape, div):
    return czt.make_mesh(gshape, devices=["cpu"] * (div[0] * div[1] * div[2]),
                         div=div)


def _blocks(cm, gshape, seed, dtype=torch.float32):
    gen = np.random.default_rng(seed)
    bs = cm.block_shape(gshape)
    return [torch.tensor(gen.uniform(-1, 1, tuple(s + 2 for s in bs)), dtype=dtype)
            for _ in range(cm.size)]


@pytest.mark.parametrize("mesh", range(len(MESHES)))
@pytest.mark.parametrize("variant", [("k8",) + v for v in K8_VARIANTS]
                         + [("k9",) + v for v in K9_VARIANTS])
def test_batched_twin_equals_per_block_twins(mesh, variant):
    """One batched twin call over every block equals the per-block twin
    on each block, bit for bit, with the per-block residuals handed to the
    Residual and folded as psum_all folds them."""
    gshape, div = MESHES[mesh]
    cm = _mesh(gshape, div)
    bshape = cm.block_shape(gshape)
    origins = cm.offsets(gshape)
    xs = _blocks(cm, gshape, 1)
    bs = _blocks(cm, gshape, 2)
    res = dist_halo.Residual("cpu")
    res.start()
    if variant[0] == "k8":
        _, kind, colour, region = variant
        got = k8.sweep_blocks([x.clone() for x in xs], bs, kind, colour, 0.8,
                              origins, gshape, 1, region, res=res)
        want = [k8.block_sweep_plain(x.clone(), b, kind, colour, 0.8,
                                     (*o, *gshape, 1), region)
                for x, b, o in zip(xs, bs, origins)]
    else:
        _, form, colour, maf = variant
        if form == "fastdiag" and div[0] != 1:
            form = "pcr"  # K split: the 'pcr' form only
        tabs = None
        if maf:
            mc = czt.Problem.manufactured_stretched(
                (gshape[1], gshape[2], gshape[0]), device="cpu")[0].mc
            tabs = [k9.block_maf_tables(mc, o, bshape, gshape, torch.float32, form)
                    for o in origins]
        got = k9.pcr_blocks([x.clone() for x in xs], bs, form, colour, OMEGA,
                            origins, gshape, 1, tabs, res=res)
        want = [k9.block_pcr_plain(x.clone(), b, form, colour, OMEGA,
                                   (*o, *gshape, 1), t)
                for x, b, o, t in zip(xs, bs, origins, tabs or [None] * len(xs))]
    for g, (w, _) in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(res.total(), psum_all([r for _, r in want]))


def _table(cm):
    return [[-1 if (nb := cm.neighbor(b, f // 2, 1 if f % 2 else -1)) is None
             else nb for f in range(6)] for b in range(cm.size)]


def _edges(x):
    """True on the ghost cells that are not face cells: a ghost index on
    two axes or more."""
    g = [torch.zeros(n, dtype=torch.bool) for n in x.shape]
    for t in g:
        t[0] = t[-1] = True
    cnt = (g[0][:, None, None].int() + g[1][None, :, None].int()
           + g[2][None, None, :].int())
    return cnt >= 2


@pytest.mark.parametrize("mesh", range(len(MESHES)))
def test_exchange_twin_matches_refresh_ghosts_on_faces(mesh):
    """The exchange twin writes every face ghost cell as refresh_ghosts
    does and leaves edge and corner ghosts as they were; FaceExchange on
    CPU blocks (its copy_ route) does the same."""
    gshape, div = MESHES[mesh]
    cm = _mesh(gshape, div)
    xs = _blocks(cm, gshape, 3)
    want = refresh_ghosts([x.clone() for x in xs], cm)
    got = dist_halo.halo_exchange_plain([x.clone() for x in xs], _table(cm))
    via = FaceExchange(cm)([x.clone() for x in xs])
    for x, w, g, v in zip(xs, want, got, via):
        e = _edges(x)
        assert torch.equal(g[~e], w[~e])
        assert torch.equal(g[e], x[e])
        assert torch.equal(v, g)


def test_fold_twin_matches_psum_all():
    """The fold's twin over per-CTA partials against psum_all over the
    same values as 0-d tensors: rtol 1e-15."""
    gen = np.random.default_rng(4)
    for n in (1, 7, 300, 2049):
        p = torch.tensor(gen.uniform(0, 1e-3, n), dtype=torch.float32)
        got = float(dist_halo.fold_partials(p, n))
        want = float(psum_all(list(p)))
        assert abs(got - want) <= 1e-15 * abs(want)


# (solver, sync, omega, division)
DIST_PATHS = [("sor2sma", "color", OMEGA, (2, 2, 2)),
              ("sor2sma", "overlap", OMEGA, (2, 2, 2)),
              ("jacobi", "auto", 0.8, (2, 2, 2)),
              ("pcr_rb", "auto", OMEGA, (2, 2, 2)),
              ("pcr_rb_maf", "auto", OMEGA, (2, 2, 2)),
              ("pcr_j_esa", "auto", 1.0, (2, 2, 2)),
              ("pcr_rb", "auto", OMEGA, (1, 2, 2)),
              ("pcr_rb_maf", "auto", OMEGA, (1, 2, 2)),
              ("pcr_j_esa", "auto", 1.0, (1, 2, 2))]


def _step(name, sync, omega, cm, p):
    kind = {"sor2sma": "sor2sma", "jacobi": "jacobi", "pcr_j_esa": "pcr"}.get(
        name, "pcr_rb")
    if sync == "overlap":
        return dist_fused.make_dist_fused_overlap_step(p, cm, omega, b_is_zero=True)
    return dist_fused.make_dist_fused_step(p, cm, kind, omega, b_is_zero=True)


@pytest.mark.parametrize("path", range(len(DIST_PATHS)))
def test_edge_ghosts_are_never_read(path):
    """Every dist step with its blocks' edge and corner ghosts poisoned
    with NaN: the owned cells and r2 stay finite and equal to the run
    without poison, three steps in a row."""
    name, sync, omega, div = DIST_PATHS[path]
    p = czt.Problem.poisson_cube(16, device="cpu", maf=name.endswith("_maf"))
    cm = _mesh((16, 16, 16), div)
    step = _step(name, sync, omega, cm, p)
    clean = dist_fused.to_block_state(cm, p.x0)
    dirty = [x.clone() for x in clean]
    for x in dirty:
        x[_edges(x)] = float("nan")
    for _ in range(3):
        clean, r_c = step(clean, None)
        dirty, r_d = step(dirty, None)
        assert torch.isfinite(r_d) and torch.equal(r_c, r_d)
        for a, b in zip(clean, dirty):
            own = (slice(1, -1),) * 3
            assert torch.isfinite(b[own]).all() and torch.equal(a[own], b[own])


@pytest.mark.parametrize("path", range(len(DIST_PATHS)))
def test_dist_counts_match_jax_jnp(path):
    """solve_dist at 16^3 on eight CPU blocks (the batched twins) stops at
    the iteration JAX's solve_dist with impl='jnp' stops at on the same
    mesh, for every K8 and K9 path."""
    name, sync, omega, div = DIST_PATHS[path]
    maf = name.endswith("_maf")
    nb = div[0] * div[1] * div[2]
    tp = czt.Problem.poisson_cube(16, device="cpu", maf=maf)
    r = czt.solve_dist(tp, _mesh((16, 16, 16), div), name, omega=omega,
                       itr_max=5000, sync=sync)
    jp = JProblem.poisson_cube(16, dtype=jnp.float32, maf=maf)
    jm = j_make_mesh((16, 16, 16), devices=jax.devices("cpu")[:nb], div=div)
    jr = j_solve_dist(jp, jm, name, omega=omega, itr_max=5000, impl="jnp",
                      sync="color" if sync == "overlap" else sync)
    assert r.iters == int(jr.iters) < 5000


def _masked(n=16):
    jp = JProblem.poisson_cube(n, dtype=jnp.float32)
    msk = np.asarray(jp.msk).copy()
    msk[5:8, 6, 7] = 0.0  # an obstacle: three nodes held at x0
    jp = dataclasses.replace(jp, msk=jnp.asarray(msk))
    tp = czt.Problem.from_arrays((n, n, n), torch.float32, np.asarray(jp.x0),
                                 np.asarray(jp.rhs), msk, rhs_inner_zero=True,
                                 device="cpu")
    assert not tp.msk_is_standard()
    return jp, tp


@pytest.mark.parametrize("name", ["sor2sma", "pcr_rb"])
def test_masked_solve_matches_jax(name):
    """The serial solve with a non-standard mask runs the plain masked
    sweep (steps.make_step), as JAX runs its jnp step: the same count,
    the field within 2e-6."""
    jp, tp = _masked()
    r = czt.solve(tp, name, omega=OMEGA, itr_max=2000)
    jr = j_solve(jp, name, omega=OMEGA, itr_max=2000)
    assert r.iters == int(jr.iters) < 2000
    np.testing.assert_allclose(r.x.numpy(), np.asarray(jr.x), rtol=0, atol=2e-6)


@pytest.mark.parametrize("name,omega", [("pcr_rb", OMEGA), ("pcr_j_esa", 1.0)])
def test_thin_k_line_solve_matches_jax(name, omega):
    """A line solver with K - 2 < 2 has no kernel step: the serial solve
    runs the plain line sweep, as JAX runs its jnp step where no tiling
    fits; the same count, the field within 2e-6."""
    tp = czt.Problem.poisson_cube((8, 8, 3), device="cpu")
    jp = JProblem.poisson_cube((8, 8, 3), dtype=jnp.float32)
    r = czt.solve(tp, name, omega=omega, itr_max=500)
    jr = j_solve(jp, name, omega=omega, itr_max=500)
    assert r.iters == int(jr.iters)
    np.testing.assert_allclose(r.x.numpy(), np.asarray(jr.x), rtol=0, atol=2e-6)
