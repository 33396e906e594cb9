"""K4 on shared-memory plane tiles (cuda_kernels/sweeps.py): the Jacobi
step of n iterations a call and the one-pass, out-of-place red-black step
against the JAX package's interpreted make_fused_sweep, the host tile plan
the wrappers launch with, and ``driver.fixed_sweeps`` on the n-iteration
step.  Float32 fields bitwise; residuals to rtol 1e-5 (the JAX kernel
sums per tile in float32)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubez_tpu import Problem as JProblem
from cubez_tpu.pallas_kernels import sweeps as jsw

import cubez_tpu_torch as czt
from cubez_tpu_torch.cuda_kernels import sweeps as tsw
from cubez_tpu_torch.ops import maf as tmaf
from cubez_tpu_torch.solvers import driver

torch.set_num_threads(1)

SHAPE = (16, 16, 16)
ODD = (16, 17, 16)  # odd I: the dispatch's red-black K4 shape
# two float32 ulps of the fields' largest values (4 <= |x| < 8)
MAF_ULPS = 2 * 2.0 ** -21


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _mc(shape):
    """(JAX MafCoeffs, the port's carried across) of a stretched grid."""
    K, I, J = shape
    jp, _ = JProblem.manufactured_stretched((I, J, K), dtype=jnp.float32)
    tmc = tmaf.MafCoeffs.from_numpy(
        *(np.asarray(getattr(jp.mc, f)) for f in tmaf.FIELDS), device="cpu")
    return jp.mc, tmc


@functools.lru_cache(maxsize=None)
def _jax_step(kind, shape, maf, with_b, offset=0):
    """JAX's interpreted K4 step, jitted once per variant."""
    jmc = _mc(shape)[0] if maf else None
    return jax.jit(jsw.make_fused_sweep(
        kind, shape, jnp.float32, omega=0.8 if kind == "jacobi" else 1.5,
        offset=offset, b_is_zero=not with_b, mc=jmc, interpret=True))


@pytest.mark.parametrize("shape", [SHAPE, (13, 11, 18)])
@pytest.mark.parametrize("with_b", [False, True])
@pytest.mark.parametrize("maf", [False, True])
def test_jacobi_n_step_matches_n_single_steps_and_jax(maf, with_b, shape):
    """One call of the step (n = JACOBI_N iterations): bitwise n calls of
    its single step and n calls of JAX's make_fused_sweep('jacobi'); its
    (n,) r2 the single steps' and, to rtol 1e-5, JAX's."""
    n = tsw.JACOBI_N
    tmc = _mc(shape)[1] if maf else None
    x, b = _fields(shape, 50 + shape[1])
    step = tsw.make_fused_sweep("jacobi", shape, torch.float32, omega=0.8,
                                b_is_zero=not with_b, mc=tmc)
    assert n > 1 and step.iters_per_call == n
    assert step.single.iters_per_call == 1
    jstep = _jax_step("jacobi", shape, maf, with_b)
    xt, bt = step.pad(torch.tensor(x)), step.pad(torch.tensor(b))
    xs, xj = xt.clone(), jsw.pad_k2(jnp.asarray(x))
    bj = jsw.pad_k2(jnp.asarray(b))
    rs, rj = [], []
    for _ in range(n):
        xs, r = step.single(xs, bt)
        rs.append(float(r))
        xj, r = jstep(xj, bj)
        rj.append(float(r))
    keep = xt.clone()
    xn, rn = step(xt, bt)
    assert torch.equal(xt, keep)  # out of place
    assert rn.shape == (n,)
    assert torch.equal(xn, xs)
    want = np.asarray(jsw.unpad_k2(xj, shape))
    if maf and shape[2] != 16:
        # XLA on the CPU contracts the MAF sum as the kernels' fma chain
        # only at J = 16 (ROADMAP.md, "MAF contraction"): elsewhere JAX's
        # interpreted kernel lands a float32 ulp or two away
        np.testing.assert_allclose(step.unpad(xn).numpy(), want, rtol=0,
                                   atol=MAF_ULPS)
    else:
        np.testing.assert_array_equal(want, step.unpad(xn).numpy())
    np.testing.assert_array_equal(rn.numpy(), np.array(rs))
    np.testing.assert_allclose(rn.numpy(), rj, rtol=1e-5)


@pytest.mark.parametrize("shape", [SHAPE, ODD])
@pytest.mark.parametrize("with_b", [False, True])
@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("offset", [0, 1])
def test_one_pass_red_black_step_matches_jax(offset, maf, with_b, shape):
    """The out-of-place red-black step (its twin: both colours on a copy)
    and sor2sma_k4's CPU form against JAX's K4 sor2sma at the offset,
    three calls; the field it was handed is never written."""
    tmc = _mc(shape)[1] if maf else None
    x, b = _fields(shape, 60 + offset)
    step = tsw.make_fused_sweep("sor2sma", shape, torch.float32, omega=1.5,
                                offset=offset, b_is_zero=not with_b, mc=tmc)
    jstep = _jax_step("sor2sma", shape, maf, with_b, offset)
    tab = tsw.maf_tables(tmc, shape, torch.float32)
    xt, bt = step.pad(torch.tensor(x)), step.pad(torch.tensor(b))
    xj, bj = jsw.pad_k2(jnp.asarray(x)), jsw.pad_k2(jnp.asarray(b))
    xw = xt.clone()
    for _ in range(3):
        keep = xt.clone()
        xn, rt = step(xt, bt)
        assert torch.equal(xt, keep) and xn.data_ptr() != xt.data_ptr()
        xw, rw = tsw.sor2sma_k4(xw, bt if with_b else None, 1.5, offset, tab)
        xj, rj = jstep(xj, bj)
        xt = xn
        np.testing.assert_array_equal(np.asarray(jsw.unpad_k2(xj, shape)),
                                      step.unpad(xt).numpy())
        assert torch.equal(xw, xt) and torch.equal(rw, rt)
        np.testing.assert_allclose(float(rt), float(rj), rtol=1e-5)


def _axis_ranges(items, axis):
    return sorted({box[axis] for box in items})


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("kind,n", [("jacobi", 1), ("jacobi", tsw.JACOBI_N),
                                    ("sor2sma", 1)])
@pytest.mark.parametrize("shape", [(125, 125, 125), (128, 128, 128),
                                   (512, 512, 512), (512, 511, 512),
                                   (37, 22, 45), (3, 33, 35), (4, 31, 65),
                                   (130, 45, 97), (64, 300, 200)])
def test_tile_plan_covers_each_cell_once(shape, kind, n, itemsize):
    """The plan the wrappers launch with: its work items' owned boxes are
    the product of a partition of each axis (so every cell is owned
    exactly once), the halo holds n iterations (2 for red-black), the ring
    of planes fits a CTA's shared memory, and the k chunks end the launch
    soonest for the card's co-resident CTAs."""
    plan = tsw.tile_plan(kind, shape, n, itemsize, sms=132)
    items = list(plan.items())
    assert len(items) == plan.nwork == len(set(items))
    for axis, size in enumerate(shape):
        ranges = _axis_ranges(items, axis)
        assert ranges[0][0] == 0 and ranges[-1][1] == size
        assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(ranges, ranges[1:]))
        assert ranges[-1][0] < ranges[-1][1]
    assert len(items) == np.prod([len(_axis_ranges(items, a)) for a in range(3)])
    assert plan.halo == (n if kind == "jacobi" else 2) and plan.halo >= n
    planes = 3 * n + tsw.AHEAD if kind == "jacobi" else 4 + tsw.AHEAD
    assert plan.smem == planes * (plan.ti + 2 * plan.halo) * tsw.ROW * itemsize
    assert plan.smem <= tsw.SMEM_CTA
    # the region fits the kernel's rows; tiles as even as the bounds allow
    assert plan.ti + 2 * plan.halo <= tsw.REGION_ROWS
    tj_most = tsw.ROW - 2 * plan.halo - (16 // itemsize - 1)
    assert plan.tj <= tj_most
    for size, t, most in ((shape[1], plan.ti, tsw.REGION_ROWS - 2 * plan.halo),
                          (shape[2], plan.tj, tj_most)):
        assert -(-size // t) == -(-size // most)
    K = shape[0]
    assert plan.nkc <= -(-K // tsw.MIN_KCHUNK)
    # the k chunks end the launch soonest: each co-resident CTA runs
    # ceil(items / slots) items of kchunk planes and the steps past them
    extra = 2 * n if kind == "jacobi" else 4
    for slots in (132 * plan.per_sm, 100, 7):
        p = tsw.tile_plan(kind, shape, n, itemsize, slots=slots)
        assert (p.ti, p.tj, p.smem) == (plan.ti, plan.tj, plan.smem)
        tiles = p.tiles_i * p.tiles_j
        ends = [-(-tiles * m // slots) * (-(-K // m) + extra)
                for m in range(1, -(-K // tsw.MIN_KCHUNK) + 1)
                if -(-K // -(-K // m)) == m]
        assert -(-p.nwork // slots) * (p.kchunk + extra) == min(ends)


@pytest.mark.parametrize("shape", [(9, 13, 11), (4, 7, 70), (3, 40, 3)])
def test_tile_plan_counts_on_small_fields(shape):
    """The same cover, counted cell by cell on small ragged fields."""
    for kind, n in (("jacobi", tsw.JACOBI_N), ("sor2sma", 1)):
        plan = tsw.tile_plan(kind, shape, n, 4, sms=2)
        cnt = torch.zeros(shape, dtype=torch.int32)
        for (k0, k1), (i0, i1), (j0, j1) in plan.items():
            cnt[k0:k1, i0:i1, j0:j1] += 1
        assert bool((cnt == 1).all())


def test_tile_plan_refusals():
    with pytest.raises(ValueError, match="n in"):
        tsw.tile_plan("jacobi", SHAPE, 3)
    with pytest.raises(ValueError, match="n in"):
        tsw.tile_plan("jacobi", SHAPE, 4)
    with pytest.raises(ValueError, match="kind"):
        tsw.tile_plan("psor", SHAPE)


@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("single", [False, True])
def test_fixed_sweeps_8_equals_8_single_steps(single, maf):
    """Slice 4's preconditioner runs 8 fixed sweeps on this step: its n
    must divide 8, and 8 fixed sweeps of the step (or of its single form)
    give 8 single steps' field bit for bit."""
    assert 8 % tsw.JACOBI_N == 0
    p = czt.Problem.poisson_cube((14, 15, 16), device="cpu", maf=maf)
    step = tsw.make_fused_sweep("jacobi", p.grid.shape_kij, omega=0.8,
                                b_is_zero=True, mc=p.mc)
    x0 = step.pad(torch.tensor(_fields((14, 15, 16), 70)[0]))
    got = driver.fixed_sweeps(step.single if single else step, x0, None, 8)
    want = x0
    for _ in range(8):
        want, _ = step.single(want, None)
    assert torch.equal(got, want)


def test_jacobi_solve_does_not_depend_on_n():
    """run_iterative replays the stopping chunk with step.single, so the
    count, history and field of a solve on the step (n = JACOBI_N) are
    those of a solve on its single form (n = 1), at two chunk lengths."""
    p = czt.Problem.poisson_cube(20, device="cpu")
    step = tsw.make_fused_sweep("jacobi", p.grid.shape_kij, omega=0.8,
                                b_is_zero=True)
    res = [driver.run_iterative(st, p.x0, p.rhs, p.grid.res_normal,
                                itr_max=2000, pre=step.pad, check_every=ce)
           for st in (step.single, step) for ce in (16, 5)]
    for r in res[1:]:
        assert r.iters == res[0].iters < 2000
        assert torch.equal(r.x, res[0].x)
        assert torch.equal(r.history, res[0].history)
