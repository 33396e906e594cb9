"""Slice 6's line Gauss-Seidel in the exact serial order (pcr, pcr_eda,
pcr_esa and their MAF forms) on the CPU: the plain twin of kernel P2
against the JAX package's diagonal step, whole solves against the JAX
package's counts and the oracle histories, the standard mask's refusal,
the pbicgstab preconditioner, solve_dist, and P2's plan.

Tolerances: the JAX package's step solves a diagonal's lines with its PCR
plan (4x4 final under constant coefficients) inside a jitted fori_loop,
which XLA contracts, and sums dp^2 in the field's dtype (its
pcr_gs.py:127); the twin runs K10's table solve (2x2 final; MAF
ops/pcr.py::pcr_reduce_var) one rounding an operation and sums in
float64.  So a sweep is held within 1e-5 of the field's scale in float32
and 1e-12 in float64, the residual to 1e-4 and 1e-10; counts exactly to
the JAX package's, curves to rtol 1e-3 (float32, but for the last entry)
and 1e-6 (float64); the 32^3 oracle as tests/test_ref_parity.py holds it
(+-1%, rtol 1e-6).
"""

import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubez_tpu import Problem as JProblem
from cubez_tpu import solve as jsolve
from cubez_tpu.ops import pcr_gs as jgs

import cubez_tpu_torch as czt
from cubez_tpu_torch.cuda_kernels import pcr as k10
from cubez_tpu_torch.cuda_kernels import pcr_gs as p2
from cubez_tpu_torch.cuda_kernels.rbpack import maf_tables
from cubez_tpu_torch.ops import maf as tmaf
from cubez_tpu_torch.ops import pcr_gs, psor_scan
from cubez_tpu_torch.parallel import make_mesh
from cubez_tpu_torch.solvers import bicgstab

torch.set_num_threads(2)

OMEGA = 1.5  # the oracle's pcr runs (tests/ref_histories/*_pcr_*_w1.5.txt)
HIST = pathlib.Path(__file__).resolve().parent / "ref_histories"
SHAPES = [(16, 16, 16), (12, 9, 14), (3, 7, 5)]  # (K, I, J); one inner row
BAND = {"float32": (1e-5, 1e-4), "float64": (1e-12, 1e-10)}  # field, r2


def load(name):
    rows = (HIST / name).read_text().splitlines()[1:]
    return np.array([float(ln.split(",")[1]) for ln in rows])


def _fields(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-1, 1, shape).astype(dtype) for _ in range(2))


@functools.lru_cache(maxsize=None)
def _jproblem(shape, dtype, maf):
    K, I, J = shape
    return JProblem.poisson_cube((I, J, K), dtype=getattr(jnp, dtype), maf=maf)


def _carry(jmc):
    """The JAX package's MafCoeffs carried across to the port."""
    return tmaf.MafCoeffs.from_numpy(
        *(np.asarray(getattr(jmc, f)) for f in tmaf.FIELDS), device="cpu")


@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", SHAPES)
def test_step_within_band_of_jax_diag_step(shape, dtype, maf):
    """One sweep of the port's step (the twin on the CPU) against the JAX
    package's make_pcr_gs_diag_step, within BAND, at zero and seeded b."""
    x, b = _fields(shape, dtype, 3)
    jp = _jproblem(shape, dtype, maf)
    jstep = jgs.make_pcr_gs_diag_step(shape, getattr(jnp, dtype), OMEGA,
                                      mc=jp.mc if maf else None)
    run = jax.jit(jstep)
    step = pcr_gs.make_pcr_gs_diag_step(shape, getattr(torch, dtype), OMEGA,
                                        mc=_carry(jp.mc) if maf else None)
    tol, rtol = BAND[dtype]
    for bb in (np.zeros_like(b), b):
        jS, jr2 = run(jstep._pre(jnp.asarray(x)), jstep._pre(jnp.asarray(bb)))
        S, r2 = step(step.pad(torch.from_numpy(x)), step.pad(torch.from_numpy(bb)))
        np.testing.assert_allclose(step.unpad(S).numpy(),
                                   np.asarray(jstep._post(jS)), rtol=0,
                                   atol=tol * float(np.abs(x).max()))
        assert float(r2) == pytest.approx(float(jr2), rel=rtol)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_twin_relaxes_the_lines_of_each_diagonal_in_order(dtype):
    """The twin's sweep is line Gauss-Seidel in the serial (j, i) order:
    equal, bit for bit, to relaxing one inner line at a time in the
    reference's loop order on the (K, I, J) field with K10's line solve
    (the same right-hand sides a line)."""
    shape = (10, 7, 9)
    K, I, J = shape
    x, b = (torch.from_numpy(a) for a in _fields(shape, dtype, 4))
    skew, unskew, _ = psor_scan.make_skew(shape)
    S, r2 = pcr_gs.pcr_gs_diag_plain(skew(x), skew(b), OMEGA)
    y = x.clone()
    n = K - 2
    tab = k10.stage_tables(n, y.dtype, "cpu")
    r6 = torch.tensor(1.0 / 6.0, dtype=y.dtype)
    om = torch.tensor(OMEGA, dtype=y.dtype)
    for j in range(1, J - 1):
        for i in range(1, I - 1):
            t = ((y[1:-1, i - 1, j] + y[1:-1, i, j - 1]) + y[1:-1, i + 1, j]) \
                + y[1:-1, i, j + 1]
            d = (t - b[1:-1, i, j]) * r6
            d[0] = d[0] + y[0, i, j] * r6
            d[-1] = d[-1] + y[K - 1, i, j] * r6
            s = k10.pcr_solve(d, tab, k10.num_stage(n))
            y[1:-1, i, j] = y[1:-1, i, j] + (s - y[1:-1, i, j]) * om
    assert torch.equal(unskew(S), y)


@functools.lru_cache(maxsize=None)
def _jax_solve(name, dtype, n=16):
    return jsolve(JProblem.poisson_cube(n, dtype=getattr(jnp, dtype),
                                        maf=name.endswith("_maf")),
                  name, omega=OMEGA, itr_max=4000, impl="jnp")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["pcr", "pcr_eda", "pcr_esa", "pcr_maf",
                                  "pcr_eda_maf", "pcr_esa_maf"])
def test_16_solve_gives_jax_count(name, dtype):
    """All six names (three layouts of one serial line-GS, as in the JAX
    package) stop at the JAX package's count, 38 at 16^3."""
    p = czt.Problem.poisson_cube(16, dtype=getattr(torch, dtype), device="cpu",
                                 maf=name.endswith("_maf"))
    r = czt.solve(p, name, omega=OMEGA, itr_max=4000)
    # pcr_eda and pcr_esa are pcr's step in the JAX package too
    jr = _jax_solve("pcr_maf" if name.endswith("_maf") else "pcr", dtype)
    assert r.iters == jr.iters == 38 and r.res < 1e-5
    rtol, m = (1e-3, r.iters - 1) if dtype == "float32" else (1e-6, r.iters)
    np.testing.assert_allclose(r.history[:m].numpy(),
                               np.asarray(jr.history)[:m], rtol=rtol)
    assert np.abs(r.x.numpy() - np.asarray(jr.x)).max() < (
        1e-5 if dtype == "float32" else 1e-12)


def test_32_f64_oracle_count_and_curve():
    ref = load("f64_pcr_32_w1.5.txt")
    p = czt.Problem.poisson_cube(32, dtype=torch.float64, device="cpu")
    r = czt.solve(p, "pcr", omega=OMEGA, itr_max=40000)
    assert len(ref) == 142
    assert abs(r.iters - len(ref)) <= max(1, len(ref) // 100)
    m = min(r.iters, len(ref))
    np.testing.assert_allclose(r.history[:m].numpy(), ref[:m], rtol=1e-6)


@pytest.mark.parametrize("name", ["pcr", "pcr_esa_maf"])
def test_nonstandard_mask_raises_serial_and_on_mesh(name):
    p = czt.Problem.poisson_cube(8, device="cpu", maf=name.endswith("_maf"))
    msk = p.msk.clone()
    msk[3, 3, 3] = 0.0
    q = dataclasses.replace(p, msk=msk)
    with pytest.raises(ValueError, match="standard cube inner mask"):
        czt.solve(q, name, omega=OMEGA, itr_max=4)
    cm = make_mesh(p.grid.shape_kij, devices=["cpu"] * 8, div=(2, 2, 2))
    with pytest.raises(ValueError, match="standard cube inner mask"):
        czt.solve_dist(q, cm, name, omega=OMEGA, itr_max=4)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pbicgstab_with_pcr_converges_and_precon_is_jax_step_by_hand(dtype):
    """The preconditioner is 8 sweeps from zero in the step's own layout:
    the JAX package's diag step driven through its _pre/_post by hand
    (its bicgstab.py hands the unskewed vector to the skewed step
    instead, a fault of the reference package the port does not copy)."""
    p = czt.Problem.poisson_cube(16, dtype=getattr(torch, dtype), device="cpu")
    r = czt.solve(p, "pbicgstab", omega=1.1, itr_max=200, precond="pcr")
    assert r.res < 1e-5 and 0 < r.iters < 20
    v, _ = _fields((16,) * 3, dtype, 5)
    v = v * p.msk.numpy()
    got = bicgstab.make_precon(p, "pcr", 1.1)(torch.from_numpy(v))
    jstep = jgs.make_pcr_gs_diag_step((16,) * 3, getattr(jnp, dtype), 1.1)
    run = jax.jit(jstep)
    S, B = jstep._pre(jnp.zeros((16,) * 3, getattr(jnp, dtype))), jstep._pre(v)
    for _ in range(bicgstab.PRECOND_SWEEPS):
        S, _ = run(S, B)
    tol = BAND[dtype][0] * float(np.abs(v).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(jstep._post(S)),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("name", ["pcr", "pcr_maf"])
def test_solve_dist_is_the_serial_solve_bit_for_bit(name):
    p = czt.Problem.poisson_cube(12, device="cpu", maf=name.endswith("_maf"))
    cm = make_mesh(p.grid.shape_kij, devices=["cpu"] * 8, div=(2, 2, 2))
    rd = czt.solve_dist(p, cm, name, omega=OMEGA, itr_max=4000)
    rs = czt.solve(p, name, omega=OMEGA, itr_max=4000)
    assert rd.iters == rs.iters > 0
    assert torch.equal(rd.x, rs.x) and torch.equal(rd.history, rs.history)


def test_solve_dist_krylov_with_pcr_preconditioner():
    """pbicgstab over (2, 2, 2) with pcr as its preconditioner (the serial
    step on the gathered vector) stops within one iteration of the serial
    solve."""
    p = czt.Problem.poisson_cube(16, device="cpu")
    cm = make_mesh(p.grid.shape_kij, devices=["cpu"] * 8, div=(2, 2, 2))
    rd = czt.solve_dist(p, cm, "pbicgstab", omega=1.1, itr_max=200,
                        precond="pcr")
    rs = czt.solve(p, "pbicgstab", omega=1.1, itr_max=200, precond="pcr")
    assert rd.res < 1e-5 and abs(rd.iters - rs.iters) <= 1


@pytest.mark.parametrize("n,dtype,maf,form,slabs", [
    (1, torch.float32, False, "lines", 1), (32, torch.float32, False, "lines", 1),
    (33, torch.float32, False, "lines", 2), (126, torch.float32, False, "lines", 4),
    (512, torch.float32, False, "lines", 16), (513, torch.float32, False, "tile", 0),
    (256, torch.float32, True, "lines", 8), (257, torch.float32, True, "tile", 0),
    (128, torch.float64, True, "lines", 4), (129, torch.float64, True, "tile", 0),
    (510, torch.float64, False, "lines", 16),
])
def test_plan_forms(n, dtype, maf, form, slabs):
    """P2 takes K10's limits: a warp a line to 512 rows (MAF to 32
    pcr.MAF_SLABS rows), else the tile form, whose items fit its shared
    memory."""
    p = p2.plan(n, dtype, maf)
    assert (p.form, p.slabs) == (form, slabs)
    item = torch.empty((), dtype=dtype).element_size()
    assert p.smem(item, maf) <= k10.SMEM_CTA
    if form == "tile":
        assert 1 <= p.lines <= p2.LINES and p2.THREADS % p.lines == 0
        assert p.smem(item, maf) <= k10.SMEM_BYTES
    forced = p2.plan(n, dtype, maf, "tile")
    assert forced.form == "tile" and forced.lines >= 1


def test_plan_refusals():
    with pytest.raises(ValueError, match="inner row"):
        p2.plan(0)
    with pytest.raises(ValueError, match="form"):
        p2.plan(8, form="rows")
    with pytest.raises(ValueError, match="line form"):
        p2.plan(600, form="lines")
    with pytest.raises(ValueError, match="line form"):
        p2.plan(300, torch.float32, maf=True, form="lines")


def test_cpu_wrapper_runs_the_twin_and_counts_nothing():
    shape = (10, 9, 11)
    x, b = _fields(shape, "float64", 6)
    skew, _, _ = psor_scan.make_skew(shape)
    S, B = skew(torch.from_numpy(x)), skew(torch.from_numpy(b))
    mc = czt.Problem.poisson_cube((9, 11, 10), dtype=torch.float64, device="cpu",
                                  maf=True).mc
    before = (p2.pcr_gs_diag.launches, dict(p2.pcr_gs_diag.variant_launches))
    for m in (None, mc):
        out, r2 = p2.pcr_gs_diag(S, B, OMEGA, m)
        ref, r2p = pcr_gs.pcr_gs_diag_plain(
            S, B, OMEGA, maf_tables(m, shape, torch.float64))
        assert torch.equal(out, ref) and torch.equal(r2, r2p)
    assert (p2.pcr_gs_diag.launches, p2.pcr_gs_diag.variant_launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        p2.PcrGsSweep(OMEGA)(S, B)


# ---- P2's lagged schedule, replayed on the plain line relaxation -------------

TINY = [(3, 7, 5), (6, 5, 7), (12, 9, 14)]  # (K, I, J)


@pytest.mark.parametrize("ctas", [1, 2])
@pytest.mark.parametrize("sweeps", [1, 2, 3, 4])
@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", TINY)
def test_lagged_schedule_is_n_serial_sweeps(shape, dtype, maf, sweeps, ctas):
    """P2's launch of n sweeps, replayed item by item (items of 2 lines,
    one or two CTAs a sweep) on the twin's line relaxation in place,
    leaves the field of n serial sweeps of the plain twin bit for bit:
    each CTA walks its diagonals as ``flag_waits`` lets it, in a random
    order, every task's inputs are done by all their CTAs when it runs,
    and nothing deadlocks."""
    tdt = getattr(torch, dtype)
    K, I, J = shape
    x, b = (torch.from_numpy(a) for a in _fields(shape, dtype, 13 + sweeps))
    skew, _, _ = psor_scan.make_skew(shape)
    S0, B = skew(x), skew(b)
    mc = (tmaf.MafCoeffs.from_coords(*(torch.linspace(0, 1, m, dtype=tdt) ** 1.3
                                       for m in (I, J, K)))
          if maf else None)
    tab = maf_tables(mc, shape, tdt)
    ref = S0
    for _ in range(sweeps):
        ref, _ = pcr_gs.pcr_gs_diag_plain(ref, B, OMEGA, tab)
    relax = pcr_gs.line_relaxer(shape, OMEGA, tdt, "cpu", tab)
    S = S0.clone()
    rng = np.random.default_rng(sweeps)
    G, per_item = ctas, 2
    d_last = I + J - 4

    def run(d, g):
        """CTA g's items of diagonal d: g, g + G, ..."""
        lo, hi = psor_scan.line_range(d, I, J)
        for i0 in range(lo + g * per_item, hi + 1, G * per_item):
            relax(S, B, d, i0, min(hi, i0 + per_item - 1))

    nxt = {(s, g): 2 for s in range(sweeps) for g in range(G)}
    count = [0] * sweeps
    done = set()  # (s, d, g)
    while nxt:
        ready = [k for k in nxt if all(
            count[q] >= v for q, v in p2.flag_waits(shape, G, k[0], nxt[k]))]
        assert ready, "the counters deadlock"
        s, g = key = ready[rng.integers(len(ready))]
        d = nxt[key]
        for q in p2.inputs((s, d), shape):
            assert all((*q, h) in done for h in range(G))
        run(d, g)
        done.add((s, d, g))
        count[s] += 1
        nxt[key] += 1
        if nxt[key] > d_last:
            del nxt[key]
    assert len(done) == sweeps * (d_last - 1) * G
    assert torch.equal(S, ref)


def test_launch_grid_sweeps_shrink_before_items_share_a_cta():
    """A launch takes a CTA an item of the longest diagonal for each of
    its sweeps; past the card's co-resident CTAs the sweeps shrink, and
    only at one sweep does a CTA take several items of a diagonal."""
    p = p2.plan(126, sweeps=8)
    assert p2.launch_grid(p, (128,) * 3, 1056) == (8, 16)
    assert p2.launch_grid(p, (128,) * 3, 100) == (6, 16)
    assert p2.launch_grid(p, (128,) * 3, 10) == (1, 10)
    assert p2.launch_grid(p2.plan(126, sweeps=1), (128,) * 3, 1056) == (1, 16)
    with pytest.raises(ValueError, match="at least one sweep"):
        p2.PcrGsSweep(OMEGA, sweeps=0)


@pytest.mark.parametrize("maf", [False, True])
def test_multi_sweep_launcher_refuses_cpu_tensors(maf):
    """The twin runs one sweep a call: a launcher of several sweeps given
    CPU tensors raises rather than run one and report it as several."""
    shape = (10, 9, 11)
    x, b = _fields(shape, "float32", 8)
    skew, _, _ = psor_scan.make_skew(shape)
    S, B = skew(torch.from_numpy(x)), skew(torch.from_numpy(b))
    mc = czt.Problem.poisson_cube(10, device="cpu", maf=True).mc if maf else None
    before = S.clone()
    with pytest.raises(ValueError, match="4 sweeps needs a CUDA tensor"):
        p2.pcr_gs_diag(S, B, OMEGA, mc, launcher=p2.PcrGsSweep(OMEGA, mc, sweeps=4))
    assert torch.equal(S, before)


def test_cpu_step_runs_one_sweep_a_call():
    """On the CPU the step is the twin, one sweep a call: iters_per_call 1
    and its own single, whatever the preconditioner asks."""
    for divides in (None, 8):
        step = pcr_gs.make_pcr_gs_diag_step((10, 9, 11), torch.float32, OMEGA,
                                            device="cpu", divides=divides)
        assert step.iters_per_call == 1 and step.single is step
