"""Slice 6's point-SOR in the exact serial order (psor, psor_maf) on the
CPU: the diagonal layout's converters, the plain twin of kernel P1 against
the JAX package's hyperplane sweep and its diagonal step, whole solves
against the JAX package's counts and the oracle histories, the standard
mask's refusal, the pbicgstab preconditioner, solve_dist, and the driver's
``check_every_default``.

Tolerances: the converters and the hyperplane sweep run op by op are
bitwise (copies; the same point update in the same order, one rounding an
operation); the JAX package's jitted psor_sweep within 4 ulps (XLA
contracts its update).  The JAX package's step solves each K-line as
an affine recurrence by ``associative_scan`` and sums dp^2 in the field's
dtype (its psor_scan.py:170), so a sweep differs from the serial one by
the scan's reassociation: held within 1e-5 of the field's scale in
float32 and 1e-12 in float64, the residual to 1e-4 and 1e-10.  Counts are
held exactly to the JAX package's; curves to rtol 1e-3 (float32, but for
the last entry) and 1e-6 (float64); the 32^3 oracle as
tests/test_ref_parity.py holds it (+-1%, rtol 1e-6).
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
from cubez_tpu.ops import maf as jmaf
from cubez_tpu.ops import psor_scan as jps
from cubez_tpu.ops import stencil as jstencil

import cubez_tpu_torch as czt
from cubez_tpu_torch.cuda_kernels import psor as p1
from cubez_tpu_torch.cuda_kernels import rbpack
from cubez_tpu_torch.ops import maf as tmaf
from cubez_tpu_torch.ops import psor_scan, stencil
from cubez_tpu_torch.parallel import make_mesh
from cubez_tpu_torch.solvers import bicgstab, driver

torch.set_num_threads(2)

OMEGA = 1.1  # the oracle's psor runs (tests/ref_histories/*_psor_*_w1.1.txt)
HIST = pathlib.Path(__file__).resolve().parent / "ref_histories"
SHAPES = [(16, 16, 16), (12, 9, 14)]  # (K, I, J)
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


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", SHAPES)
def test_skew_is_the_jax_packages_bit_for_bit(shape, dtype):
    x, _ = _fields(shape, dtype, 1)
    jskew, junskew, jD = jps.make_skew(shape, getattr(jnp, dtype))
    skew, unskew, D = psor_scan.make_skew(shape)
    s = skew(torch.from_numpy(x))
    js = np.asarray(jskew(jnp.asarray(x)))
    assert D == jD and s.shape == js.shape and s.is_contiguous()
    assert np.array_equal(s.numpy(), js)
    assert np.array_equal(unskew(s).numpy(), np.asarray(junskew(js)))
    assert np.array_equal(unskew(s).numpy(), x)
    assert psor_scan.field_shape(s) == shape


@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", SHAPES)
def test_twin_sweep_is_the_hyperplane_sweep_bit_for_bit(shape, dtype, maf):
    """P1's twin (unskew, the port's psor_sweep, skew) equals the JAX
    package's hyperplane sweep run op by op (a masked dense jacobi_delta,
    under MAF maf_delta, a hyperplane, stencil.py:131) bit for bit: the
    same point update in the same order.  The JAX package's own
    psor_sweep, a jitted fori_loop, lets XLA contract the update: within
    4 ulps of the field's scale of it."""
    x, b = _fields(shape, dtype, 2)
    jp = _jproblem(shape, dtype, maf)
    msk = np.array(jp.msk)
    hidx = jstencil.hyperplane_index(shape)
    jx, m, jb = jnp.asarray(x), jnp.asarray(msk), jnp.asarray(b)
    for s in range(3, sum(shape) - 6 + 1):
        hm = m * (hidx == s)
        jx = jx + (jmaf.maf_delta(jx, jb, hm, OMEGA, jp.mc) if maf
                   else jstencil.jacobi_delta(jx, jb, hm, OMEGA))
    mc = _carry(jp.mc) if maf else None
    skew, unskew, _ = psor_scan.make_skew(shape)
    S, r2 = psor_scan.psor_diag_plain(skew(torch.from_numpy(x)),
                                      skew(torch.from_numpy(b)), OMEGA, mc)
    assert np.array_equal(unskew(S).numpy(), np.asarray(jx))
    if not maf:
        jit_x, _ = jstencil.psor_sweep(jnp.asarray(x), jb, m, OMEGA, hidx)
        ulp = float(np.finfo(dtype).eps) * float(np.abs(x).max())
        np.testing.assert_allclose(unskew(S).numpy(), np.asarray(jit_x),
                                   rtol=0, atol=4 * ulp)
    # the same sweep on the unskewed field
    y, r2u = stencil.psor_sweep(torch.from_numpy(x), torch.from_numpy(b),
                                torch.from_numpy(msk), OMEGA,
                                stencil.hyperplane_index(shape), mc)
    assert torch.equal(unskew(S), y) and torch.equal(r2, r2u)


@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", SHAPES)
def test_step_within_band_of_jax_diag_step(shape, dtype, maf):
    """One sweep of the port's step (the twin on the CPU) against the JAX
    package's make_psor_diag_step (the affine scan), within BAND."""
    x, b = _fields(shape, dtype, 3)
    jp = _jproblem(shape, dtype, maf)
    jstep = jps.make_psor_diag_step(shape, getattr(jnp, dtype), OMEGA,
                                    mc=jp.mc if maf else None)
    jS, jr2 = jax.jit(jstep)(jstep._pre(jnp.asarray(x)), jstep._pre(jnp.asarray(b)))
    step = psor_scan.make_psor_diag_step(shape, getattr(torch, dtype), OMEGA,
                                         mc=_carry(jp.mc) if maf else None)
    S, r2 = step(step.pad(torch.from_numpy(x)), step.pad(torch.from_numpy(b)))
    tol, rtol = BAND[dtype]
    scale = float(np.abs(x).max())
    np.testing.assert_allclose(step.unpad(S).numpy(),
                               np.asarray(jstep._post(jS)), rtol=0,
                               atol=tol * scale)
    assert float(r2) == pytest.approx(float(jr2), rel=rtol)
    assert r2.dtype == torch.float64


@functools.lru_cache(maxsize=None)
def _jax_solve(name, dtype, n=16):
    return jsolve(JProblem.poisson_cube(n, dtype=getattr(jnp, dtype),
                                        maf=name.endswith("_maf")),
                  name, omega=OMEGA, itr_max=4000, impl="jnp")


@pytest.mark.parametrize("dtype,iters", [("float32", 127), ("float64", 127)])
@pytest.mark.parametrize("name", ["psor", "psor_maf"])
def test_16_solve_gives_jax_count(name, dtype, iters):
    p = czt.Problem.poisson_cube(16, dtype=getattr(torch, dtype), device="cpu",
                                 maf=name.endswith("_maf"))
    r = czt.solve(p, name, omega=OMEGA, itr_max=4000)
    jr = _jax_solve(name, dtype)
    assert r.iters == jr.iters == iters and r.res < 1e-5
    rtol, m = (1e-3, r.iters - 1) if dtype == "float32" else (1e-6, r.iters)
    np.testing.assert_allclose(r.history[:m].numpy(),
                               np.asarray(jr.history)[:m], rtol=rtol)
    assert np.abs(r.x.numpy() - np.asarray(jr.x)).max() < (
        1e-5 if dtype == "float32" else 1e-12)


def test_32_f64_oracle_count_and_curve():
    ref = load("f64_psor_32_w1.1.txt")
    p = czt.Problem.poisson_cube(32, dtype=torch.float64, device="cpu")
    r = czt.solve(p, "psor", omega=OMEGA, itr_max=40000)
    assert len(ref) == 422
    assert abs(r.iters - len(ref)) <= max(1, len(ref) // 100)
    m = min(r.iters, len(ref))
    np.testing.assert_allclose(r.history[:m].numpy(), ref[:m], rtol=1e-6)


@pytest.mark.parametrize("name", ["psor", "psor_maf"])
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
    with pytest.raises(ValueError, match="standard cube inner mask"):
        czt.solve(q, "pbicgstab", omega=OMEGA, itr_max=4, precond=name)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pbicgstab_with_psor_converges_and_precon_is_jax_step_by_hand(dtype):
    """The preconditioner is 8 sweeps from zero in the step's own layout:
    the JAX package's diag step driven through its _pre/_post by hand
    (its bicgstab.py hands the unskewed vector to the skewed step
    instead, a fault of the reference package the port does not copy)."""
    tdt = getattr(torch, dtype)
    p = czt.Problem.poisson_cube(16, dtype=tdt, device="cpu")
    r = czt.solve(p, "pbicgstab", omega=OMEGA, itr_max=200, precond="psor")
    assert r.res < 1e-5 and 0 < r.iters < 20
    v, _ = _fields((16,) * 3, dtype, 4)
    v = v * p.msk.numpy()
    got = bicgstab.make_precon(p, "psor", OMEGA)(torch.from_numpy(v))
    jstep = jps.make_psor_diag_step((16,) * 3, getattr(jnp, dtype), OMEGA)
    run = jax.jit(jstep)
    S, B = jstep._pre(jnp.zeros((16,) * 3, getattr(jnp, dtype))), jstep._pre(v)
    for _ in range(bicgstab.PRECOND_SWEEPS):
        S, _ = run(S, B)
    tol = BAND[dtype][0] * float(np.abs(v).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(jstep._post(S)),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("name", ["psor", "psor_maf"])
def test_solve_dist_is_the_serial_solve_bit_for_bit(name):
    p = czt.Problem.poisson_cube(12, device="cpu", maf=name.endswith("_maf"))
    cm = make_mesh(p.grid.shape_kij, devices=["cpu"] * 8, div=(2, 2, 2))
    rd = czt.solve_dist(p, cm, name, omega=OMEGA, itr_max=4000)
    rs = czt.solve(p, name, omega=OMEGA, itr_max=4000)
    assert rd.iters == rs.iters > 0
    assert torch.equal(rd.x, rs.x) and torch.equal(rd.history, rs.history)


class _Counting:
    """A step whose r2 falls by 10x a call, counting its calls."""

    def __init__(self, every=None):
        self.calls = 0
        if every is not None:
            self.check_every_default = every

    def __call__(self, x, b):
        self.calls += 1
        return x + 1, torch.tensor(10.0 ** -x.max().item(), dtype=torch.float64)


@pytest.mark.parametrize("every,calls", [(None, 7), (1, 7), (5, 12)])
def test_run_iterative_honours_check_every_default(every, calls):
    """The chunk is the step's check_every_default where it has one (5:
    two chunks of 5, then the stopping chunk replayed to sweep 7), else
    the device default (1 on the CPU); the count is 7 either way."""
    step = _Counting(every)
    r = driver.run_iterative(step, torch.zeros(2, dtype=torch.float64), None,
                             1.0, 100, eps=10.0 ** -2.8)
    assert r.iters == 7 and step.calls == calls
    assert float(r.x.max()) == 7.0


@pytest.mark.parametrize("shape", [(128, 128, 128), (64, 64, 64), (3, 7, 5),
                                   (70, 140, 150), (512, 512, 512),
                                   (12, 9, 14), (1026, 1026, 1026)])
def test_plan_covers_every_row_once(shape):
    """P1's chunks cover the K - 2 inner rows once, none empty; each
    sweep's threads cover every line of the longest diagonal for every
    chunk; the CTAs of all the launch's sweeps stay within the card's
    co-resident ones (132 SMs of an H100, 1024 threads each), the sweeps
    shrinking from SWEEPS where they would not (256^3: 8), and only at one
    sweep the chunks growing past ROWS rows (512^3 holds two sweeps; 1026^3
    one, in chunks of 8 rows).  128^3: 32 chunks of 4 rows, 32 sweeps of 32
    CTAs of 128 threads, a CTA a chunk."""
    K, I, J = shape
    p = p1.plan(shape, max_ctas=132)
    n = K - 2
    cap = 132 * (p1.THREADS // p.threads)
    assert (p.chunks - 1) * p.rows < n <= p.chunks * p.rows
    assert p.lanes % 32 == 0 and p.lanes >= min(I - 2, J - 2)
    assert p.threads % 32 == 0 and p.grid == p.sweeps * p.per_sweep
    assert (p.per_sweep * p.threads >= p.chunks * p.lanes
            > (p.per_sweep - 1) * p.threads)
    assert p.grid <= cap and 1 <= p.sweeps <= p1.SWEEPS
    assert p.sweeps == p1.SWEEPS or (p.sweeps + 1) * p.per_sweep > cap
    assert p.rows == min(p1.ROWS, n) or (p.sweeps == 1 and shape[0] > 1000)
    if shape == (128, 128, 128):
        assert (p.chunks, p.rows, p.sweeps, p.per_sweep, p.threads, p.units) == (
            32, 4, 32, 32, 128, 1)
    if shape == (512, 512, 512):
        assert (p.sweeps, p.rows) == (2, 4)
    assert p1.plan(shape) == p or p.sweeps < p1.SWEEPS or p.rows > p1.ROWS


def test_cpu_wrapper_runs_the_twin_and_counts_nothing():
    x, b = _fields((10, 9, 11), "float32", 5)
    skew, _, _ = psor_scan.make_skew((10, 9, 11))
    S, B = skew(torch.from_numpy(x)), skew(torch.from_numpy(b))
    before = (p1.psor_diag.launches, p1.psor_diag.maf_launches)
    out, r2 = p1.psor_diag(S, B, OMEGA)
    ref, r2p = psor_scan.psor_diag_plain(S, B, OMEGA)
    assert torch.equal(out, ref) and torch.equal(r2, r2p)
    assert (p1.psor_diag.launches, p1.psor_diag.maf_launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        p1.PsorSweep(OMEGA)(S, B)
    with pytest.raises(TypeError):
        psor_scan.make_psor_diag_step((10, 9, 11), torch.float16, OMEGA)


# ---- P1's lagged schedule, replayed on the plain point update ----------------

TINY = [(3, 7, 5), (6, 5, 7), (12, 9, 14)]  # (K, I, J)


def _point_updates(shape, omega, dtype, tab):
    """``relax(S, B, d, k0, k1, lines)``: csrc/psor.cu's point update, one
    rounding an operation, over rows k0 ... k1 (upward) of the lines
    (i, d - i), i in ``lines``, of diagonal d, in place."""
    w = None if tab is None else rbpack.table_views(tab, shape)
    om = torch.tensor(omega, dtype=dtype)
    two = torch.tensor(2.0, dtype=dtype)

    def relax(S, B, d, k0, k1, i):
        j = d - i
        zm, cen = S[d, k0 - 1, i], S[d, k0, i]
        for k in range(k0, k1 + 1):
            xm, xp = S[d - 1, k, i - 1], S[d + 1, k, i + 1]
            ym, yp = S[d - 1, k, i], S[d + 1, k, i]
            zp, b = S[d, k + 1, i], B[d, k, i]
            if w is None:
                quo = (((((xm + xp) + ym) + yp) + zm) + zp - b) / 6
            else:
                r = w["wxp"][i] * xp + w["wxm"][i] * xm
                r = ((r + w["wyp"][j] * yp) + w["wym"][j] * ym)
                r = (r + w["wzp"][k] * zp) + w["wzm"][k] * zm
                quo = (r + b) / (two * ((w["c1"][i] + w["c2"][j]) + w["c3"][k]))
            x = cen + (quo - cen) * om
            S[d, k, i] = x
            zm, cen = x, zp

    return relax


def _lines_of(shape, d, slots):
    lo, hi = psor_scan.line_range(d, shape[1], shape[2])
    return torch.arange(lo, hi + 1)[slots]


# (rows a chunk, threads a CTA): one CTA a chunk, or eight of four lines
# each, as past 1024 lines
LAYOUTS = {"rows2": (2, None), "rows2_units": (2, 4), "rows1": (1, None)}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("sweeps", [1, 2, 3, 4])
@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", TINY)
def test_lagged_schedule_is_n_serial_sweeps(shape, dtype, maf, sweeps, layout,
                                            monkeypatch):
    """P1's launch of n sweeps, replayed task by task on the kernel's
    point update in place, leaves the field of n serial sweeps of the
    plain twin bit for bit: the CTAs of ``flag_waits`` run their diagonals
    in a random order that honours their counters, every task's inputs
    are done by all their CTAs when it runs, and nothing deadlocks."""
    tdt = getattr(torch, dtype)
    x, b = (torch.from_numpy(a) for a in _fields(shape, dtype, 11 + sweeps))
    skew, _, _ = psor_scan.make_skew(shape)
    S0, B = skew(x), skew(b)
    mc = (tmaf.MafCoeffs.from_coords(*(torch.linspace(0, 1, m, dtype=tdt) ** 1.3
                                       for m in (shape[1], shape[2], shape[0])))
          if maf else None)
    ref = S0
    for _ in range(sweeps):
        ref, _ = psor_scan.psor_diag_plain(ref, B, OMEGA, mc)
    rows, threads = LAYOUTS[layout]
    monkeypatch.setattr(p1, "ROWS", rows)
    p = p1.plan(shape, sweeps=sweeps)
    if threads is not None:
        p = dataclasses.replace(p, threads=threads)
    assert (p.rows, p.sweeps) == (min(rows, shape[0] - 2), sweeps)
    relax = _point_updates(shape, OMEGA, tdt, rbpack.maf_tables(mc, shape, tdt))
    S = S0.clone()
    rng = np.random.default_rng(sweeps)
    n = shape[0] - 2
    d_last = shape[1] + shape[2] - 4
    U, T = p.units, p.threads
    assert U == (1 if threads is None else 8)
    nxt = {(s, c, u): 2 for s in range(sweeps) for c in range(p.chunks)
           for u in range(U)}
    count = dict.fromkeys(((s, c) for s in range(sweeps)
                           for c in range(p.chunks)), 0)
    done = set()  # (s, d, c, u)
    while nxt:
        ready = [k for k in nxt if all(
            count[key] >= v for key, v in p1.flag_waits(p, shape, k[0], nxt[k], k[1]))]
        assert ready, "the counters deadlock"
        s, c, u = key = ready[rng.integers(len(ready))]
        d = nxt[key]
        for q in p1.inputs((s, d, c), p, shape):
            assert all((*q, v) in done for v in range(U))
        k0 = 1 + c * p.rows
        relax(S, B, d, k0, min(n, k0 + p.rows - 1),
              _lines_of(shape, d, slice(u * T, (u + 1) * T)))
        done.add((s, d, c, u))
        count[(s, c)] += 1
        nxt[key] += 1
        if nxt[key] > d_last:
            del nxt[key]
    assert len(done) == sweeps * (d_last - 1) * p.chunks * U
    assert torch.equal(S, ref)


def test_plan_sweeps_shrink_before_chunks_grow():
    """Past the card's co-resident CTAs the sweeps of a launch shrink, and
    only at one sweep do the chunks grow; a launcher refuses sweeps its
    card cannot hold (``sweeps_for`` picks what fits)."""
    p = p1.plan((128,) * 3, max_ctas=132, sweeps=64)
    assert p.rows == p1.ROWS and p.grid * p.threads <= 132 * p1.THREADS
    assert 1 < p.sweeps < 64 and p.per_sweep * p.threads >= p.chunks * p.lanes
    q = p1.plan((600, 1026, 1026), max_ctas=132, sweeps=4)
    assert q.sweeps == 1 and q.rows > p1.ROWS and q.chunks * q.lanes <= 132 * p1.THREADS
    with pytest.raises(ValueError, match="at least one sweep"):
        p1.PsorSweep(OMEGA, sweeps=0)


@pytest.mark.parametrize("maf", [False, True])
def test_multi_sweep_launcher_refuses_cpu_tensors(maf):
    """The twin runs one sweep a call: a launcher of several sweeps given
    CPU tensors raises rather than run one and report it as several."""
    shape = (10, 9, 11)
    x, b = _fields(shape, "float32", 6)
    skew, _, _ = psor_scan.make_skew(shape)
    S, B = skew(torch.from_numpy(x)), skew(torch.from_numpy(b))
    mc = czt.Problem.poisson_cube(10, device="cpu", maf=True).mc if maf else None
    before = S.clone()
    with pytest.raises(ValueError, match="4 sweeps needs a CUDA tensor"):
        p1.psor_diag(S, B, OMEGA, mc, launcher=p1.PsorSweep(OMEGA, mc, sweeps=4))
    assert torch.equal(S, before)


def test_cpu_step_runs_one_sweep_a_call():
    """On the CPU the step is the twin, one sweep a call: iters_per_call 1
    and its own single, whatever the preconditioner asks."""
    for divides in (None, 8):
        step = psor_scan.make_psor_diag_step((10, 9, 11), torch.float32, OMEGA,
                                             device="cpu", divides=divides)
        assert step.iters_per_call == 1 and step.single is step
