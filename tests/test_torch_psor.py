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
    """P1's chunks cover the K - 2 inner rows once, none empty; the threads
    cover every line of the longest diagonal for every chunk; the CTAs stay
    within the card's co-resident ones (132 on an H100), chunks growing
    past ROWS rows where they would not (1026^3; 128^3: 63 chunks of 2 rows
    on 8 CTAs, 313 phases)."""
    K, I, J = shape
    p = p1.plan(shape, max_ctas=132)
    n = K - 2
    assert (p.chunks - 1) * p.rows < n <= p.chunks * p.rows
    assert p.lanes % 32 == 0 and p.lanes >= min(I - 2, J - 2)
    assert p.grid * p1.THREADS >= p.chunks * p.lanes > (p.grid - 1) * p1.THREADS
    assert p.grid <= 132
    assert p.rows == min(p1.ROWS, n) or shape == (1026, 1026, 1026)
    if shape == (128, 128, 128):
        assert (p.chunks, p.rows, p.grid) == (63, 2, 8)  # 313 phases
    assert p1.plan(shape) == p or p.grid == 132 or shape[0] > 1000


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
