"""The port's line solvers against the JAX package's, on the CPU: the
Thomas line solve of the kernels' twins against the JAX package's Thomas,
dense T^-1 d and fast-diagonalization forms in float64; K6's twins (pcr_j
and red-black at odd I) against the interpreted Pallas kernel
make_line_step and the jnp step after two sweeps (the bands of
tests/test_lines.py: field rtol 2e-5 / atol 2e-6, r2 rtol 2e-4); the
masked twins against the jnp step; the 32^3 solves against the oracle
histories and the JAX package's solve; the dispatch."""

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
from cubez_tpu.ops import fastdiag as jfd
from cubez_tpu.ops import tdma as jtdma
from cubez_tpu.pallas_kernels import lines as jl
from cubez_tpu.solvers.steps import make_step as j_make_step

import cubez_tpu_torch as czt
from cubez_tpu_torch.cuda_kernels import lines as tl
from cubez_tpu_torch.cuda_kernels import rblines as trbl
from cubez_tpu_torch.cuda_kernels import sweeps as tsw
from cubez_tpu_torch.cuda_kernels.rbpack import maf_tables
from cubez_tpu_torch.ops import maf as tmaf
from cubez_tpu_torch.solvers.fused_cache import get_fused_step
from cubez_tpu_torch.solvers.steps import make_step

torch.set_num_threads(1)

HIST = pathlib.Path(__file__).resolve().parent / "ref_histories"
F64 = torch.float64


def load(name):
    rows = (HIST / name).read_text().splitlines()[1:]
    return np.array([float(ln.split(",")[1]) for ln in rows])


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    return x, b


def _line_solution(shape, d, tab=None):
    """The twins' Thomas solve of every inner line, read through relax_dp
    with x = 0 and omega = 1: dp is the solution.  ``d`` (K-2, I-2, J-2)
    is the line right-hand side; b is chosen to produce it."""
    x = torch.zeros(shape, dtype=F64)
    b = torch.zeros(shape, dtype=F64)
    # const: d = (0 - b) * R6; MAF: d = 0 - b
    b[1:-1, 1:-1, 1:-1] = -torch.tensor(d) * (6.0 if tab is None else 1.0)
    return tl.relax_dp(x, b, 1.0, tab).numpy()


def test_thomas_line_solve_vs_const_line_inverse():
    """JAX's test_const_line_inverse_vs_thomas, mirrored: the twin's solve
    equals T^-1 d and the JAX package's Thomas solve in float64."""
    shape = (32, 4, 5)
    n = shape[0] - 2
    d = np.random.default_rng(0).standard_normal((n, 2, 3))
    got = _line_solution(shape, d)
    Ti = jfd.const_line_inverse(n, np.float64)
    want = np.einsum("kl,lij->kij", Ti, d)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got, np.asarray(jtdma.tdma_unit_offdiag(
        jnp.asarray(d))), rtol=1e-12, atol=1e-14)


def test_thomas_line_solve_vs_maf_fastdiag():
    """JAX's test_maf_fastdiag_vs_thomas and test_maf_fastdiag_stretched_grid,
    mirrored: on stretched coordinates every line's Thomas solve equals
    V ((V^-1 d) / (mu + lambda_ij)) in float64."""
    shape = (32, 6, 7)
    K, I, J = shape
    n = K - 2
    mc = czt.Problem.manufactured_stretched((I, J, K), dtype=F64,
                                            device="cpu")[0].mc
    d = np.random.default_rng(1).standard_normal((n, I - 2, J - 2))
    got = _line_solution(shape, d, maf_tables(mc, shape, F64))
    V, Vi, mu = jfd.maf_line_diag(mc, n, np.float64)
    lam = jfd.maf_lambda_table(mc, I, J, np.float64)
    for i in range(1, I - 1):
        for j in range(1, J - 1):
            want = V @ ((Vi @ d[:, i - 1, j - 1]) / (mu + lam[i, j]))
            np.testing.assert_allclose(got[:, i - 1, j - 1], want, rtol=1e-10,
                                       atol=1e-12)


LINE_SHAPE = (18, 17, 16)  # (K, I, J): odd I, where the dispatch takes K6


@functools.lru_cache(maxsize=None)
def _jax_problem(maf):
    """(JAX problem, port MafCoeffs or None) at LINE_SHAPE: the stretched
    grid's coefficients carried across for MAF, the cube otherwise."""
    K, I, J = LINE_SHAPE
    if not maf:
        return JProblem.poisson_cube((I, J, K), dtype=jnp.float32), None
    jp, _ = JProblem.manufactured_stretched((I, J, K), dtype=jnp.float32)
    return jp, tmaf.MafCoeffs.from_numpy(
        *(np.asarray(getattr(jp.mc, f)) for f in tmaf.FIELDS), device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_steps(kind, maf, omega):
    """The interpreted make_line_step (streaming b) and the jitted jnp step,
    built once and shared by the zero-b and streamed-b cases."""
    jp, _ = _jax_problem(maf)
    jstep = jl.make_line_step(kind, LINE_SHAPE, omega=omega,
                              mc=jp.mc if maf else None, b_is_zero=False,
                              interpret=True)
    name = ("pcr_j_esa" if kind == "pcr_j" else "pcr_rb") + ("_maf" if maf else "")
    return jstep, jax.jit(j_make_step(jp, name, omega))


@pytest.mark.parametrize("with_b", [False, True])
@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("kind", ["pcr_j", "pcr_rb"])
def test_line_twin_vs_jax_kernel_and_jnp(kind, maf, with_b):
    """Two sweeps of K6's twin against the interpreted make_line_step and
    the JAX package's jnp step (pcr_j_esa / pcr_rb and their _maf forms),
    at odd I.  Without b the port's step is built with b_is_zero and handed
    a random b, which it must ignore; the JAX side gets zeros."""
    omega = 1.0 if kind == "pcr_j" else 1.5
    _, tmc = _jax_problem(maf)
    jstep, ref = _jax_steps(kind, maf, omega)
    x, b = _fields(LINE_SHAPE, 41 + 4 * maf + 2 * with_b + (kind == "pcr_rb"))
    tstep = tl.make_line_step(kind, LINE_SHAPE, torch.float32, omega=omega,
                              mc=tmc, b_is_zero=not with_b)
    bj = jnp.asarray(b if with_b else np.zeros_like(b))
    xj, bjl = jl.to_line4_layout(jnp.asarray(x)), jl.to_line4_layout(bj)
    xt, btp = tstep.pad(torch.tensor(x)), tstep.pad(torch.tensor(b))
    xr = jnp.asarray(x)
    for _ in range(2):
        xj, rj = jstep(xj, bjl)
        xt, rt = tstep(xt, btp)
        xr, rr = ref(xr, bj)
    ft = tstep.unpad(xt).numpy()
    for fj, r in ((np.asarray(jl.from_line4_layout(xj, LINE_SHAPE)), rj),
                  (np.asarray(xr), rr)):
        np.testing.assert_allclose(ft, fj, rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(float(rt), float(r), rtol=2e-4)


@functools.lru_cache(maxsize=None)
def _jax_cube(maf):
    """The JAX package's float32 32^3 cube, made once per file (its MAF
    coefficients take seconds to build on the CPU)."""
    return JProblem.poisson_cube(32, dtype=jnp.float32, maf=maf)


# (name, omega, f32 history, f64 history): the oracle's 140, 140 and 624
LINE_SOLVES = [("pcr_rb", 1.5, 140), ("pcr_rb_maf", 1.5, 140),
               ("pcr_j_esa", 1.0, 624)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name,omega,iters", LINE_SOLVES)
def test_line_solvers_32_match_oracle(name, omega, iters, dtype):
    """Through solve() on the twins: f64 count +-1% and curve rtol 1e-6,
    f32 +-2% and 1e-3 but for the last entry (the 32^3 f32 oracle's float
    sums stay inside 1e-3 of the port's float64 fold), and the JAX
    package's jnp solve's count."""
    ref = load(f"{dtype[:1]}{dtype[-2:]}_{name}_32_w{omega}.txt")
    assert len(ref) == iters
    maf = name.endswith("_maf")
    prob = czt.Problem.poisson_cube(32, dtype=getattr(torch, dtype),
                                    device="cpu", maf=maf)
    r = czt.solve(prob, name, omega=omega, itr_max=10000)
    band, rtol, m = ((iters // 100, 1e-6, min(r.iters, iters))
                     if dtype == "float64" else
                     (iters // 50, 1e-3, min(r.iters, iters) - 1))
    assert abs(r.iters - iters) <= max(1, band)
    np.testing.assert_allclose(r.history[:m].numpy(), ref[:m], rtol=rtol)
    assert r.x.shape == (32, 32, 32) and bool(torch.isfinite(r.x).all())
    if dtype == "float32":
        rj = jsolve(_jax_cube(maf), name, omega=omega, itr_max=10000,
                    impl="jnp")
        assert abs(r.iters - rj.iters) <= 1


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append(name)
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_line_dispatch_follows_jax_order(monkeypatch):
    """pcr_rb: K5 at even I, K6's red-black form at odd I; pcr_j_esa: K6's
    line-Jacobi; each with its own pad/unpad; no step where K - 2 < 2."""
    rb = _spy(monkeypatch, tl, "line_rb_plain")
    lj = _spy(monkeypatch, tl, "line_j_plain")
    k5 = _spy(monkeypatch, trbl, "rbl_plain")
    for n, kind, want, pad in (
        (16, "pcr_rb", k5, trbl.pack_rb_lines),
        ((15, 16, 16), "pcr_rb", rb, tsw.pad_k2),
        (16, "pcr", lj, tsw.pad_k2),
    ):
        for maf in (False, True):
            p = czt.Problem.poisson_cube(n, device="cpu", maf=maf)
            step = get_fused_step(kind, p.grid, 1.0, mc=p.mc, b_is_zero=True)
            assert getattr(step.pad, "func", step.pad) is pad
            assert step.iters_per_call == 1 and step.single is step
            before = len(rb) + len(lj) + len(k5)
            xs, _ = step(step.pad(p.x0), None)
            assert len(want) == 1 and len(rb) + len(lj) + len(k5) == before + 1
            want.clear()
            assert step.unpad(xs).shape == p.x0.shape
    thin = czt.Problem.poisson_cube((8, 8, 3), device="cpu")
    assert get_fused_step("pcr_rb", thin.grid, 1.5) is None
    r = czt.solve(thin, "pcr_rb", omega=1.5, itr_max=5)  # make_step's twin
    assert r.iters == 5 and len(rb) == 5 and not (lj or k5)


@pytest.mark.parametrize("name,omega", [("pcr_rb", 1.5), ("pcr_rb_maf", 1.5),
                                        ("pcr_j_esa", 1.0)])
def test_masked_line_step_matches_jax_jnp(name, omega):
    """A mask with a hole runs the line twins with the mask (on the CPU):
    two steps against the JAX package's jnp step, and solve() takes it."""
    maf = name.endswith("_maf")
    jp = _jax_cube(maf)
    msk = np.asarray(jp.msk).copy()
    msk[5:8, 6, 7] = 0.0  # an obstacle: three nodes held at x0
    jp = dataclasses.replace(jp, msk=jnp.asarray(msk))
    shape = jp.grid.shape_kij
    x, b = _fields(shape, 53)
    tmc = None
    if maf:
        tmc = tmaf.MafCoeffs.from_numpy(
            *(np.asarray(getattr(jp.mc, f)) for f in tmaf.FIELDS), device="cpu")
    tp = czt.Problem.from_arrays(shape, torch.float32, x, b, msk=msk,
                                 device="cpu", mc=tmc)
    assert not tp.msk_is_standard()
    jstep = jax.jit(j_make_step(jp, name, omega))
    tstep = make_step(tp, name, omega)
    xj, xt = jnp.asarray(x), tp.x0
    for _ in range(2):
        xj, rj = jstep(xj, jnp.asarray(b))
        xt, rt = tstep(xt, tp.rhs)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(float(rt), float(rj), rtol=2e-4)
    np.testing.assert_array_equal(xt.numpy()[5:8, 6, 7], x[5:8, 6, 7])
    r = czt.solve(tp, name, omega=omega, itr_max=3)
    assert r.iters == 3 and bool(torch.isfinite(r.x).all())
