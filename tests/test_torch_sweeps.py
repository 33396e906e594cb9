"""The port's unpacked sweep K4 against the JAX package's: the plain twins
bitwise equal to the interpreted Pallas kernel (make_fused_sweep) for
jacobi and sor2sma, constant and MAF, with and without b, even and odd I,
after three calls (residuals to rtol 1e-5: the JAX kernel sums per tile in
float32); jacobi and jacobi_maf solves against the oracle histories; the
state layout and the out-of-place Jacobi step."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubez_tpu import Problem as JProblem
from cubez_tpu.ops import stencil as jstencil
from cubez_tpu.pallas_kernels import sweeps as jsw

import cubez_tpu_torch as czt
from cubez_tpu_torch.cuda_kernels import sweeps as tsw
from cubez_tpu_torch.ops import maf as tmaf
from cubez_tpu_torch.ops import stencil
from cubez_tpu_torch.solvers import driver
from cubez_tpu_torch.solvers.fused_cache import get_fused_step

torch.set_num_threads(1)

HIST = pathlib.Path(__file__).resolve().parent / "ref_histories"


def load(name):
    rows = (HIST / name).read_text().splitlines()[1:]
    return np.array([float(ln.split(",")[1]) for ln in rows])


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    return x, b


def _mc(shape):
    """(JAX MafCoeffs, the port's carried across) of a stretched grid."""
    K, I, J = shape
    jp, _ = JProblem.manufactured_stretched((I, J, K), dtype=jnp.float32)
    tmc = tmaf.MafCoeffs.from_numpy(
        *(np.asarray(getattr(jp.mc, f)) for f in tmaf.FIELDS), device="cpu")
    return jp.mc, tmc


@pytest.mark.parametrize("shape", [(12, 10, 16), (13, 11, 16)])
@pytest.mark.parametrize("with_b", [False, True])
@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("kind", ["jacobi", "sor2sma"])
def test_k4_twin_bitwise_vs_jax(kind, maf, with_b, shape):
    """K4: sweeps.make_fused_sweep (interpret) against the port's twin on
    the same seeded fields, a call of each an iteration (the port's jacobi
    step's single form; test_torch_k4_tile.py holds its n-iteration
    calls); odd I is (13, 11, 16)."""
    jmc, tmc = _mc(shape) if maf else (None, None)
    x, b = _fields(shape, 7 + shape[1])
    omega = 0.8 if kind == "jacobi" else 1.5
    jstep = jax.jit(jsw.make_fused_sweep(
        kind, shape, jnp.float32, omega=omega, b_is_zero=not with_b, mc=jmc,
        interpret=True))
    tstep = tsw.make_fused_sweep(kind, shape, torch.float32, omega=omega,
                                 b_is_zero=not with_b, mc=tmc).single
    xj, bj = jsw.pad_k2(jnp.asarray(x)), jsw.pad_k2(jnp.asarray(b))
    xt, bt = tstep.pad(torch.tensor(x)), tstep.pad(torch.tensor(b))
    for _ in range(3):
        xj, rj = jstep(xj, bj)
        xt, rt = tstep(xt, bt)
        np.testing.assert_array_equal(np.asarray(jsw.unpad_k2(xj, shape)),
                                      tstep.unpad(xt).numpy())
        np.testing.assert_allclose(float(rt), float(rj), rtol=1e-5)


@pytest.mark.parametrize("maf", [False, True])
def test_k4_red_black_offset_1_bitwise_vs_jax(maf):
    """The colour offset (the checkerboard of a block starting on an odd
    global index) moves the colours as the JAX kernel's _iota_masks do."""
    shape = (12, 10, 16)
    jmc, tmc = _mc(shape) if maf else (None, None)
    x, b = _fields(shape, 17)
    jstep = jax.jit(jsw.make_fused_sweep(
        "sor2sma", shape, jnp.float32, omega=1.5, offset=1, mc=jmc,
        interpret=True))
    tstep = tsw.make_fused_sweep("sor2sma", shape, torch.float32, omega=1.5,
                                 offset=1, mc=tmc)
    xj, _ = jstep(jsw.pad_k2(jnp.asarray(x)), jsw.pad_k2(jnp.asarray(b)))
    xt, _ = tstep(tstep.pad(torch.tensor(x)), tstep.pad(torch.tensor(b)))
    np.testing.assert_array_equal(np.asarray(jsw.unpad_k2(xj, shape)),
                                  xt.numpy())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["jacobi", "jacobi_maf"])
def test_jacobi_32_matches_oracle(name, dtype):
    """Through solve() on K4's twin: the oracle's 1015 iterations and the
    bands of tests/test_ref_parity.py (f64 curve to rtol 1e-6, f32 to 1e-3
    but for the last entry)."""
    ref = load(f"{dtype[:1]}{dtype[-2:]}_{name}_32_w0.8.txt")
    assert len(ref) == 1015
    prob = czt.Problem.poisson_cube(32, dtype=getattr(torch, dtype),
                                    device="cpu", maf=name.endswith("_maf"))
    r = czt.solve(prob, name, omega=0.8, itr_max=40000)
    assert r.iters == 1015
    rtol, m = (1e-6, r.iters) if dtype == "float64" else (1e-3, r.iters - 1)
    np.testing.assert_allclose(r.history[:m].numpy(), ref[:m], rtol=rtol)
    assert r.x.shape == (32, 32, 32) and bool(torch.isfinite(r.x).all())


def test_jacobi_step_never_writes_its_input():
    """Jacobi is out of place: the driver's snapshot, handed to the step in
    the stopping-chunk replay, must come back untouched."""
    prob = czt.Problem.poisson_cube(12, device="cpu")
    step = get_fused_step("jacobi", prob.grid, 0.8, b_is_zero=True)
    x = step.pad(prob.x0)
    keep = x.clone()
    x1, _ = step(x, None)
    assert torch.equal(x, keep) and not torch.equal(x1, x)
    assert x1.data_ptr() != x.data_ptr()
    runs = [czt.solve(prob, "jacobi", omega=0.8, itr_max=300, check_every=c)
            for c in (1, 16)]
    assert runs[0].iters == runs[1].iters
    assert torch.equal(runs[0].x, runs[1].x)
    assert torch.equal(runs[0].history, runs[1].history)


def test_k4_twins_match_unpacked_stencil():
    """K4's fma twins against the true-division plain sweeps of
    ops/stencil.py: equal to float32 roundoff."""
    shape = (14, 13, 18)
    x, b = _fields(shape, 27)
    p = czt.Problem.from_arrays(shape, torch.float32, x, b, device="cpu")
    cm = stencil.color_masks(shape, 0, torch.float32)
    for kind in ("jacobi", "sor2sma"):
        step = tsw.make_fused_sweep(kind, shape, torch.float32,
                                    omega=0.9).single
        xu, xk = p.x0, step.pad(p.x0)
        for _ in range(3):
            if kind == "jacobi":
                xu, ru = stencil.jacobi_sweep(xu, p.rhs, p.msk, 0.9)
            else:
                xu, ru = stencil.sor2sma_sweep(xu, p.rhs, p.msk, 0.9, cm)
            xk, rk = step(xk, p.rhs)
            np.testing.assert_allclose(xk.numpy(), xu.numpy(), atol=2e-6)
            np.testing.assert_allclose(float(rk), float(ru), rtol=1e-5)


def test_plain_jacobi_sweep_matches_jax():
    """ops/stencil.jacobi_sweep against the JAX package's (same formula)."""
    shape = (12, 14, 10)
    x, b = _fields(shape, 37)
    jp = JProblem.poisson_cube((14, 10, 12), dtype=jnp.float32)
    tp = czt.Problem.poisson_cube((14, 10, 12), device="cpu")
    xj, rj = jax.jit(lambda x, b: jstencil.jacobi_sweep(x, b, jp.msk, 0.8))(
        jnp.asarray(x), jnp.asarray(b))
    xt, rt = stencil.jacobi_sweep(torch.tensor(x), torch.tensor(b), tp.msk, 0.8)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(rt), float(rj), rtol=1e-5)


def test_state_layout_and_builder_contract():
    shape = (9, 7, 11)
    x, _ = _fields(shape, 47)
    xt = torch.tensor(x)
    s = tsw.pad_k2(xt)
    assert s.is_contiguous() and s.data_ptr() != xt.data_ptr()
    assert torch.equal(tsw.unpad_k2(s, shape), xt)
    with pytest.raises(ValueError, match="shape"):
        tsw.unpad_k2(s, (9, 7, 12))
    for kind in tsw.KINDS:
        step = tsw.make_fused_sweep(kind, shape, omega=1.0)
        calls = tsw.JACOBI_N if kind == "jacobi" else 1
        assert step.iters_per_call == calls and step.single.iters_per_call == 1
        assert (step.single is step) == (calls == 1)
    with pytest.raises(ValueError, match="kind"):
        tsw.make_fused_sweep("psor", shape, omega=1.0)
    with pytest.raises(TypeError):
        tsw.make_fused_sweep("jacobi", shape, torch.float16, omega=1.0)
    before = (tsw.jacobi_k4.launches, tsw.sor2sma_k4.launches)
    tsw.jacobi_k4(xt, None, 0.8)
    tsw.sor2sma_k4(xt.clone(), None, 1.5)
    assert (tsw.jacobi_k4.launches, tsw.sor2sma_k4.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        tsw._check(xt, None, None)


def test_odd_i_dispatch_takes_k4():
    g = czt.Problem.poisson_cube((15, 16, 16), device="cpu").grid
    for mc in (None, czt.Problem.poisson_cube((15, 16, 16), device="cpu",
                                              maf=True).mc):
        step = get_fused_step("sor2sma", g, 1.5, mc=mc, b_is_zero=True)
        assert step.pad is tsw.pad_k2
    assert get_fused_step("jacobi", g, 0.8).pad is tsw.pad_k2
    x = driver.fixed_sweeps(get_fused_step("sor2sma", g, 1.5), tsw.pad_k2(
        czt.Problem.poisson_cube((15, 16, 16), device="cpu").x0), None, 3)
    assert bool(torch.isfinite(x).all())
