"""The port's MAF (variable-coefficient) pieces against the JAX package:
the metric tables bit for bit, the arithmetic contract of the MAF update
(pinned against the interpreted kernel), the packed MAF plain twins bitwise
equal to the interpreted Pallas kernels K1/K2/K3 after three calls (the
residuals to rtol 1e-5: per-tile partial sums group differently), the
unpacked plain sweeps per sweep, and sor2sma_maf solves against the oracle
histories and the h^2 band of tests/test_maf_stretched.py."""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubez_tpu import Problem as JProblem
from cubez_tpu.ops import maf as jmaf
from cubez_tpu.ops import stencil as jstencil
from cubez_tpu.pallas_kernels import rbpack as jrb
from cubez_tpu.pallas_kernels import sweeps as jsw

import cubez_tpu_torch as czt
from cubez_tpu_torch.cuda_kernels import rbpack as trb
from cubez_tpu_torch.cuda_kernels import sweeps as tsw
from cubez_tpu_torch.ops import maf as tmaf
from cubez_tpu_torch.ops import stencil

torch.set_num_threads(1)

OMEGA = 1.5
HIST = pathlib.Path(__file__).resolve().parent / "ref_histories"


def load(name):
    rows = (HIST / name).read_text().splitlines()[1:]
    return np.array([float(ln.split(",")[1]) for ln in rows])


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    return x, b


def _carry(jmc):
    """The JAX package's MafCoeffs carried across to the port."""
    return tmaf.MafCoeffs.from_numpy(
        *(np.asarray(getattr(jmc, f)) for f in tmaf.FIELDS), device="cpu")


@functools.lru_cache(maxsize=None)
def _jstretched(n, dtype):
    """The JAX package's stretched problem, built once per (n, dtype): its
    eager construction compiles for each new shape."""
    return JProblem.manufactured_stretched(n, dtype=getattr(jnp, dtype))


def _stretched_mc(n):
    jp, _ = _jstretched(n, "float32")
    return jp.mc, _carry(jp.mc)


RAGGED = (11, 16, 13)  # (I, J, K) of the ragged stretched grid


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("grid", ["uniform", "stretched"])
def test_maf_coeffs_bitwise_equal_to_jax(grid, dtype):
    """from_coords on the port's own grid, and from_numpy, give JAX's
    tables bit for bit, and so do the pivot and the stretched RHS."""
    if grid == "uniform":
        jp = JProblem.poisson_cube((12, 10, 14), dtype=getattr(jnp, dtype),
                                   maf=True)
        tp = czt.Problem.poisson_cube((12, 10, 14), dtype=getattr(torch, dtype),
                                      device="cpu", maf=True)
    else:
        jp, ju = _jstretched(RAGGED, dtype)
        tp, tu = czt.Problem.manufactured_stretched(
            RAGGED, dtype=getattr(torch, dtype), device="cpu")
        np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
        np.testing.assert_array_equal(np.asarray(jp.rhs), tp.rhs.numpy())
    carried = _carry(jp.mc)
    for f in tmaf.FIELDS:
        a = np.asarray(getattr(jp.mc, f))
        for mc in (tp.mc, carried):
            b = getattr(mc, f).numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(np.asarray(jp.pvt), tp.pvt.numpy())
    for w in ("wxp", "wxm", "wyp", "wym", "wzp", "wzm", "dd"):
        np.testing.assert_array_equal(np.asarray(getattr(jp.mc, w)),
                                      getattr(tp.mc, w).numpy(), err_msg=w)


def test_maf_contraction_matches_interpreted_kernel():
    """The MAF update of the interpreted K4 (and so of the kernels) is
    r = fma(wzm, zm, round(wzp * zp)), then fma for x+, x-, y+, y-, then
    (r / dd - centre) * omega.  The other order of the first two terms,
    and the chain without fma, give other fields on the same inputs."""
    shape = (16, 16, 16)
    jmc, tmc = _stretched_mc(16)
    x, _ = _fields(shape, 61)
    step = jax.jit(jsw.make_fused_sweep("jacobi", shape, jnp.float32,
                                        omega=OMEGA, b_is_zero=True, mc=jmc,
                                        interpret=True))
    xj, _ = step(jsw.pad_k2(jnp.asarray(x)), jsw.pad_k2(jnp.asarray(x)))
    want = np.asarray(jsw.unpad_k2(xj, shape))[1:-1, 1:-1, 1:-1]

    xt = torch.tensor(x)
    t = trb.table_views(trb.maf_tables(tmc, shape, torch.float32), shape)
    zi, xi, yi = (slice(1, -1), None, None), (None, slice(1, -1), None), slice(1, -1)
    w = {"wzm": t["wzm"][zi], "wzp": t["wzp"][zi], "wxp": t["wxp"][xi],
         "wxm": t["wxm"][xi], "wyp": t["wyp"][yi], "wym": t["wym"][yi]}
    nb = {"zm": xt[:-2, 1:-1, 1:-1], "zp": xt[2:, 1:-1, 1:-1],
          "xm": xt[1:-1, :-2, 1:-1], "xp": xt[1:-1, 2:, 1:-1],
          "ym": xt[1:-1, 1:-1, :-2], "yp": xt[1:-1, 1:-1, 2:]}
    cen = xt[1:-1, 1:-1, 1:-1]
    dd = 2.0 * ((t["c1"][xi] + t["c2"][yi]) + t["c3"][zi])
    om = torch.tensor(OMEGA, dtype=torch.float32)

    def finish(r):
        return (cen + (r / dd - cen) * om).numpy()

    r = trb._fma(w["wzm"], nb["zm"], w["wzp"] * nb["zp"])
    for a in ("xp", "xm", "yp", "ym"):
        r = trb._fma(w["w" + a], nb[a], r)
    np.testing.assert_array_equal(finish(r), want)
    np.testing.assert_array_equal(finish(trb.maf_r(w, nb)), want)

    swapped = trb._fma(w["wzp"], nb["zp"], w["wzm"] * nb["zm"])
    for a in ("xp", "xm", "yp", "ym"):
        swapped = trb._fma(w["w" + a], nb[a], swapped)
    unfused = w["wzm"] * nb["zm"] + w["wzp"] * nb["zp"]
    for a in ("xp", "xm", "yp", "ym"):
        unfused = unfused + w["w" + a] * nb[a]
    assert (finish(swapped) != want).sum() > 0
    assert (finish(unfused) != want).sum() > 0


def _packed_run(jstep, tstep, x, b, offset, calls):
    shape = x.shape
    xj, bj = jrb.pack_rb(jnp.asarray(x), offset), jrb.pack_rb(jnp.asarray(b), offset)
    xt, bt = trb.pack_rb(torch.tensor(x), offset), trb.pack_rb(torch.tensor(b), offset)
    jstep = jax.jit(jstep)
    for _ in range(calls):
        xj, rj = jstep(xj, bj)
        xt, rt = tstep(xt, bt)
        np.testing.assert_array_equal(
            np.asarray(jrb.unpack_rb(xj, shape, offset)),
            trb.unpack_rb(xt, shape, offset).numpy(),
        )
        np.testing.assert_allclose(
            np.atleast_1d(rt.numpy()), np.atleast_1d(np.asarray(rj)), rtol=1e-5
        )


@pytest.mark.parametrize("with_b", [False, True])
@pytest.mark.parametrize("offset", [0, 1])
def test_packed_maf_single_bitwise_vs_jax(offset, with_b):
    """K1-MAF: rbpack.make_packed_sweep(mc=...) (interpret, kt=4) on the
    stretched grid's tables at 16^3."""
    shape = (16, 16, 16)
    jmc, tmc = _stretched_mc(16)
    x, b = _fields(shape, 71 + offset)
    jstep = jrb.make_packed_sweep(shape, jnp.float32, omega=OMEGA, kt=4,
                                  offset=offset, b_is_zero=not with_b,
                                  mc=jmc, interpret=True)
    tstep = trb.make_packed_sweep(shape, torch.float32, omega=OMEGA,
                                  offset=offset, b_is_zero=not with_b,
                                  mc=tmc)
    _packed_run(jstep, tstep, x, b, offset, calls=3)


@pytest.mark.parametrize("with_b", [False, True])
def test_packed_maf_pair_bitwise_vs_jax(with_b):
    """K2-MAF: rbpack.make_packed_sweep2x(mc=...) (interpret, kt=8)."""
    shape = (16, 16, 16)
    jmc, tmc = _stretched_mc(16)
    x, b = _fields(shape, 81)
    jstep = jrb.make_packed_sweep2x(shape, jnp.float32, omega=OMEGA, kt=8,
                                    b_is_zero=not with_b, mc=jmc,
                                    interpret=True)
    tstep = trb.make_packed_sweep2x(shape, torch.float32, omega=OMEGA,
                                    b_is_zero=not with_b, mc=tmc)
    assert tstep.iters_per_call == 2
    _packed_run(jstep, tstep, x, b, 0, calls=3)


def test_packed_maf_window_chain_n3_bitwise_vs_jax():
    """K3-MAF: rbpack.make_packed_sweepnx(n=3, kt=8, mc=...), zero RHS."""
    shape = (16, 16, 16)
    jmc, tmc = _stretched_mc(16)
    x, b = _fields(shape, 91)
    jstep = jrb.make_packed_sweepnx(shape, jnp.float32, omega=OMEGA, n=3,
                                    kt=8, mc=jmc, interpret=True)
    tstep = trb.make_packed_sweepnx(shape, torch.float32, omega=OMEGA, n=3,
                                    mc=tmc)
    assert tstep.iters_per_call == 3
    _packed_run(jstep, tstep, x, b, 0, calls=3)


def test_packed_and_unpacked_maf_twins_agree():
    """The packed MAF twin and K4's unpacked MAF twin compute the same
    per-point chain: bitwise equal fields."""
    shape = (16, 16, 16)
    _, mc = _stretched_mc(16)
    x, b = _fields(shape, 101)
    ps = trb.make_packed_sweep(shape, torch.float32, omega=OMEGA, mc=mc)
    us = tsw.make_fused_sweep("sor2sma", shape, torch.float32, omega=OMEGA,
                              mc=mc)
    xp, bp = ps.pad(torch.tensor(x)), ps.pad(torch.tensor(b))
    xu, bu = us.pad(torch.tensor(x)), us.pad(torch.tensor(b))
    for _ in range(3):
        xp, rp = ps(xp, bp)
        xu, ru = us(xu, bu)
        assert torch.equal(ps.unpad(xp), us.unpad(xu))
        torch.testing.assert_close(rp, ru, rtol=1e-12, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["jacobi", "sor2sma"])
def test_plain_maf_sweeps_match_jax_ops(kind, dtype):
    """ops/maf.py's unpacked sweeps against the JAX package's: XLA
    contracts its non-kernel chain its own way, so rtol 1e-6 per sweep."""
    jp, _ = _jstretched(RAGGED, dtype)
    tp, _ = czt.Problem.manufactured_stretched(RAGGED,
                                               dtype=getattr(torch, dtype),
                                               device="cpu")
    shape = tp.grid.shape_kij
    x, b = _fields(shape, 111)
    tdt = getattr(torch, dtype)
    xt, bt = torch.tensor(x, dtype=tdt), torch.tensor(b, dtype=tdt)
    xj, bj = jnp.asarray(xt.numpy()), jnp.asarray(bt.numpy())
    msk = tp.msk
    if kind == "jacobi":
        xj, rj = jax.jit(lambda x, b: jmaf.jacobi_maf_sweep(x, b, jp.msk, OMEGA, jp.mc))(xj, bj)
        xt, rt = tmaf.jacobi_maf_sweep(xt, bt, msk, OMEGA, tp.mc)
    else:
        jc = jstencil.color_masks(shape, 0, getattr(jnp, dtype))
        tc = stencil.color_masks(shape, 0, tdt)
        xj, rj = jax.jit(lambda x, b: jmaf.sor2sma_maf_sweep(
            x, b, jp.msk, OMEGA, jp.mc, jc))(xj, bj)
        xt, rt = tmaf.sor2sma_maf_sweep(xt, bt, msk, OMEGA, tp.mc, tc)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(rt), float(rj), rtol=1e-5)


@pytest.mark.parametrize(
    "dtype,count_band,rtol,skip_last",
    [("float64", 100, 1e-6, 0), ("float32", 50, 1e-3, 1)],
)
def test_sor2sma_maf_32_matches_oracle(dtype, count_band, rtol, skip_last):
    """The bands of tests/test_ref_parity.py: f64 count +-1% and curve to
    rtol 1e-6; f32 count +-2% and curve to rtol 1e-3 but for the last
    entry, which straddles the threshold."""
    ref = load(f"{dtype[:1]}{dtype[-2:]}_sor2sma_maf_32_w1.5.txt")
    prob = czt.Problem.poisson_cube(32, dtype=getattr(torch, dtype),
                                    device="cpu", maf=True)
    r = czt.solve(prob, "sor2sma_maf", omega=OMEGA, itr_max=40000)
    assert abs(r.iters - len(ref)) <= max(1, len(ref) // count_band)
    if dtype == "float32":
        assert r.iters == 199
    m = min(r.iters, len(ref)) - skip_last
    np.testing.assert_allclose(r.history[:m].numpy(), ref[:m], rtol=rtol)
    assert czt.max_error(prob.grid, r.x) == pytest.approx(2.25e-4, rel=0.05)


def test_sor2sma_maf_stretched_h2():
    """f64 sor2sma_maf on the stretched grids at 24^3 and 48^3 (the pair
    with a streamed b): the error ratio lies in the h^2 band (3.4, 5.0) of
    tests/test_maf_stretched.py."""
    errs = {}
    for n in (24, 48):
        prob, u = czt.Problem.manufactured_stretched(n, dtype=torch.float64,
                                                     device="cpu")
        r = czt.solve(prob, "sor2sma_maf", omega=OMEGA, itr_max=40000,
                      eps=1e-9)
        assert r.res < 1e-8
        errs[n] = float(((r.x - u).abs() * prob.msk).max())
    assert 3.4 < errs[24] / errs[48] < 5.0
    assert errs[48] < 7e-4


def test_maf_name_needs_coefficients():
    prob = czt.Problem.poisson_cube(8, device="cpu")
    for name in ("sor2sma_maf", "jacobi_maf"):
        with pytest.raises(ValueError, match="MafCoeffs"):
            czt.solve(prob, name, omega=1.0, itr_max=10)


def test_from_arrays_carries_coords_and_coefficients():
    """A problem built from the JAX package's arrays, coordinates and
    coefficients solves as the one the port builds itself."""
    jp, _ = _jstretched(RAGGED, "float64")
    g = jp.grid
    tp = czt.Problem.from_arrays(
        g.shape_kij, torch.float64, np.asarray(jp.x0), np.asarray(jp.rhs),
        device="cpu", coords=(g.coords_i, g.coords_j, g.coords_k),
        mc=_carry(jp.mc),
    )
    own, _ = czt.Problem.manufactured_stretched(RAGGED, dtype=torch.float64,
                                                device="cpu")
    assert tp.grid == own.grid
    torch.testing.assert_close(tp.pvt, own.pvt, rtol=0, atol=0)
    ra = czt.solve(tp, "sor2sma_maf", omega=OMEGA, itr_max=500, eps=1e-9)
    rb = czt.solve(own, "sor2sma_maf", omega=OMEGA, itr_max=500, eps=1e-9)
    assert ra.iters == rb.iters and torch.equal(ra.x, rb.x)
