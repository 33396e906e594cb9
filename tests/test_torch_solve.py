"""The port's whole slice on the CPU: solve() against the reference-oracle
histories (the bands of tests/test_ref_parity.py) and against the JAX
package's own solve, the driver's chunking, the history writer, and the
refusals of what is not ported yet."""

import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubez_tpu import Problem as JProblem
from cubez_tpu import solve as jsolve
from cubez_tpu.solvers.steps import make_step as j_make_step
from cubez_tpu.utils.native import write_history as j_write_history

import cubez_tpu_torch as czt
from cubez_tpu_torch.cuda_kernels import rbpack
from cubez_tpu_torch.solvers import driver
from cubez_tpu_torch.solvers.fused_cache import get_fused_step
from cubez_tpu_torch.solvers.steps import make_step
from cubez_tpu_torch.utils.history import write_history

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
HIST = ROOT / "tests" / "ref_histories"


def load(name):
    rows = (HIST / name).read_text().splitlines()[1:]
    return np.array([float(ln.split(",")[1]) for ln in rows])


@pytest.mark.parametrize(
    "dtype,count_band,rtol,skip_last",
    [("float64", 100, 1e-6, 0), ("float32", 50, 1e-3, 1)],
)
def test_sor2sma_32_matches_oracle_and_jax(dtype, count_band, rtol, skip_last):
    """f64: count +-1%, curve to rtol 1e-6; f32: count +-2%, curve to
    rtol 1e-3 but for the last entry, which straddles the threshold."""
    ref = load(f"{dtype[:1]}{dtype[-2:]}_sor2sma_32_w1.5.txt")
    prob = czt.Problem.poisson_cube(32, dtype=getattr(torch, dtype), device="cpu")
    r = czt.solve(prob, "sor2sma", omega=1.5, itr_max=40000)
    assert abs(r.iters - len(ref)) <= max(1, len(ref) // count_band)
    m = min(r.iters, len(ref)) - skip_last
    np.testing.assert_allclose(r.history[:m].numpy(), ref[:m], rtol=rtol)
    rj = jsolve(JProblem.poisson_cube(32, dtype=getattr(jnp, dtype)),
                "sor2sma", omega=1.5, itr_max=40000, impl="jnp")
    assert abs(r.iters - rj.iters) <= 1
    assert r.x.shape == (32, 32, 32) and bool(torch.isfinite(r.x).all())
    err = czt.max_error(prob.grid, r.x)
    assert err == pytest.approx(2.25e-4, rel=0.05)


def test_check_every_changes_nothing():
    """Counts, histories and the returned field are the same at every
    convergence-check granularity (the stopping chunk is replayed)."""
    prob = czt.Problem.poisson_cube(16, device="cpu")
    runs = [czt.solve(prob, "sor2sma", omega=1.5, itr_max=1000, check_every=c)
            for c in (1, 7, 16)]
    for r in runs[1:]:
        assert r.iters == runs[0].iters
        assert torch.equal(r.history, runs[0].history)
        assert torch.equal(r.x, runs[0].x)


def test_itr_max_stop_is_exact_and_unconverged():
    prob = czt.Problem.poisson_cube(16, device="cpu")
    r = czt.solve(prob, "sor2sma", omega=1.5, itr_max=13, check_every=16)
    s = czt.solve(prob, "sor2sma", omega=1.5, itr_max=13, check_every=1)
    assert r.iters == s.iters == 13 and r.res > 1e-5
    assert torch.equal(r.x, s.x) and torch.equal(r.history, s.history)


def test_auto_and_plain_agree_on_cpu():
    prob = czt.Problem.poisson_cube((16, 18, 14), device="cpu")
    a = czt.solve(prob, "sor2sma", omega=1.5, itr_max=1000)
    p = czt.solve(prob, "sor2sma", omega=1.5, itr_max=1000, impl="plain")
    assert a.iters == p.iters and torch.equal(a.x, p.x)
    with pytest.raises(ValueError, match="impl"):
        czt.solve(prob, "sor2sma", omega=1.5, itr_max=10, impl="pallas")


def test_dispatch_follows_jax_order():
    """The JAX package's order of the packed steps (the zero-b chain,
    else the pair with b, else the single sweep, K4 for odd I), with two
    departures measured on the H100: MAF with a zero b takes the chain
    (JAX takes the pair), and beyond the L2 the chain runs the tile
    form's depth (JAX takes the deepest of 6, 4, 3 whose windows fit the
    TPU's VMEM, else the pair)."""
    p = czt.Problem.poisson_cube(16, device="cpu", maf=True)
    g = p.grid
    assert get_fused_step("sor2sma", g, 1.5, b_is_zero=True).iters_per_call == 6
    assert get_fused_step("sor2sma", g, 1.5).iters_per_call == 2
    # MAF takes the window chain too (the JAX package keeps it on the pair;
    # on the H100 the chain measured faster: rbpack.chain_depth)
    assert get_fused_step("sor2sma", g, 1.5, mc=p.mc,
                          b_is_zero=True).iters_per_call == 6
    assert get_fused_step("sor2sma", g, 1.5, mc=p.mc).iters_per_call == 2
    # beyond the L2 the chain runs the one-pass tiles at their depth
    big = czt.Grid(512, 512, 512, torch.float32, "cpu")
    assert get_fused_step("sor2sma", big, 1.5,
                          b_is_zero=True).iters_per_call == rbpack.TILE_N
    odd = czt.Problem.poisson_cube((15, 16, 16), device="cpu").grid
    assert get_fused_step("sor2sma", odd, 1.5, b_is_zero=True).iters_per_call == 1


@pytest.mark.parametrize("shape", [(15, 16, 14), (16, 16, 16)])
def test_unpacked_path_matches_jax(shape):
    """Odd I, and a mask with a hole, run the unpacked plain sweep; counts
    match the JAX package's jnp solve of the same problem."""
    jp = JProblem.poisson_cube(shape, dtype=jnp.float32)
    msk = np.asarray(jp.msk).copy()
    if shape[0] % 2 == 0:
        msk[5:8, 6, 7] = 0.0  # an obstacle: three nodes held at x0
    jp = dataclasses.replace(jp, msk=jnp.asarray(msk))
    tp = czt.Problem.from_arrays(
        jp.grid.shape_kij, torch.float32, np.asarray(jp.x0), np.asarray(jp.rhs),
        msk=msk, rhs_inner_zero=True, device="cpu",
    )
    assert tp.msk_is_standard() == (shape[0] % 2 == 1)
    r = czt.solve(tp, "sor2sma", omega=1.5, itr_max=2000)
    rj = jsolve(jp, "sor2sma", omega=1.5, itr_max=2000, impl="jnp")
    assert abs(r.iters - rj.iters) <= 1
    m = min(r.iters, rj.iters) - 1
    # f32 curves: the JAX jnp step sums dp^2 in float32, the port in float64
    np.testing.assert_allclose(r.history[:m].numpy(), np.asarray(rj.history)[:m],
                               rtol=1e-3)


def test_from_arrays_one_sweep_matches_jax():
    """One sweep from a seeded x0 and b: the port's unpacked step against
    the JAX package's jnp step (same formula), and the packed twin."""
    shape = (12, 14, 10)
    rng = np.random.default_rng(9)
    x0 = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    jp = dataclasses.replace(
        JProblem.poisson_cube((14, 10, 12), dtype=jnp.float32),
        x0=jnp.asarray(x0), rhs=jnp.asarray(b), rhs_inner_zero=False,
    )
    tp = czt.Problem.from_arrays(shape, torch.float32, x0, b, device="cpu")
    xj, rj = j_make_step(jp, "sor2sma", 1.5)(jp.x0, jp.rhs)
    xt, rt = make_step(tp, "sor2sma", 1.5)(tp.x0, tp.rhs)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(rt), float(rj), rtol=1e-5)
    step = get_fused_step("sor2sma", tp.grid, 1.5).single
    xp, rp = step(step.pad(tp.x0), step.pad(tp.rhs))
    np.testing.assert_allclose(step.unpad(xp).numpy(), np.asarray(xj), atol=1e-5)
    np.testing.assert_allclose(float(rp), float(rj), rtol=1e-5)


def test_fixed_sweeps_rounds_up_to_whole_calls():
    prob = czt.Problem.poisson_cube(12, device="cpu")
    step = get_fused_step("sor2sma", prob.grid, 1.5, b_is_zero=True)
    single = step.single
    x6 = driver.fixed_sweeps(step, step.pad(prob.x0), None, 5)
    x1 = driver.fixed_sweeps(single, step.pad(prob.x0), None, 6)
    assert torch.equal(x6, x1)


def test_write_history_byte_identical(tmp_path):
    res = np.array([2.525142e-02, 1.5e-3, 9.99e-6, 1.0, 123456.789, 3e-300])
    j_write_history(tmp_path / "j.txt", res)
    write_history(tmp_path / "t.txt", torch.tensor(res))
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    prob = czt.Problem.poisson_cube(12, device="cpu")
    r = czt.solve(prob, "sor2sma", omega=1.5, itr_max=500,
                  history_path=tmp_path / "h.txt")
    j_write_history(tmp_path / "hj.txt", r.history.numpy())
    assert (tmp_path / "h.txt").read_bytes() == (tmp_path / "hj.txt").read_bytes()


@pytest.mark.parametrize("name,where", [
    ("psor", "slice 6"), ("pcr", "slice 6"),
    ("pcr_esa_maf", "slice 6"), ("psor_maf", "slice 6"),
    ("pcr_eda", "slice 6"), ("fmg", "slice 7"),
    ("mg", "slice 7"), ("fd", "slice 7"),
])
def test_unported_solvers_name_their_slice(name, where):
    """The names of slices 6 and 7, which raised naming their slice until
    it was ported, now solve: slice 6's exact serial orders ten sweeps,
    slice 7's extensions (mg, fmg, fd) to eps in a few iterations."""
    prob = czt.Problem.poisson_cube(8, device="cpu", maf=name.endswith("_maf"))
    r = czt.solve(prob, name, omega=1.0, itr_max=10)
    assert bool(torch.isfinite(r.x).all()) and r.history.shape == (r.iters,)
    if where == "slice 6":
        assert r.iters == 10
    else:
        assert r.res < 1e-5 and 0 < r.iters < 10


@pytest.mark.parametrize("name,omega,n", [
    ("jacobi", 0.8, 16), ("jacobi_maf", 0.8, 16), ("sor2sma_maf", 1.5, 16),
    ("sor2sma", 1.5, (15, 16, 14)), ("sor2sma_maf", 1.5, (15, 16, 14)),
])
def test_slice_2_solvers_match_jax(name, omega, n):
    """The solvers this slice brings (jacobi, jacobi_maf, sor2sma_maf, and
    odd-I sor2sma on K4) solve on the CPU and stop where the JAX package's
    jnp solve stops."""
    maf = name.endswith("_maf")
    tp = czt.Problem.poisson_cube(n, device="cpu", maf=maf)
    r = czt.solve(tp, name, omega=omega, itr_max=3000)
    rj = jsolve(JProblem.poisson_cube(n, dtype=jnp.float32, maf=maf), name,
                omega=omega, itr_max=3000, impl="jnp")
    assert r.res < 1e-5 and r.iters < 3000
    assert abs(r.iters - rj.iters) <= 1
    m = min(r.iters, rj.iters) - 1
    np.testing.assert_allclose(r.history[:m].numpy(), np.asarray(rj.history)[:m],
                               rtol=1e-3)


def test_registry_verbatim_and_unknown_solver():
    from cubez_tpu.solvers import steps as jsteps

    from cubez_tpu_torch.solvers import steps as tsteps

    assert tsteps.ALL_SOLVERS == jsteps.ALL_SOLVERS
    assert tsteps.EXTENSION_SOLVERS == jsteps.EXTENSION_SOLVERS
    for name in jsteps.ALL_SOLVERS + jsteps.EXTENSION_SOLVERS:
        assert tsteps.parse_name(name) == jsteps.parse_name(name)
    with pytest.raises(ValueError, match="unknown solver"):
        tsteps.parse_name("sor3")


def test_import_pulls_in_no_jax():
    """Every module of the port, found by walking the package, imports
    without jax or the JAX package."""
    code = (
        "import pkgutil, importlib, sys; import cubez_tpu_torch as p; "
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'cubez_tpu_torch.')]; "
        "[importlib.import_module(m) for m in mods]; "
        "assert 'cubez_tpu_torch.parallel.dist_pack' in mods, mods; "
        "assert 'cubez_tpu_torch.cuda_kernels.dist_sweeps' in mods, mods; "
        "assert {'cubez_tpu_torch.perf.' + m for m in ('pmlib', 'profile', "
        "'roofline', 'memory', 'scaling')} <= set(mods), mods; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'cubez_tpu.')) or m == 'cubez_tpu']; "
        "assert not bad, bad; print(len(mods))"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout) >= 25
