"""The n-iteration packed red-black launch (K2/K3, csrc/rbpack.cu) on the
CPU: its plan (``rbpack.tile_plan``), the dependency cone its tiles assume,
the dispatched depth against the JAX package's interpreted window chain,
and the out-of-place step contract.

The tile kernel runs only on the card; here its plan is checked for what
the kernel relies on (every owned cell in one work item, halos at least
the cone of 2n colour half-steps, shared memory that fits), and the cone
is emulated: the plain twin run on a tile's region alone, frozen at the
region's edges, must give the tile's owned cells bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubez_tpu.pallas_kernels import rbpack as jrb

import cubez_tpu_torch as czt
from cubez_tpu_torch.cuda_kernels import rbpack as trb
from cubez_tpu_torch.cuda_kernels import sweeps as k4
from cubez_tpu_torch.solvers import driver

torch.set_num_threads(1)

OMEGA = 1.5
RAGGED = (37, 22, 45)
PLAN_SHAPES = [(128, 128, 128), (124, 124, 124), (512, 512, 512),
               (512, 510, 512), RAGGED]


def _partition(ranges, extent):
    """True where the distinct [lo, hi) ranges tile [0, extent) once."""
    ends = 0
    for lo, hi in sorted(set(ranges)):
        if lo != ends or hi <= lo:
            return False
        ends = hi
    return ends == extent


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_covers_each_cell_once_and_fits(shape, itemsize, monkeypatch):
    """Every form the plan takes, for every n, with and without b and MAF:
    a tile plan's work items partition the packed (K, I/2, J) volume, its
    shared memory fits a CTA, and its halos cover the cone (2n planes and
    columns, n packed rows for 2n half-steps of one physical cell)."""
    K, I, J = shape
    for n in range(2, 10):
        for has_b in (False, True):
            for maf in (False, True):
                plan = trb.tile_plan(shape, n, itemsize, has_b, maf)
                most = trb.TILE_BYTES[maf, itemsize]
                big = most is not None and 2 * K * I * J * itemsize > most
                expect = "tile" if big and n == trb.TILE_N and not has_b else "rows"
                assert plan.form == expect, (n, has_b, maf)
    monkeypatch.setattr(trb, "_force_plan", {"form": "tile"})
    plan = trb.tile_plan(shape, trb.TILE_N, itemsize)
    items = list(plan.items())
    assert len(items) == plan.nwork
    assert _partition([it[0] for it in items], K)
    assert _partition([it[1] for it in items], I // 2)
    assert _partition([it[2] for it in items], J)
    assert len(set(items)) == len(items)
    assert plan.smem <= k4.SMEM_CTA
    n = plan.n
    assert plan.halo_planes >= 2 * n and plan.halo_cols >= 2 * n
    assert plan.halo_rows >= n
    # the kernel's region rows, and a row holds the columns and their
    # alignment shift
    assert plan.ti + 2 * plan.halo_rows <= trb.REGION_ROWS
    assert plan.tj + 2 * plan.halo_cols + 16 // itemsize - 1 <= trb.ROW


def test_plan_refuses_what_the_tile_kernel_is_not_built_for(monkeypatch):
    with pytest.raises(ValueError, match="1.."):
        trb.tile_plan((64, 64, 64), 10)
    monkeypatch.setattr(trb, "_force_plan", {"form": "tile"})
    for kw in (dict(n=3), dict(n=2, has_b=True)):
        with pytest.raises(ValueError, match="tile kernel runs"):
            trb.tile_plan((512, 512, 512), **kw)
    monkeypatch.setattr(trb, "_force_plan", {"form": "slabs"})
    with pytest.raises(ValueError, match="form"):
        trb.tile_plan((64, 64, 64), 2)
    # the hook's other overrides: fewer region rows, a fixed chunk
    monkeypatch.setattr(trb, "_force_plan", {"rows": 16, "kchunk": 64})
    forced = trb.tile_plan((512, 512, 512), 2)
    assert forced.ti + 2 * forced.halo_rows <= 16 and forced.kchunk == 64


def _sub_tables(tab, shape, kr, ir, jr):
    """The MAF tables of a sub-box ((k0, k1), (i0, i1), (j0, j1)) in
    physical cells, in ``maf_tables``' layout."""
    v = trb.table_views(tab, shape)
    cut = {"k": slice(*kr), "i": slice(*ir), "j": slice(*jr)}
    return torch.cat([v[name][cut[axis]] for name, axis in trb.TABLES])


def _cone_plan(shape, n, ti, tj, kchunk):
    """A tile plan of n half-step pairs at the given extents (the halos
    follow n as the kernel's do)."""
    K, I, J = shape
    return trb.RbPlan("tile", shape, n, ti, tj, -(-(I // 2) // ti), -(-J // tj),
                      kchunk, -(-K // kchunk))


@pytest.mark.parametrize("n,maf,with_b,dtype", [
    (2, False, False, torch.float32),
    (3, False, False, torch.float64),
    (trb.ROWS_CHAIN_N, False, False, torch.float64),
    (2, True, False, torch.float32),
    (2, False, True, torch.float32),
    (3, True, True, torch.float64),
])
def test_cone_emulated_on_tile_regions(n, maf, with_b, dtype):
    """Each tile's region (owned box, halos, extra planes; frozen at its
    edges) run through the plain twin alone gives the whole-field n
    iterations at the owned cells, bit for bit.  A wrong halo or lag shows
    here before the card."""
    shape = (20, 2 * (3 * n + 5), 3 * n + 13)  # three tiles in i2, two in j
    K, I, J = shape
    rng = np.random.default_rng(100 + n)
    x = trb.pack_rb(torch.tensor(rng.standard_normal(shape)).to(dtype), 1)
    b = trb.pack_rb(torch.tensor(rng.standard_normal(shape)).to(dtype), 1)
    b = b if with_b else None
    tab = None
    if maf:
        mc = czt.Problem.manufactured_stretched((I, J, K), dtype=dtype,
                                                device="cpu")[0].mc
        tab = trb.maf_tables(mc, shape, dtype)
    whole = x.clone()
    trb.packed_sweeps_plain(whole, b, n, OMEGA, 1, tab)
    plan = _cone_plan(shape, n, ti=I // 6, tj=-(-J // 2), kchunk=7)
    seen = torch.zeros(x.shape[1:], dtype=torch.int32)
    for item in plan.items():
        (k0, k1), (r0, r1), (j0, j1) = plan.region(item)
        box = (slice(None), slice(k0, k1), slice(r0, r1), slice(j0, j1))
        sub = x[box].clone()
        sub_tab = None if tab is None else _sub_tables(
            tab, shape, (k0, k1), (2 * r0, 2 * r1), (j0, j1))
        trb.packed_sweeps_plain(sub, None if b is None else b[box].clone(), n,
                                OMEGA, (1 + k0 + j0) % 2, sub_tab)
        (ok0, ok1), (or0, or1), (oj0, oj1) = item
        own = (slice(None), slice(ok0 - k0, ok1 - k0), slice(or0 - r0, or1 - r0),
               slice(oj0 - j0, oj1 - j0))
        want = whole[:, ok0:ok1, or0:or1, oj0:oj1]
        assert torch.equal(sub[own], want), item
        seen[ok0:ok1, or0:or1, oj0:oj1] += 1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("n", sorted({trb.TILE_N, trb.ROWS_CHAIN_N}))
def test_dispatched_depth_bitwise_vs_jax(n):
    """The chain at the depths the dispatch takes (rbpack.chain_depth: the
    row form's and the tile form's) against the JAX package's
    make_packed_sweepnx at that n, interpreted, at 16^3: fields bitwise,
    residuals to rtol 1e-5."""
    shape = (16, 16, 16)
    rng = np.random.default_rng(70 + n)
    x = rng.standard_normal(shape).astype(np.float32)
    jstep = jax.jit(jrb.make_packed_sweepnx(shape, jnp.float32, omega=OMEGA,
                                            n=n, kt=8 if n < 6 else 16,
                                            interpret=True))
    tstep = trb.make_packed_sweepnx(shape, torch.float32, omega=OMEGA, n=n)
    xj, xt = jrb.pack_rb(jnp.asarray(x)), trb.pack_rb(torch.tensor(x))
    zero = jnp.zeros_like(xj)
    for _ in range(2):
        xj, rj = jstep(xj, zero)
        xt, rt = tstep(xt, None)
        np.testing.assert_array_equal(np.asarray(jrb.unpack_rb(xj, shape)),
                                      trb.unpack_rb(xt, shape).numpy())
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-5)
    assert trb.chain_depth(shape) == trb.ROWS_CHAIN_N
    assert trb.chain_depth((512, 512, 512)) == trb.TILE_N


@pytest.mark.parametrize("size,dtype,maf,depth", [
    (160, torch.float32, False, trb.ROWS_CHAIN_N),
    (192, torch.float32, False, trb.TILE_N),
    (128, torch.float64, False, trb.ROWS_CHAIN_N),
    (160, torch.float64, False, trb.TILE_N),
    (384, torch.float32, True, trb.ROWS_CHAIN_N),
    (448, torch.float32, True, trb.TILE_N),
    (512, torch.float64, True, trb.ROWS_CHAIN_N),
])
def test_chain_depth_switches_where_measured(size, dtype, maf, depth):
    """The dispatch's chain takes the tile form on either side of the
    switch points measured on the H100 (rbpack.TILE_BYTES): constant
    coefficients past the L2, MAF float32 from 448^3, MAF float64 never."""
    assert trb.chain_depth((size,) * 3, dtype, maf) == depth


def test_solve_does_not_depend_on_depth_or_chunk():
    """A solve's count, history and field are the same for every n of the
    chain and every check_every (the driver replays the stopping chunk)."""
    p = czt.Problem.poisson_cube(18, device="cpu")
    g = p.grid
    runs = []
    for n in (2, 3, 6):
        step = trb.make_packed_sweepnx(g.shape_kij, torch.float32, omega=OMEGA,
                                       n=n)
        for every in (1, 5, 16):
            runs.append(driver.run_iterative(step, p.x0, p.rhs, g.res_normal,
                                             2000, check_every=every,
                                             pre=step.pad, post=step.unpad))
    first = runs[0]
    assert 10 < first.iters < 2000
    for r in runs[1:]:
        assert r.iters == first.iters
        assert torch.equal(r.x, first.x)
        torch.testing.assert_close(r.history, first.history, rtol=0, atol=0)


@pytest.mark.parametrize("maker,kw", [
    (trb.make_packed_sweepnx, dict(n=3)),
    (trb.make_packed_sweep2x, dict(b_is_zero=False)),
])
def test_step_is_out_of_place(maker, kw):
    """The n-iteration step alternates between two states it owns and
    never writes the state it is handed; fixed sweeps equal single steps."""
    shape = (10, 12, 14)
    rng = np.random.default_rng(5)
    x = trb.pack_rb(torch.tensor(rng.standard_normal(shape).astype(np.float32)))
    b = trb.pack_rb(torch.tensor(rng.standard_normal(shape).astype(np.float32)))
    step = maker(shape, torch.float32, omega=OMEGA, **kw)
    x0 = x.clone()
    y1, _ = step(x, b)
    assert torch.equal(x, x0)
    y2, _ = step(y1, b)
    y3, _ = step(y2, b)
    assert y1.data_ptr() != x.data_ptr() and y2.data_ptr() != y1.data_ptr()
    assert y3.data_ptr() == y1.data_ptr()
    fixed = driver.fixed_sweeps(step, x, b, 8)
    one = x.clone()
    for _ in range(-(-8 // step.iters_per_call) * step.iters_per_call):
        one, _ = step.single(one, b)
    assert torch.equal(fixed, one)
    assert torch.equal(x, x0)


def test_wrapper_out_argument_on_cpu():
    """rb_sweeps_n writes ``out`` and leaves x as it was (the CUDA kernel's
    contract), or updates x in place without ``out``; both give the twin's
    field, and ``out`` must not be x."""
    shape = (9, 8, 11)
    rng = np.random.default_rng(8)
    x = trb.pack_rb(torch.tensor(rng.standard_normal(shape).astype(np.float32)))
    x0, out = x.clone(), torch.empty_like(x)
    r_out = trb.rb_sweeps_n(x, None, 3, OMEGA, out=out)
    assert torch.equal(x, x0)
    r_in = trb.rb_sweeps_n(x, None, 3, OMEGA)
    assert torch.equal(x, out) and torch.equal(r_in, r_out)
    with pytest.raises(ValueError, match="out"):
        trb.rb_sweeps_n(x, None, 2, OMEGA, out=x)
    with pytest.raises(ValueError, match="out"):
        trb.rb_sweeps_n(x, None, 2, OMEGA, out=x[:, :-1].clone())
