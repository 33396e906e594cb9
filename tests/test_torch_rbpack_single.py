"""K1, the single packed red-black iteration (``rbpack.make_packed_sweep``,
``rbpack.rb_single``: one launch of csrc/rbpack.cu an iteration), on the
CPU: the one-pass order of its tile form, its plan, and the step's replay
contract.

The tile form runs both colours in one pass over k with colour 1 a plane
behind colour 0 (the TPU kernel's own lag, cubez_tpu/pallas_kernels/
rbpack.py:673-790), on tiles whose halo (one plane, two packed rows, two
columns at n = 1) the neighbouring tile computes again.  Both are emulated
with the plain twin and held bit for bit to two ``rb_color_plain``
colours, with b and MAF, at even and odd offsets."""

import numpy as np
import pytest
import torch

import cubez_tpu_torch as czt
from cubez_tpu_torch.cuda_kernels import rbpack as trb
from cubez_tpu_torch.cuda_kernels import sweeps as k4
from cubez_tpu_torch.solvers import driver

torch.set_num_threads(1)

OMEGA = 1.5
CASES = [(maf, with_b, dtype) for maf in (False, True) for with_b in (False, True)
         for dtype in (torch.float32, torch.float64)]


def _fields(shape, dtype, offset, seed, maf):
    K, I, J = shape
    rng = np.random.default_rng(seed)
    x = trb.pack_rb(torch.tensor(rng.standard_normal(shape)).to(dtype), offset)
    b = trb.pack_rb(torch.tensor(rng.standard_normal(shape)).to(dtype), offset)
    tab = None
    if maf:
        mc = czt.Problem.manufactured_stretched((I, J, K), dtype=dtype,
                                                device="cpu")[0].mc
        tab = trb.maf_tables(mc, shape, dtype)
    return x, b, tab


def _sub_tables(tab, shape, kr, ir, jr):
    """The MAF tables of a sub-box ((k0, k1), (i0, i1), (j0, j1)) in
    physical cells, in ``maf_tables``' layout."""
    if tab is None:
        return None
    v = trb.table_views(tab, shape)
    cut = {"k": slice(*kr), "i": slice(*ir), "j": slice(*jr)}
    return torch.cat([v[name][cut[axis]] for name, axis in trb.TABLES])


def _two_colours(x, b, offset, tab):
    want = x.clone()
    r = trb.rb_color_plain(want, b, 0, OMEGA, offset, tab)
    r = r + trb.rb_color_plain(want, b, 1, OMEGA, offset, tab)
    return want, r


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("maf,with_b,dtype", CASES)
def test_lagged_plane_order_equals_two_colours(maf, with_b, dtype, offset):
    """The one-pass order: at step s colour 0 updates plane s - 1 (from
    colour 1's old planes s - 2 .. s), then colour 1 updates plane s - 2
    (from colour 0's new planes s - 3 .. s - 1).  Plane by plane, that is
    the two whole colours bit for bit."""
    shape = (11, 10, 13)
    K, I, J = shape
    x, b, tab = _fields(shape, dtype, offset, 7 + offset, maf)
    b = b if with_b else None
    want, _ = _two_colours(x, b, offset, tab)
    got = x.clone()

    def plane(colour, p):
        # planes p - 1 .. p + 1 (views of got): the update of plane p alone
        sub = got[:, p - 1:p + 2]
        sb = None if b is None else b[:, p - 1:p + 2]
        st = _sub_tables(tab, shape, (p - 1, p + 2), (0, I), (0, J))
        trb.rb_color_plain(sub, sb, colour, OMEGA, offset + p - 1, st)

    for s in range(K + 2):
        if 1 <= s - 1 <= K - 2:
            plane(0, s - 1)
        if 1 <= s - 2 <= K - 2:
            plane(1, s - 2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("maf,with_b,dtype", CASES)
def test_halo_recompute_on_tile_regions(maf, with_b, dtype, offset):
    """Each work item of the n = 1 tile plan, its region (owned box and
    halos, frozen at the region's edges) run through two plain colours
    alone, gives the whole-field iteration at its owned cells bit for bit,
    and the owned boxes cover the field once: the halo the neighbouring
    tile computes again is enough."""
    shape = (16, 2 * 11, 19)  # several tiles in i2 and j, k chunks
    K, I, J = shape
    x, b, tab = _fields(shape, dtype, offset, 30 + offset, maf)
    b = b if with_b else None
    want, _ = _two_colours(x, b, offset, tab)
    plan = trb.RbPlan("tile", shape, 1, 4, 7, -(-(I // 2) // 4), -(-J // 7),
                      5, -(-K // 5))
    assert (plan.halo_planes, plan.halo_rows, plan.halo_cols) == (2, 2, 2)
    seen = torch.zeros(x.shape[1:], dtype=torch.int32)
    for item in plan.items():
        (k0, k1), (r0, r1), (j0, j1) = plan.region(item)
        box = (slice(None), slice(k0, k1), slice(r0, r1), slice(j0, j1))
        sub = x[box].clone()
        st = _sub_tables(tab, shape, (k0, k1), (2 * r0, 2 * r1), (j0, j1))
        sb = None if b is None else b[box].clone()
        trb.rb_color_plain(sub, sb, 0, OMEGA, (offset + k0 + j0) % 2, st)
        trb.rb_color_plain(sub, sb, 1, OMEGA, (offset + k0 + j0) % 2, st)
        (ok0, ok1), (or0, or1), (oj0, oj1) = item
        own = (slice(None), slice(ok0 - k0, ok1 - k0), slice(or0 - r0, or1 - r0),
               slice(oj0 - j0, oj1 - j0))
        assert torch.equal(sub[own], want[:, ok0:ok1, or0:or1, oj0:oj1]), item
        seen[ok0:ok1, or0:or1, oj0:oj1] += 1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("size,dtype,maf,with_b", [
    (128, torch.float32, False, False), (128, torch.float32, True, True),
    (128, torch.float64, False, False), (512, torch.float32, False, False),
    (512, torch.float32, False, True), (512, torch.float32, True, False),
    (512, torch.float64, True, False), (256, torch.float64, False, True),
])
def test_single_plan_follows_its_switch(size, dtype, maf, with_b):
    """K1's launch (n = 1) takes the tile form where x and out pass
    SINGLE_TILE_BYTES for (MAF, itemsize, b), else the rows; its tiles
    cover the field once and fit a CTA's shared memory."""
    shape = (size,) * 3
    item = torch.empty((), dtype=dtype).element_size()
    plan = trb.tile_plan(shape, 1, item, with_b, maf)
    most = trb.SINGLE_TILE_BYTES[maf, item, with_b]
    big = most is not None and 2 * size**3 * item > most
    assert plan.form == ("tile" if big else "rows")
    if plan.form == "tile":
        assert plan.smem <= k4.SMEM_CTA
        assert plan.ti + 2 * plan.halo_rows <= trb.REGION_ROWS
        assert plan.tj + 2 * plan.halo_cols + 16 // item - 1 <= trb.ROW
        assert plan.nwork == plan.tiles_i * plan.tiles_j * plan.nkc


def test_tile_kernel_is_built_for_the_single_iteration():
    """The tile kernel runs n = 1 with or without b, n = TILE_N with a zero
    b, nothing else; a forced tile plan at n = 1 with b is made."""
    assert trb.tile_built(1, False) and trb.tile_built(1, True)
    assert trb.tile_built(trb.TILE_N, False) and not trb.tile_built(trb.TILE_N, True)
    assert not trb.tile_built(3, False)
    trb._force_plan = {"form": "tile"}
    try:
        plan = trb.tile_plan((64, 64, 64), 1, 4, has_b=True)
    finally:
        trb._force_plan = {}
    assert plan.form == "tile" and plan.n == 1


@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("with_b", [False, True])
def test_single_step_reads_a_foreign_field_and_never_writes_it(maf, with_b):
    """make_packed_sweep's step returns one of two states it owns, the one
    that is not its input, and never writes the state it is handed (the
    driver's snapshot in its replay); its iterations are the twin's two
    colours, bit for bit."""
    shape = (10, 12, 14)
    x, b, tab = _fields(shape, torch.float32, 0, 5, maf)
    mc = None
    if maf:
        mc = czt.Problem.manufactured_stretched((12, 14, 10), dtype=torch.float32,
                                                device="cpu")[0].mc
    step = trb.make_packed_sweep(shape, torch.float32, omega=OMEGA,
                                 b_is_zero=not with_b, mc=mc)
    bb = b if with_b else None
    assert step.single is step and step.iters_per_call == 1
    keep = x.clone()
    y1, r1 = step(x, b)
    assert torch.equal(x, keep) and y1.data_ptr() != x.data_ptr()
    want, rw = _two_colours(x, bb, 0, tab)
    assert torch.equal(y1, want) and float(r1) == float(rw)
    y2, _ = step(y1, b)
    y3, _ = step(y2, b)
    assert y2.data_ptr() != y1.data_ptr() and y3.data_ptr() == y1.data_ptr()
    again, _ = step(x, b)  # the same foreign start again
    assert torch.equal(x, keep) and torch.equal(again, want)


def test_driver_replay_stops_on_the_single_step():
    """The chain's stopping chunk is replayed with the single step from the
    driver's snapshot: the count, history and field do not depend on
    check_every, and equal a run of the single step alone."""
    p = czt.Problem.poisson_cube(18, device="cpu")
    g = p.grid
    step = trb.make_packed_sweepnx(g.shape_kij, torch.float32, omega=OMEGA, n=6)
    single = step.single
    runs = [driver.run_iterative(s, p.x0, p.rhs, g.res_normal, 2000,
                                 check_every=every, pre=s.pad, post=s.unpad)
            for s, every in ((single, 1), (step, 16), (step, 7), (single, 16))]
    first = runs[0]
    assert 10 < first.iters < 2000
    for r in runs[1:]:
        assert r.iters == first.iters
        assert torch.equal(r.x, first.x)
        torch.testing.assert_close(r.history, first.history, rtol=0, atol=0)


def test_rb_single_out_argument_on_cpu():
    """rb_single writes ``out`` and leaves x as it was, or updates x in place
    without ``out``; both the twin's field; ``out`` must not be x."""
    shape = (9, 8, 11)
    x, b, _ = _fields(shape, torch.float32, 0, 8, False)
    x0, out = x.clone(), torch.empty_like(x)
    r_out = trb.rb_single(x, b, OMEGA, out=out)
    assert torch.equal(x, x0)
    r_in = trb.rb_single(x, b, OMEGA)
    assert torch.equal(x, out) and float(r_in) == float(r_out)
    assert r_in.dim() == 0 and r_in.dtype == torch.float64
    with pytest.raises(ValueError, match="out"):
        trb.rb_single(x, None, OMEGA, out=x)
