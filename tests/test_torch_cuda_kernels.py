"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (decided inside the tests, not at import).  This file imports no JAX,
so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

import cubez_tpu_torch as czt
from cubez_tpu_torch.cuda_kernels import lines as k6
from cubez_tpu_torch.cuda_kernels import rblines as k5
from cubez_tpu_torch.cuda_kernels import rbpack as rb
from cubez_tpu_torch.cuda_kernels import sweeps as k4

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

OMEGA = 1.5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


WRAPPERS = (rb.rb_color, rb.rb_sweeps_n, k4.jacobi_k4, k4.sor2sma_k4,
            k5.rbl, k6.line_j, k6.line_rb)


def _launches():
    return sum(w.launches for w in WRAPPERS)


def _builders(mc):
    """(label, build(shape, dtype, offset, plain)) for every kernel step;
    ``mc`` selects the MAF forms (the window chain at n <= 7)."""
    yield "single b=0", lambda sh, dt, off, pl: rb.make_packed_sweep(
        sh, dt, omega=OMEGA, offset=off, b_is_zero=True, mc=mc, plain=pl)
    yield "single b", lambda sh, dt, off, pl: rb.make_packed_sweep(
        sh, dt, omega=OMEGA, offset=off, b_is_zero=False, mc=mc, plain=pl)
    yield "pair b", lambda sh, dt, off, pl: rb.make_packed_sweep2x(
        sh, dt, omega=OMEGA, offset=off, b_is_zero=False, mc=mc, plain=pl)
    for n in (3, 4, 6):
        yield f"n={n}", lambda sh, dt, off, pl, n=n: rb.make_packed_sweepnx(
            sh, dt, omega=OMEGA, n=n, offset=off, mc=mc, plain=pl)
    for kind in k4.KINDS:
        for bz in (True, False):
            yield f"K4 {kind} b={not bz}", (
                lambda sh, dt, off, pl, kind=kind, bz=bz: k4.make_fused_sweep(
                    kind, sh, dt, omega=OMEGA if kind == "sor2sma" else 0.8,
                    offset=off, b_is_zero=bz, mc=mc, plain=pl))


@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(16, 16, 16), (13, 10, 17), (13, 11, 16)])
def test_kernels_match_plain_twins(dev, shape, dtype, offset, maf):
    """float32 fields bitwise equal; float64 within 1e-14 (the twin has no
    fma); residuals to rtol 1e-5 (block partial sums group differently).
    MAF on the stretched grid's coefficients; odd I takes K4 only."""
    mc = None
    if maf:
        K, I, J = shape
        mc = czt.Problem.manufactured_stretched((I, J, K), dtype=dtype,
                                                device=dev)[0].mc
    gen = torch.Generator().manual_seed(3 + offset)
    x = torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1
    b = torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1
    tol = 0.0 if dtype == torch.float32 else 1e-14
    n_steps = 0
    for label, build in _builders(mc):
        kstep = build(shape, dtype, offset, False)
        pstep = build(shape, dtype, offset, True)
        if kstep is None:  # odd I: no packed layout
            continue
        x0, b0 = kstep.pad(x.to(dev)), kstep.pad(b.to(dev))
        xk, xp = x0.clone(), x0.clone()
        before = _launches()
        for _ in range(3):
            xk, rk = kstep(xk, b0)
            xp, rp = pstep(xp, b0)
        torch.cuda.synchronize()
        assert _launches() > before, label
        assert float((xk - xp).abs().max()) <= tol, label
        torch.testing.assert_close(rk, rp, rtol=1e-5, atol=0)
        n_steps += 1
    assert n_steps == (4 if shape[1] % 2 else 10)


def test_solve_on_cuda_matches_cpu_twin(dev):
    """The whole slice at 32^3: the kernels and the CPU twin stop at the
    same iteration with bitwise equal fields."""
    g = czt.Problem.poisson_cube(32, device=dev)
    c = czt.Problem.poisson_cube(32, device="cpu")
    rg = czt.solve(g, "sor2sma", omega=OMEGA, itr_max=10000)
    rc = czt.solve(c, "sor2sma", omega=OMEGA, itr_max=10000)
    assert rg.iters == rc.iters == 199
    assert torch.equal(rg.x.cpu(), rc.x)
    torch.testing.assert_close(rg.history.cpu(), rc.history, rtol=1e-5, atol=0)


def test_wrappers_refuse_what_they_cannot_take(dev):
    x = rb.pack_rb(torch.zeros(8, 8, 8, device=dev))
    with pytest.raises(TypeError):
        rb.rb_color(x.half(), None, 0, OMEGA)
    with pytest.raises(ValueError, match="contiguous"):
        rb.rb_sweeps_n(x.transpose(2, 3), None, 2, OMEGA)
    with pytest.raises(ValueError, match="b must match"):
        rb.rb_sweeps_n(x, x.double(), 2, OMEGA)


def test_odd_i_on_cuda_launches_k4(dev):
    """Odd I, where the packed layout refuses, runs K4's colour kernel, and
    stops where the plain twin on the card stops."""
    prob = czt.Problem.poisson_cube((15, 16, 16), device=dev)
    before = k4.sor2sma_k4.launches
    r = czt.solve(prob, "sor2sma", omega=OMEGA, itr_max=2000)
    assert k4.sor2sma_k4.launches > before
    p = czt.solve(prob, "sor2sma", omega=OMEGA, itr_max=2000, impl="plain")
    assert r.iters == p.iters < 2000
    assert torch.equal(r.x, p.x)


@pytest.mark.parametrize("name", ["sor2sma", "jacobi", "pcr_rb", "pcr_j_esa"])
def test_non_standard_mask_on_cuda_raises(dev, name):
    """No kernel takes a mask other than the standard one, so 'auto' runs
    the plain masked sweep on the card (steps.make_step, the JAX package's
    jnp route; it no longer raises): no kernel launches, and the count and
    field are the CPU twin's (the field within 1e-6: the same elementwise
    operations on both devices; r2's sums group differently)."""
    base = czt.Problem.poisson_cube(16, device="cpu")
    msk = base.msk.numpy().copy()
    msk[5:8, 6, 7] = 0.0  # an obstacle
    probs = [czt.Problem.from_arrays((16, 16, 16), torch.float32,
                                     base.x0.numpy(), base.rhs.numpy(), msk,
                                     rhs_inner_zero=True, device=d)
             for d in (dev, "cpu")]
    before = _launches()
    r = czt.solve(probs[0], name, omega=0.8, itr_max=50)
    assert r.x.is_cuda and _launches() == before
    c = czt.solve(probs[1], name, omega=0.8, itr_max=50)
    assert r.iters == c.iters
    torch.testing.assert_close(r.x.cpu(), c.x, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,omega", [
    ("jacobi", 0.8), ("jacobi_maf", 0.8), ("sor2sma_maf", OMEGA),
])
def test_slice_2_solves_on_cuda_match_cpu_twin(dev, name, omega):
    """jacobi (K4), jacobi_maf (K4-MAF) and sor2sma_maf (the packed MAF
    pair) at 32^3: the oracle's counts, the CPU twin's field bit for bit,
    and the MAF launches counted."""
    maf = name.endswith("_maf")
    g = czt.Problem.poisson_cube(32, device=dev, maf=maf)
    c = czt.Problem.poisson_cube(32, device="cpu", maf=maf)
    before = sum(w.maf_launches for w in WRAPPERS)
    rg = czt.solve(g, name, omega=omega, itr_max=10000)
    rc = czt.solve(c, name, omega=omega, itr_max=10000)
    assert rg.iters == rc.iters == (199 if name == "sor2sma_maf" else 1015)
    assert torch.equal(rg.x.cpu(), rc.x)
    assert (sum(w.maf_launches for w in WRAPPERS) > before) == maf


def test_jacobi_kernel_is_out_of_place(dev):
    x = torch.rand(12, 13, 14, device=dev)
    keep = x.clone()
    out, _ = k4.jacobi_k4(x, None, 0.8)
    torch.cuda.synchronize()
    assert torch.equal(x, keep) and out.data_ptr() != x.data_ptr()
    # the boundary shell is carried into the new field
    inner = (slice(1, -1),) * 3
    shell = torch.ones_like(x, dtype=torch.bool)
    shell[inner] = False
    assert torch.equal(out[shell], x[shell])
    with pytest.raises(ValueError, match="out of place"):
        k4.jacobi_k4(x, None, 0.8, out=x)


def test_jacobi_step_alternates_two_buffers(dev):
    """The step writes one of its two buffers, never the field it is
    handed, and its fields equal the plain twin's step by step."""
    shape = (12, 13, 14)
    step = k4.make_fused_sweep("jacobi", shape, torch.float32, omega=0.8,
                               b_is_zero=True)
    twin = k4.make_fused_sweep("jacobi", shape, torch.float32, omega=0.8,
                               b_is_zero=True, plain=True)
    x0 = torch.rand(shape, device=dev)
    keep = x0.clone()
    xk, xp, ptrs = x0, x0.clone(), []
    for _ in range(4):
        xk, _ = step(xk, None)
        xp, _ = twin(xp, None)
        ptrs.append(xk.data_ptr())
        assert torch.equal(xk, xp)
    assert torch.equal(x0, keep)
    assert ptrs[0] == ptrs[2] != ptrs[1] == ptrs[3] != x0.data_ptr()
    # a foreign field (the driver's snapshot) is read, not written
    snap = xp.clone()
    xk, _ = step(snap, None)
    xp, _ = twin(xp, None)
    assert torch.equal(xk, xp) and xk.data_ptr() != snap.data_ptr()


def _line_builders(mc):
    """(label, build(shape, dtype, offset, plain)) for every line step;
    None where a layout refuses (K5 at odd I)."""
    for bz in (True, False):
        yield f"K5 b={not bz}", lambda sh, dt, off, pl, bz=bz: k5.make_rbl_step(
            sh, dt, omega=OMEGA, offset=off, b_is_zero=bz, mc=mc, plain=pl)
        for kind in k6.KINDS:
            yield f"K6 {kind} b={not bz}", (
                lambda sh, dt, off, pl, kind=kind, bz=bz: k6.make_line_step(
                    kind, sh, dt, omega=1.0 if kind == "pcr_j" else OMEGA,
                    offset=off, b_is_zero=bz, mc=mc, plain=pl))


@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(16, 16, 16), (13, 10, 17), (13, 11, 16)])
def test_line_kernels_match_plain_twins(dev, shape, dtype, offset, maf):
    """K5 and K6 against their twins on the card: float32 fields bitwise,
    float64 within 1e-14, residuals to rtol 1e-5 (block partials group
    the sum differently).  MAF on the stretched grid's coefficients; odd I
    has no K5 step."""
    mc = None
    if maf:
        K, I, J = shape
        mc = czt.Problem.manufactured_stretched((I, J, K), dtype=dtype,
                                                device=dev)[0].mc
    gen = torch.Generator().manual_seed(5 + offset)
    x = torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1
    b = torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1
    tol = 0.0 if dtype == torch.float32 else 1e-14
    n_steps = 0
    for label, build in _line_builders(mc):
        kstep = build(shape, dtype, offset, False)
        pstep = build(shape, dtype, offset, True)
        if kstep is None:
            continue
        x0, b0 = kstep.pad(x.to(dev)), kstep.pad(b.to(dev))
        xk, xp = x0.clone(), x0.clone()
        before = _launches()
        for _ in range(3):
            xk, rk = kstep(xk, b0)
            xp, rp = pstep(xp, b0)
        torch.cuda.synchronize()
        assert _launches() > before, label
        assert float((xk - xp).abs().max()) <= tol, label
        torch.testing.assert_close(rk, rp, rtol=1e-5, atol=0)
        n_steps += 1
    assert n_steps == (4 if shape[1] % 2 else 6)


@pytest.mark.parametrize("name,omega,iters", [
    ("pcr_rb", OMEGA, 140), ("pcr_rb_maf", OMEGA, 140),
    ("pcr_j_esa", 1.0, 624), ("pcr_rb", OMEGA, None),
])
def test_line_solves_on_cuda_match_cpu_twin(dev, name, omega, iters):
    """The line solvers at 32^3 (and pcr_rb at odd I, (31, 32, 32), on
    K6's red-black form): the oracle's counts, the CPU twin's field bit
    for bit, and the launches of the kernel the dispatch picks."""
    n = 32 if iters else (31, 32, 32)
    maf = name.endswith("_maf")
    g = czt.Problem.poisson_cube(n, device=dev, maf=maf)
    c = czt.Problem.poisson_cube(n, device="cpu", maf=maf)
    wrapper = {"pcr_j_esa": k6.line_j}.get(name, k5.rbl if iters else k6.line_rb)
    before = (wrapper.launches, wrapper.maf_launches)
    rg = czt.solve(g, name, omega=omega, itr_max=10000)
    rc = czt.solve(c, name, omega=omega, itr_max=10000)
    assert rg.iters == rc.iters and (iters is None or rg.iters == iters)
    assert torch.equal(rg.x.cpu(), rc.x)
    assert wrapper.launches > before[0]
    assert (wrapper.maf_launches > before[1]) == maf


def test_line_jacobi_step_alternates_two_buffers(dev):
    """K6's pcr_j step writes one of its two buffers, never the field it
    is handed, and its fields equal the plain twin's step by step."""
    shape = (12, 13, 14)
    mc = czt.Problem.poisson_cube((13, 14, 12), device=dev, maf=True).mc
    for m in (None, mc):
        step = k6.make_line_step("pcr_j", shape, omega=1.0, mc=m)
        twin = k6.make_line_step("pcr_j", shape, omega=1.0, mc=m, plain=True)
        x0 = torch.rand(shape, device=dev)
        keep = x0.clone()
        xk, xp, ptrs = x0, x0.clone(), []
        for _ in range(4):
            xk, _ = step(xk, None)
            xp, _ = twin(xp, None)
            ptrs.append(xk.data_ptr())
            assert torch.equal(xk, xp)
        assert torch.equal(x0, keep)
        assert ptrs[0] == ptrs[2] != ptrs[1] == ptrs[3] != x0.data_ptr()


def test_line_solver_without_two_inner_k_raises_on_cuda(dev):
    """K - 2 < 2 has no line kernel step: 'auto' runs the plain line sweep
    on the card (the JAX package's jnp route; it no longer raises), no
    kernel launches, the count and field are the CPU twin's (within 1e-6,
    as above); K6's wrapper itself still refuses such a field."""
    before = _launches()
    r = czt.solve(czt.Problem.poisson_cube((8, 8, 3), device=dev), "pcr_rb",
                  omega=OMEGA, itr_max=5)
    assert r.x.is_cuda and _launches() == before
    c = czt.solve(czt.Problem.poisson_cube((8, 8, 3), device="cpu"), "pcr_rb",
                  omega=OMEGA, itr_max=5)
    assert r.iters == c.iters
    torch.testing.assert_close(r.x.cpu(), c.x, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="K - 2 >= 2"):
        k6.line_rb(torch.zeros(3, 8, 8, device=dev), None, OMEGA)


# ---- slice 11: K5 and K6 on the shared-memory line tile ---------------------

# (K, I, J) at the tile's edges: K - 2 of 2 and 3 inner rows, K - 2 not a
# multiple of a tile's thread rows, line counts not a multiple of L, odd J,
# odd I (K6's red-black form; K5 refuses it)
TILE_EDGES = [(4, 10, 37), (5, 9, 33), (13, 12, 45), (39, 9, 70), (7, 6, 3)]
# (TILE_LINES, TILE_THREADS): the default, and settings that change the
# thread rows a lane and the tiles a row
TILE_SETTINGS = [(32, 256), (8, 64), (16, 128), (64, 256)]


@pytest.fixture
def tile_setting(request, monkeypatch):
    lines_max, threads = request.param
    monkeypatch.setattr(k6, "TILE_LINES", lines_max)
    monkeypatch.setattr(k6, "TILE_THREADS", threads)
    return request.param


@pytest.mark.parametrize("tile_setting", TILE_SETTINGS, indirect=True)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", TILE_EDGES)
def test_line_tile_edges_match_plain_twins(dev, shape, dtype, tile_setting):
    """Every K5/K6 step, constant and MAF, zero and streamed b, offsets 0
    and 1, at the tile's edges and several tile settings: float32 fields
    bitwise the twins', float64 within chip_smoke.py's 1e-14, residuals to
    rtol 1e-5."""
    K, I, J = shape
    gen = torch.Generator().manual_seed(11 + K)
    x = torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1
    b = torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1
    tol = 0.0 if dtype == torch.float32 else 1e-14
    mc = czt.Problem.manufactured_stretched((I, J, K), dtype=dtype,
                                            device=dev)[0].mc
    n_steps = 0
    for m in (None, mc):
        for offset in (0, 1):
            for label, build in _line_builders(m):
                kstep = build(shape, dtype, offset, False)
                pstep = build(shape, dtype, offset, True)
                if kstep is None:
                    continue
                x0, b0 = kstep.pad(x.to(dev)), kstep.pad(b.to(dev))
                xk, xp = x0.clone(), x0.clone()
                for _ in range(2):
                    xk, rk = kstep(xk, b0)
                    xp, rp = pstep(xp, b0)
                torch.cuda.synchronize()
                where = f"{label} MAF={m is not None} offset={offset}"
                assert float((xk - xp).abs().max()) <= tol, where
                torch.testing.assert_close(rk, rp, rtol=1e-5, atol=0, msg=where)
                n_steps += 1
    assert n_steps == 2 * 2 * (4 if I % 2 else 6)


@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_line_jacobi_copies_the_faces(dev, dtype, maf):
    """line_j writes every value of ``out``: handed a NaN-poisoned out, it
    leaves the face lines and the k = 0 and K-1 planes equal to x and the
    rest equal to the twin's, and x untouched."""
    shape = (13, 12, 45)
    K, I, J = shape
    tab = None
    if maf:
        mc = czt.Problem.manufactured_stretched((I, J, K), dtype=dtype,
                                                device=dev)[0].mc
        tab = rb.maf_tables(mc, shape, dtype)
    gen = torch.Generator().manual_seed(3)
    x = (torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1).to(dev)
    keep = x.clone()
    out = torch.full_like(x, float("nan"))
    got, _ = k6.line_j(x, None, 1.0, tab, out=out)
    want, _ = k6.line_j_plain(x, None, 1.0, tab)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr() and torch.equal(x, keep)
    assert bool(torch.isfinite(got).all())
    face = torch.ones(shape, dtype=torch.bool, device=dev)
    face[1:-1, 1:-1, 1:-1] = False
    assert torch.equal(got[face], x[face])
    tol = 0.0 if dtype == torch.float32 else 1e-14
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("kind", ["K5", "pcr_j", "pcr_rb"])
def test_line_steps_allocate_no_field_scratch(dev, kind, maf):
    """After a warm-up call a line step allocates only its partial sums:
    no (K, I, J)-sized scratch (the Thomas values stay in shared memory)."""
    shape = (48, 48, 48) if kind != "pcr_rb" else (48, 47, 48)
    K, I, J = shape
    mc = czt.Problem.poisson_cube((I, J, K), device=dev, maf=True).mc if maf else None
    if kind == "K5":
        step = k5.make_rbl_step(shape, omega=OMEGA, b_is_zero=True, mc=mc)
    else:
        step = k6.make_line_step(kind, shape, omega=1.0 if kind == "pcr_j" else OMEGA,
                                 b_is_zero=True, mc=mc)
    x = step.pad(torch.rand(shape, device=dev))
    for _ in range(3):  # line-Jacobi makes its two fields here
        x, _ = step(x, None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    x, r = step(x, None)
    torch.cuda.synchronize()
    field = x.numel() * x.element_size()
    assert torch.cuda.max_memory_allocated(dev) - base < field // 8
    assert bool(torch.isfinite(r))


def test_line_tile_launch_refuses_bad_settings(dev, monkeypatch):
    """The kernels check the tile settings they are handed and return an
    error the wrapper raises: threads not a multiple of a warp, or more
    than line_tile.cuh's bound."""
    x = torch.rand(8, 8, 8, device=dev)
    for threads in (48, 512):  # not a multiple of a warp; past the bound
        monkeypatch.setattr(k6, "TILE_THREADS", threads)
        with pytest.raises(RuntimeError, match="CUDA error"):
            k6.line_j(x, None, 1.0)


# ---- slice 9a: K7 (dist_rbpack) and K8 (dist_sweeps) ------------------------

# (block shape, global shape, mesh coords of the block, split axes)
DIST_BLOCKS = [
    ((16, 16, 16), (32, 32, 32), (1, 0, 1), (True, True, True)),
    ((12, 14, 16), (24, 28, 16), (0, 1, 0), (True, True, False)),
]


@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 6])
@pytest.mark.parametrize("case", range(len(DIST_BLOCKS)))
def test_k7_matches_plain_twin(dev, case, n, dtype, maf):
    """K7 against its twin on one extended block with nonzero offsets:
    float32 bitwise, float64 within 1e-14, owned residuals to rtol 1e-5."""
    from cubez_tpu_torch.cuda_kernels import dist_rbpack as k7

    bs, gs, coords, split = DIST_BLOCKS[case]
    mc = None
    if maf:
        K, I, J = gs
        mc = czt.Problem.manufactured_stretched((I, J, K), dtype=dtype,
                                                device=dev)[0].mc
    origin = tuple(c * s for c, s in zip(coords, bs))
    kern = k7.make_dist_packed_sweepnx(bs, gs, dtype, omega=OMEGA, n=n,
                                       split=split, h=12, mc=mc)
    twin = k7.make_dist_packed_sweepnx(bs, gs, dtype, omega=OMEGA, n=n,
                                       split=split, h=12, mc=mc, plain=True)
    if n == 6 and min(b for b, s in zip(bs, split) if s) < 12:
        assert kern is None
        return
    tab = kern.block_tables(origin, dev) if maf else None
    Ke, Ie, Je, I2e = k7.ext_dims(bs, kern.hs)
    gen = torch.Generator().manual_seed(7 + n)
    x = (torch.rand((2, Ke, I2e, Je), generator=gen, dtype=dtype) * 2 - 1).to(dev)
    xk, xp = x.clone(), x.clone()
    before = k7.dist_rb_sweeps.launches
    rk = kern(xk, origin, tab)
    rp = twin(xp, origin, tab)
    torch.cuda.synchronize()
    assert k7.dist_rb_sweeps.launches == before + 1
    assert float((xk - xp).abs().max()) <= (0.0 if dtype == torch.float32 else 1e-14)
    torch.testing.assert_close(rk, rp, rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_b", [False, True])
@pytest.mark.parametrize("variant", [
    ("jacobi", None, "all"), ("sor2sma", 0, "all"), ("sor2sma", 1, "all"),
    ("sor2sma", None, "all"), ("sor2sma", 0, "interior"),
    ("sor2sma", 1, "shell"),
])
def test_k8_matches_plain_twin(dev, variant, with_b, dtype):
    """K8 against its twin on a ghosted block with nonzero offsets (a
    corner block, whose faces hold the physical boundary): float32
    bitwise, float64 within 1e-14, residuals to rtol 1e-5."""
    from cubez_tpu_torch.cuda_kernels import dist_sweeps as k8

    kind, colour, region = variant
    bs, gs, origin = (10, 12, 14), (20, 24, 28), (10, 0, 14)
    gen = torch.Generator().manual_seed(11)
    x = (torch.rand(k8.block_layout(bs), generator=gen, dtype=dtype) * 2 - 1).to(dev)
    b = (torch.rand(x.shape, generator=gen, dtype=dtype) * 2 - 1).to(dev)
    b = b if with_b else None
    geom = (*origin, *gs, 1)
    keep = x.clone()
    before = k8.block_sweep.launches
    xk, rk = k8.block_sweep(x.clone() if kind != "jacobi" else x, b, kind, colour,
                            0.8, geom, region)
    xp, rp = k8.block_sweep_plain(keep.clone(), b, kind, colour, 0.8, geom, region)
    torch.cuda.synchronize()
    assert k8.block_sweep.launches == before + 1
    assert torch.equal(x, keep)  # Jacobi is out of place
    assert float((xk - xp).abs().max()) <= (0.0 if dtype == torch.float32 else 1e-14)
    torch.testing.assert_close(rk, rp, rtol=1e-5, atol=0)


@pytest.mark.parametrize("solver,sync,omega,iters", [
    ("sor2sma", "pack", OMEGA, 199), ("sor2sma_maf", "pack", OMEGA, 199),
    ("sor2sma", "color", OMEGA, 199), ("sor2sma", "overlap", OMEGA, None),
    ("jacobi", "auto", 0.8, 1015),
])
def test_solve_dist_on_cuda_matches_cpu_twin(dev, solver, sync, omega, iters):
    """solve_dist at 32^3 over (2, 2, 2) blocks on one card: the kernels
    stop where the CPU twins stop, with bitwise equal fields (the packed
    path: the serial solve's field too)."""
    from cubez_tpu_torch.cuda_kernels import dist_rbpack as k7
    from cubez_tpu_torch.cuda_kernels import dist_sweeps as k8

    maf = solver.endswith("_maf")
    g = czt.Problem.poisson_cube(32, device=dev, maf=maf)
    c = czt.Problem.poisson_cube(32, device="cpu", maf=maf)
    cg = czt.make_mesh((32, 32, 32), devices=[dev] * 8, div=(2, 2, 2))
    cc = czt.make_mesh((32, 32, 32), devices=["cpu"] * 8, div=(2, 2, 2))
    before = k7.dist_rb_sweeps.launches + k8.block_sweep.launches
    rg = czt.solve_dist(g, cg, solver, omega=omega, itr_max=10000, sync=sync)
    rc = czt.solve_dist(c, cc, solver, omega=omega, itr_max=10000, sync=sync)
    assert k7.dist_rb_sweeps.launches + k8.block_sweep.launches > before
    assert rg.iters == rc.iters and (iters is None or rg.iters == iters)
    assert torch.equal(rg.x.cpu(), rc.x)
    if sync == "pack":
        rs = czt.solve(g, solver, omega=omega, itr_max=10000)
        assert torch.equal(rg.x, rs.x)


# ---- slice 9b: K9 (dist_pcr) and K10 (pcr) ----------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_b", [False, True])
@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("color", [0, 1, None])
@pytest.mark.parametrize("shape", [(16, 16, 16), (13, 11, 18)])
def test_k10_matches_plain_twin(dev, shape, color, maf, with_b, dtype):
    """K10 against its twin (offset 1): float32 bitwise, float64 within
    1e-14, residuals to rtol 1e-5; the line-Jacobi pass never writes x."""
    from cubez_tpu_torch.cuda_kernels import pcr as k10
    from cubez_tpu_torch.cuda_kernels.rbpack import maf_tables

    tab = None
    if maf:
        K, I, J = shape
        mc = czt.Problem.manufactured_stretched((I, J, K), dtype=dtype,
                                                device=dev)[0].mc
        tab = maf_tables(mc, shape, dtype)
    gen = torch.Generator().manual_seed(21)
    x = (torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1).to(dev)
    b = (torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1).to(dev)
    b = b if with_b else None
    keep = x.clone()
    before = k10.fused_pcr.launches
    xk, rk = k10.fused_pcr(x if color is None else x.clone(), b, OMEGA, color, 1, tab)
    xp, rp = k10.fused_pcr_plain(keep.clone(), b, OMEGA, color, 1, tab)
    torch.cuda.synchronize()
    assert k10.fused_pcr.launches == before + 1
    assert torch.equal(x, keep)
    assert float((xk - xp).abs().max()) <= (0.0 if dtype == torch.float32 else 1e-14)
    torch.testing.assert_close(rk, rp, rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_b", [False, True])
@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("color", [0, 1, None])
@pytest.mark.parametrize("form", ["pcr", "fastdiag"])
def test_k9_matches_plain_twin(dev, form, color, maf, with_b, dtype):
    """K9 against its twin on a ghosted block at a nonzero origin whose
    faces hold the physical boundary: float32 bitwise, float64 within
    1e-14, residuals to rtol 1e-5."""
    from cubez_tpu_torch.cuda_kernels import dist_pcr as k9

    bs, gs, origin = {"pcr": ((10, 12, 14), (20, 24, 28), (10, 0, 14)),
                      "fastdiag": ((20, 12, 14), (20, 24, 28), (0, 12, 0))}[form]
    mc = None
    if maf:
        K, I, J = gs
        mc = czt.Problem.manufactured_stretched((I, J, K), dtype=dtype,
                                                device=dev)[0].mc
    sweep = k9.make_block_pcr(bs, gs, dtype, omega=OMEGA, color=color, offset=1,
                              b_is_zero=not with_b, maf=maf, mc=mc, solver=form)
    twin = k9.make_block_pcr(bs, gs, dtype, omega=OMEGA, color=color, offset=1,
                             b_is_zero=not with_b, maf=maf, mc=mc, solver=form,
                             plain=True)
    tab = sweep.block_tables(origin, dev) if maf else None
    gen = torch.Generator().manual_seed(23)
    shape = tuple(s + 2 for s in bs)
    x = (torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1).to(dev)
    b = (torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1).to(dev)
    keep = x.clone()
    before = k9.block_pcr.launches
    xk, rk = sweep(x if color is None else x.clone(), b, origin, tab)
    xp, rp = twin(keep.clone(), b, origin, tab)
    torch.cuda.synchronize()
    assert k9.block_pcr.launches == before + 1
    assert torch.equal(x, keep)
    assert float((xk - xp).abs().max()) <= (0.0 if dtype == torch.float32 else 1e-14)
    torch.testing.assert_close(rk, rp, rtol=1e-5, atol=0)


@pytest.mark.parametrize("solver,div,form", [
    ("pcr_rb", (2, 2, 2), "block_pcr"),
    ("pcr_rb_maf", (2, 2, 2), "block_pcr_maf"),
    ("pcr_j_esa", (2, 2, 2), "block_pcr"),
    ("pcr_rb", (1, 2, 4), "block_pcr_fastdiag"),
    ("pcr_rb_maf", (1, 2, 4), "block_pcr_fastdiag_maf"),
])
def test_solve_dist_lines_on_cuda_go_through_k9(dev, solver, div, form):
    """A float32 line solve_dist on CUDA blocks with the standard mask
    launches K9 (its launch counter, by form), stops where the CPU twins
    stop, with bitwise equal fields."""
    from cubez_tpu_torch.cuda_kernels import dist_pcr as k9

    maf = solver.endswith("_maf")
    omega = 1.0 if solver == "pcr_j_esa" else OMEGA
    g = czt.Problem.poisson_cube(32, device=dev, maf=maf)
    c = czt.Problem.poisson_cube(32, device="cpu", maf=maf)
    cg = czt.make_mesh((32, 32, 32), devices=[dev] * 8, div=div)
    cc = czt.make_mesh((32, 32, 32), devices=["cpu"] * 8, div=div)
    before = k9.block_pcr.variant_launches.get(form, 0)
    rg = czt.solve_dist(g, cg, solver, omega=omega, itr_max=10000)
    assert k9.block_pcr.variant_launches.get(form, 0) > before
    rc = czt.solve_dist(c, cc, solver, omega=omega, itr_max=10000)
    assert rg.iters == rc.iters
    assert torch.equal(rg.x.cpu(), rc.x)


def test_wrappers_never_hand_a_cuda_tensor_to_a_twin(dev, monkeypatch):
    """K9's and K10's wrappers launch their kernels for CUDA tensors: with
    every twin made to raise, the wrappers still run."""
    from cubez_tpu_torch.cuda_kernels import dist_pcr as k9
    from cubez_tpu_torch.cuda_kernels import pcr as k10

    def boom(*a, **k):
        raise AssertionError("a twin ran on a CUDA tensor")

    for mod, name in ((k10, "fused_pcr_plain"), (k10, "pcr_solve"),
                      (k10, "pcr_solve_var"), (k9, "block_pcr_plain"),
                      (k9, "pcr_solve_var"), (k9, "relax_dp")):
        monkeypatch.setattr(mod, name, boom)
    x = torch.rand(12, 10, 11, device=dev)
    for color in (0, 1, None):
        k10.fused_pcr(x.clone(), None, OMEGA, color)
        for form, gs in (("pcr", (20, 16, 22)), ("fastdiag", (10, 16, 22))):
            k9.block_pcr(x.clone(), None, form, color, OMEGA, (0, 8, 0, *gs, 0))
    torch.cuda.synchronize()


# ---- slice 10: K8 and K9 over all the blocks of the card in one launch -------

# (global shape, division): cubic blocks, K-unsplit blocks, non-cubic ones
BATCH_MESHES = [((32, 32, 32), (2, 2, 2)), ((32, 32, 32), (1, 2, 2)),
                ((24, 28, 32), (2, 2, 2))]
BATCH_VARIANTS = (
    [("k8", kind, colour, region) for kind, colour, region in (
        ("jacobi", None, "all"), ("sor2sma", 0, "all"), ("sor2sma", 1, "all"),
        ("sor2sma", None, "all"), ("sor2sma", 0, "interior"),
        ("sor2sma", 1, "shell"))]
    + [("k9", form, colour, maf) for form in ("pcr", "fastdiag")
       for colour in (0, 1, None) for maf in (False, True)])


def _dist_counters():
    from cubez_tpu_torch.cuda_kernels import dist_halo
    from cubez_tpu_torch.cuda_kernels import dist_pcr as k9
    from cubez_tpu_torch.cuda_kernels import dist_sweeps as k8

    return (k8.block_sweep.launches + k9.block_pcr.launches
            + dist_halo.halo_exchange.launches + dist_halo.fold_partials.launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mesh", range(len(BATCH_MESHES)))
@pytest.mark.parametrize("variant", BATCH_VARIANTS)
def test_batched_launch_matches_twin(dev, variant, mesh, dtype):
    """One launch over every block of the mesh on the card against the
    batched twin: float32 bitwise, float64 within 1e-14; the folded r2
    within rtol 1e-5 of the twins' (partials grouped by CTA)."""
    from cubez_tpu_torch.cuda_kernels import dist_halo
    from cubez_tpu_torch.cuda_kernels import dist_pcr as k9
    from cubez_tpu_torch.cuda_kernels import dist_sweeps as k8

    gshape, div = BATCH_MESHES[mesh]
    cm = czt.make_mesh(gshape, devices=[dev] * (div[0] * div[1] * div[2]), div=div)
    bshape = cm.block_shape(gshape)
    origins = cm.offsets(gshape)
    gen = torch.Generator().manual_seed(31 + mesh)
    shape = tuple(v + 2 for v in bshape)
    xs = [(torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1).to(dev)
          for _ in origins]
    bs = [(torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1).to(dev)
          for _ in origins]
    keep = [x.clone() for x in xs]
    res = dist_halo.Residual(dev)
    res.start()
    before = k8.block_sweep.launches + k9.block_pcr.launches
    if variant[0] == "k8":
        _, kind, colour, region = variant
        got = k8.sweep_blocks([x.clone() for x in xs] if kind != "jacobi" else xs,
                              bs, kind, colour, 0.8, origins, gshape, 1, region,
                              res=res)
        want, r2s = k8.sweep_blocks_plain([x.clone() for x in keep], bs, kind,
                                          colour, 0.8, origins, gshape, 1, region)
    else:
        _, form, colour, maf = variant
        if form == "fastdiag" and div[0] != 1:
            form = "pcr"
        tabs = None
        if maf:
            mc = czt.Problem.manufactured_stretched(
                (gshape[1], gshape[2], gshape[0]), dtype=dtype, device=dev)[0].mc
            tabs = [k9.block_maf_tables(mc, o, bshape, gshape, dtype, form).to(dev)
                    for o in origins]
        got = k9.pcr_blocks([x.clone() for x in xs] if colour is not None else xs,
                            bs, form, colour, OMEGA, origins, gshape, 1, tabs,
                            res=res)
        want, r2s = k9.pcr_blocks_plain([x.clone() for x in keep], bs, form,
                                        colour, OMEGA, origins, gshape, 1, tabs)
    r2 = res.total()
    torch.cuda.synchronize()
    assert k8.block_sweep.launches + k9.block_pcr.launches == before + 1
    assert all(torch.equal(x, k) for x, k in zip(xs, keep))  # out of place
    tol = 0.0 if dtype == torch.float32 else 1e-14
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= tol
    torch.testing.assert_close(r2, sum(r2s), rtol=1e-5, atol=0)


@pytest.mark.parametrize("mesh", range(len(BATCH_MESHES)))
def test_exchange_and_fold_kernels_match_twins(dev, mesh):
    """The exchange kernel (one launch, and gather then scatter through
    the staging buffer) against its twin, bitwise, edges untouched; the
    fold against its twin within rtol 1e-15."""
    from cubez_tpu_torch.cuda_kernels import dist_halo
    from cubez_tpu_torch.parallel.halo import FaceExchange

    gshape, div = BATCH_MESHES[mesh]
    cm = czt.make_mesh(gshape, devices=[dev] * (div[0] * div[1] * div[2]), div=div)
    table = [[-1 if (nb := cm.neighbor(b, f // 2, 1 if f % 2 else -1)) is None
              else nb for f in range(6)] for b in range(cm.size)]
    gen = torch.Generator().manual_seed(41)
    shape = tuple(v + 2 for v in cm.block_shape(gshape))
    xs = [torch.rand(shape, generator=gen).to(dev) for _ in range(cm.size)]
    want = dist_halo.halo_exchange_plain([x.clone() for x in xs], table)
    before = dist_halo.halo_exchange.launches
    got = FaceExchange(cm)([x.clone() for x in xs])
    ex = FaceExchange(cm)
    split = [x.clone() for x in xs]
    ex.collect(split)
    ex.write(split)
    torch.cuda.synchronize()
    assert dist_halo.halo_exchange.launches == before + 3
    for w, g, s_ in zip(want, got, split):
        assert torch.equal(g, w) and torch.equal(s_, w)
    p = torch.rand(3001, generator=gen).to(dev)
    got = float(dist_halo.fold_partials(p, 3001))
    want = float(dist_halo.fold_partials_plain(p.cpu()))
    assert abs(got - want) <= 1e-15 * want


# (solver, sync, omega, division, the step's launches: exchange, sweep, fold)
STEP_LAUNCHES = [("sor2sma", "color", OMEGA, (2, 2, 2), 5),
                 ("sor2sma", "iter", OMEGA, (2, 2, 2), 3),
                 ("sor2sma", "overlap", OMEGA, (2, 2, 2), 9),
                 ("jacobi", "auto", 0.8, (2, 2, 2), 3),
                 ("pcr_rb", "auto", OMEGA, (2, 2, 2), 5),
                 ("pcr_rb_maf", "auto", OMEGA, (2, 2, 2), 5),
                 ("pcr_j_esa", "auto", 1.0, (2, 2, 2), 3),
                 ("pcr_rb", "auto", OMEGA, (1, 2, 2), 5),
                 ("pcr_j_esa", "auto", 1.0, (1, 2, 2), 3)]


def _dist_step(name, sync, omega, cm, p):
    from cubez_tpu_torch.parallel import dist_fused

    kind = {"sor2sma": "sor2sma", "jacobi": "jacobi", "pcr_j_esa": "pcr"}.get(
        name, "pcr_rb")
    if sync == "overlap":
        return dist_fused.make_dist_fused_overlap_step(p, cm, omega, b_is_zero=True)
    return dist_fused.make_dist_fused_step(
        p, cm, kind, omega, b_is_zero=True, sync="iter" if sync == "iter" else "color")


@pytest.mark.parametrize("path", STEP_LAUNCHES)
def test_dist_step_launch_count(dev, path):
    """One step of each dist path on eight (four) blocks of the card makes
    exactly its launches (the wrappers' counters: exchange, K8/K9, fold);
    with the edge ghosts poisoned by NaN its field and r2 are finite and
    equal to the clean run's."""
    from cubez_tpu_torch.parallel import dist_fused

    name, sync, omega, div, launches = path
    p = czt.Problem.poisson_cube(32, device=dev, maf=name.endswith("_maf"))
    cm = czt.make_mesh((32, 32, 32), devices=[dev] * (div[0] * div[1] * div[2]),
                       div=div)
    step, poisoned = (_dist_step(name, sync, omega, cm, p) for _ in range(2))
    clean = dist_fused.to_block_state(cm, p.x0)
    dirty = [x.clone() for x in clean]
    for x in dirty:
        e = torch.zeros(x.shape, dtype=torch.int32)
        for ax in range(3):
            idx = [slice(None)] * 3
            for end in (0, -1):
                idx[ax] = end
                e[tuple(idx)] += 1
        x[(e >= 2).to(dev)] = float("nan")
    clean, _ = step(clean, None)  # the first call makes the buffers
    dirty, _ = poisoned(dirty, None)
    torch.cuda.synchronize()
    before = _dist_counters()
    clean, r_c = step(clean, None)
    torch.cuda.synchronize()
    assert _dist_counters() - before == launches
    dirty, r_d = poisoned(dirty, None)
    own = (slice(1, -1),) * 3
    assert torch.isfinite(r_d) and torch.equal(r_c, r_d)
    for a, b in zip(clean, dirty):
        assert torch.isfinite(b[own]).all() and torch.equal(a[own], b[own])


@pytest.mark.parametrize("solver,div", [("sor2sma", (2, 2, 2)),
                                        ("pcr_rb", (2, 2, 2)),
                                        ("pcr_rb", (1, 2, 2))])
def test_dist_solves_are_deterministic(dev, solver, div):
    """Two identical dist solves on the card give bitwise equal histories
    and fields (the fold sums in a fixed order, no atomics)."""
    p = czt.Problem.poisson_cube(32, device=dev)
    cm = czt.make_mesh((32, 32, 32), devices=[dev] * (div[0] * div[1] * div[2]),
                       div=div)
    kw = dict(omega=OMEGA, itr_max=10000,
              sync="color" if solver == "sor2sma" else "auto")
    r1 = czt.solve_dist(p, cm, solver, **kw)
    r2 = czt.solve_dist(p, cm, solver, **kw)
    assert r1.iters == r2.iters
    assert torch.equal(r1.history, r2.history) and torch.equal(r1.x, r2.x)
