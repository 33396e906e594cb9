"""The Krylov loop's vector passes (cuda_kernels/blas.py, csrc/blas.cu): on
the CPU, where VectorOps and the dispatch route the maps and dots, and
that the loop's results are the old op sequence's bit for bit; on the
card, each map pass against its plain twin (ops/blas.py) bit for bit, each
dot against torch's sum to its rounding and bit for bit run to run, and
whole Krylov solves on the passes against the plain solves.

Tests marked ``cuda`` skip where ``torch.cuda.is_available()`` is false
(decided inside the tests, not at import).  This file imports no JAX, so it
runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_vector_pass_cuda.py
"""

import math
import re

import pytest
import torch

import cubez_tpu_torch as czt
from cubez_tpu_torch.cuda_kernels import blas as cblas
from cubez_tpu_torch.ops import blas
from cubez_tpu_torch.parallel import krylov
from cubez_tpu_torch.perf import spans
from cubez_tpu_torch.solvers import bicgstab

torch.set_num_threads(1)

# scalars as the loop hands them over, 0-d tensors of the field's dtype
ALPHA, BETA, OMEGA = 0.7310585786300049, -1.2599210498948732, 0.4142135623730951
SHAPES = [(37, 41, 29), (64, 96, 200)]  # one CTA wave and less; several
MAPS = ("bicg_1", "triad", "axpy")
DOTS = ("dot1", "dot2", "dots_t", "update_xr")
OPS = MAPS + DOTS
# dots against torch's sum, relative to the sum of the terms' magnitudes
DOT_RTOL = {torch.float64: 1e-13, torch.float32: 1e-5}
INT = {torch.float64: torch.int64, torch.float32: torch.int32}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _fields(shape, dtype, device, n=6, seed=11, low=-1.0):
    """(fields, msk): ``n`` fields uniform in [low, 1) over the whole array,
    boundary shell included, and the standard inner mask."""
    K, I, J = shape
    gen = torch.Generator().manual_seed(seed)
    fs = [(torch.rand(shape, generator=gen, dtype=dtype) * (1 - low) + low)
          .to(device) for _ in range(n)]
    msk = czt.Problem.poisson_cube((I, J, K), dtype=dtype, device="cpu").msk
    return fs, msk.to(device)


def _scalars(dtype, device):
    return {k: torch.tensor(v, dtype=dtype, device=device)
            for k, v in (("alpha", ALPHA), ("beta", BETA), ("omega", OMEGA))}


def _call(fns, op, f, msk, sc, *impl):
    """``fns``'s ``op`` (cuda_kernels/blas.py's or ops/blas.py's) on the
    fields ``f`` and scalars ``sc``, as a tuple of its results."""
    a, b, o = sc["alpha"], sc["beta"], sc["omega"]
    args = {"bicg_1": (f[0], f[1], f[2], b, o), "triad": (f[0], f[1], a),
            "axpy": (f[0], a, f[1]), "dot1": (f[0],), "dot2": (f[0], f[1]),
            "dots_t": (f[0], f[1]),
            "update_xr": (f[0], f[1], f[2], f[3], f[4], f[5], a, o)}[op]
    out = getattr(fns, op)(*args, msk, *impl)
    return out if isinstance(out, tuple) else (out,)


def _same_bits(a, b) -> bool:
    """a and b bit for bit where neither is NaN, NaN at the same points."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(na, nb)
            and torch.equal(a.view(INT[a.dtype])[~na], b.view(INT[b.dtype])[~nb]))


# ---- on the CPU: the routes ---------------------------------------------------


@pytest.mark.parametrize("impl", ["auto", "plain"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", OPS)
def test_cpu_fields_take_the_plain_twin(op, dtype, impl):
    """On CPU fields every vector op of cuda_kernels/blas.py is ops/blas.py's
    function of the same name, bit for bit, and launches no pass."""
    f, msk = _fields((9, 10, 11), dtype, "cpu")
    sc = _scalars(dtype, "cpu")
    before = cblas.vector_pass.launches
    by_op = dict(cblas.vector_pass.op_launches)
    got = _call(cblas, op, f, msk, sc, impl)
    want = _call(blas, op, f, msk, sc)
    assert len(got) == len(want)
    assert all(_same_bits(g, w) for g, w in zip(got, want))
    assert cblas.vector_pass.launches == before
    assert cblas.vector_pass.op_launches == by_op


@pytest.mark.parametrize("forced", ["auto", "plain"])
def test_vector_impl_keeps_cpu_fields_on_the_twin_and_restores(forced):
    """Inside ``vector_impl`` CPU fields still take the twin, with no
    launch; the forced impl is left again on leaving the block, an error
    too, and an inner block gives the outer one's back."""
    f, msk = _fields((9, 10, 11), torch.float64, "cpu")
    sc = _scalars(torch.float64, "cpu")
    before = cblas.vector_pass.launches
    with cblas.vector_impl(forced):
        assert cblas._vector_impl == forced
        got = _call(cblas, "update_xr", f, msk, sc, "auto")
        with cblas.vector_impl("plain"):
            assert cblas._vector_impl == "plain"
        assert cblas._vector_impl == forced
    assert cblas._vector_impl is None
    want = _call(blas, "update_xr", f, msk, sc)
    assert all(_same_bits(g, w) for g, w in zip(got, want))
    assert cblas.vector_pass.launches == before
    with pytest.raises(ZeroDivisionError):
        with cblas.vector_impl(forced):
            1 / 0
    assert cblas._vector_impl is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_twins_are_the_old_op_sequence(dtype):
    """ops/blas.py's dots_t and update_xr compose the ops the loop ran one
    by one before, in the same order, so their values are those ops'."""
    f, msk = _fields((9, 10, 11), dtype, "cpu")
    sc = _scalars(dtype, "cpu")
    t, s = f[0], f[1]
    got = blas.dots_t(t, s, msk)
    assert all(_same_bits(g, w) for g, w in
               zip(got, (blas.dot2(t, s, msk), blas.dot1(t, msk))))
    a, o = sc["alpha"], sc["omega"]
    x = blas.bicg_2(f[0], f[1], f[2], a, o, msk)
    r = blas.triad(f[3], f[4], -o, msk)
    want = (x, r, blas.dot1(r, msk), blas.dot2(r, f[5], msk))
    got = blas.update_xr(*f, a, o, msk)
    assert all(_same_bits(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("impl", ["auto", "plain"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_vector_ops_on_cpu_fields_are_the_old_sequence(dtype, impl):
    """VectorOps's ops and its fused methods on CPU fields give the values of
    the ops/blas.py sequence the loop ran before, bit for bit, and launch
    nothing."""
    prob = czt.Problem.poisson_cube((10, 11, 9), dtype, device="cpu")
    ops = bicgstab.VectorOps(prob, None, lambda v: v, impl)
    f, _ = _fields((9, 10, 11), dtype, "cpu")
    f = [v * prob.msk for v in f]
    msk = prob.msk
    sc = _scalars(dtype, "cpu")
    a, b, o = sc["alpha"], sc["beta"], sc["omega"]
    before = cblas.vector_pass.launches
    x = blas.bicg_2(f[0], f[1], f[2], a, o, msk)
    r = blas.triad(f[3], f[4], -o, msk)
    pairs = [
        (ops.dot1(f[0]), blas.dot1(f[0], msk)),
        (ops.dot2(f[0], f[1]), blas.dot2(f[0], f[1], msk)),
        (ops.triad(f[0], f[1], a), blas.triad(f[0], f[1], a, msk)),
        (ops.bicg_1(f[0], f[1], f[2], b, o), blas.bicg_1(f[0], f[1], f[2], b, o, msk)),
        (ops.axpy(f[0], a, f[1]), f[0] + blas.scalar(a, f[0]) * f[1] * msk),
        *zip(ops.dots_t(f[0], f[1]), (blas.dot2(f[0], f[1], msk), blas.dot1(f[0], msk))),
        *zip(ops.update_xr(*f, a, o),
             (x, r, blas.dot1(r, msk), blas.dot2(r, f[5], msk))),
    ]
    assert all(_same_bits(g, w) for g, w in pairs)
    assert cblas.vector_pass.launches == before


def test_block_ops_keep_their_per_block_path(monkeypatch):
    """BlockOps (parallel/krylov.py) runs every op a block at a time through
    its ``_map`` and ``_dot``, the fused ones too, and never reaches
    cuda_kernels/blas.py's vector ops: its values are the composed
    per-block sequence's."""
    for name in OPS:
        def refuse(*args, name=name):
            raise AssertionError(f"BlockOps reached cuda_kernels/blas.py's {name}")
        monkeypatch.setattr(cblas, name, refuse)
    prob = czt.Problem.poisson_cube(16, torch.float64, device="cpu")
    cm = czt.make_mesh((16, 16, 16), devices=["cpu"] * 8, div=(2, 2, 2))
    blk = krylov.BlockOps(prob, cm, None, lambda v: v)
    f, _ = _fields((16, 16, 16), torch.float64, "cpu")
    v = [cm.shard(t * prob.msk) for t in f]
    sc = _scalars(torch.float64, "cpu")
    a, b, o = sc["alpha"], sc["beta"], sc["omega"]
    calls = {"_map": 0, "_dot": 0}
    for name in calls:
        fn = getattr(blk, name)

        def counted(*args, fn=fn, name=name):
            calls[name] += 1
            return fn(*args)

        monkeypatch.setattr(blk, name, counted)
    x, r, rr, rr0 = blk.update_xr(*v, a, o)
    ts, tt = blk.dots_t(v[0], v[1])
    p = blk.bicg_1(v[0], v[1], v[2], b, o)
    # three maps and four dots, each dot a _map of the blocks' partials
    assert calls == {"_map": 3 + 4, "_dot": 4}
    mbs = cm.shard(prob.msk)
    want_x = [blas.bicg_2(*bs, a, o, m) for *bs, m in zip(v[0], v[1], v[2], mbs)]
    want_r = [blas.triad(*bs, -o, m) for *bs, m in zip(v[3], v[4], mbs)]
    assert all(torch.equal(g, w) for g, w in zip(x, want_x))
    assert all(torch.equal(g, w) for g, w in zip(r, want_r))
    assert torch.equal(rr, blk._dot(blas.dot1, want_r))
    assert torch.equal(rr0, blk._dot(blas.dot2, want_r, v[5]))
    assert torch.equal(ts, blk._dot(blas.dot2, v[0], v[1]))
    assert torch.equal(tt, blk._dot(blas.dot1, v[0]))
    assert all(torch.equal(g, w) for g, w in zip(
        p, [blas.bicg_1(*bs, b, o, m) for *bs, m in zip(v[0], v[1], v[2], mbs)]))


def _old_bicgstab(ops, x0, b, itr_max, eps, res_normal):
    """The BiCGSTAB loop as it ran its ops one by one before dots_t and
    update_xr (history and x; no breakdown at these sizes)."""
    n = max(int(itr_max) - 1, 1)
    hist = []
    one = ops.scalar(1.0)
    rho_old, alpha, omega = one, ops.scalar(0.0), one
    x = x0
    r = ops.rk(x0, b)
    r0, p, q = r, None, None
    rho = ops.dot2(r, r0)
    res, itr = math.inf, 0
    while itr < n and (itr == 0 or res >= eps):
        if itr == 0:
            p = r
        else:
            beta = rho / rho_old * alpha / omega
            p = ops.bicg_1(p, r, q, beta, omega)
        p_ = ops.precon(p)
        q = ops.ax(p_)
        alpha = rho / bicgstab._guard(ops.dot2(q, r0), one)
        s = ops.triad(q, r, -alpha)
        s_ = ops.precon(s)
        t_ = ops.ax(s_)
        omega = ops.dot2(t_, s) / bicgstab._guard(ops.dot1(t_), one, absolute=False)
        x = ops.bicg_2(x, p_, s_, alpha, omega)
        r = ops.triad(t_, s, -omega)
        res_t = torch.sqrt(ops.dot1(r).to(torch.float64) * res_normal)
        hist.append(res_t)
        rho_old, rho = rho, ops.dot2(r, r0)
        res = float(res_t)
        itr += 1
    return torch.stack(hist), x


@pytest.mark.parametrize("precond", ["sor2sma", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_bicgstab_history_is_the_old_loops(dtype, precond):
    """run_bicgstab on CPU fields gives the history and field of the loop
    that ran its vector ops one by one, bit for bit."""
    prob = czt.Problem.poisson_cube(20, dtype, device="cpu")
    ops = bicgstab.VectorOps(prob, None,
                             bicgstab.make_precon(prob, precond, 1.1))
    args = (prob.x0, prob.rhs, 4000, 1e-5, prob.grid.res_normal)
    got = bicgstab.run_bicgstab(ops, *args)
    hist, x = _old_bicgstab(ops, *args)
    assert got.iters == len(hist) > 2 and got.res < 1e-5
    assert torch.equal(got.history, hist) and torch.equal(got.x, x)


def test_recorded_cpu_bicgstab_spans_the_fused_methods_as_blas():
    """In a recorded solve the fused methods are ``cz.blas`` spans like the
    other vector ops: 5 an iteration (bicg_1 from the second, dot2, triad,
    dots_t, update_xr) with the start's dot2, and the start's two
    ``scalar`` calls."""
    prob = czt.Problem.poisson_cube(24, torch.float64, device="cpu")
    with spans.recording():
        r = czt.solve(prob, "pbicgstab", omega=1.1, itr_max=4000,
                      precond="sor2sma")
    rec = spans.solves()[-1]
    assert rec.iters == r.iters > 2
    assert rec.spans["cz.blas"].calls == 5 * r.iters + 2
    assert rec.spans["cz.ax"].calls == 2 * r.iters + 1


def _refusals(f, msk, sc):
    """(exception, message, call) of what vector_pass must refuse, for
    fields ``f`` and scalars ``sc`` that it would take."""
    def strided(t):  # t's values at t's shape, not contiguous
        return torch.stack([t, t], dim=-1)[..., 0]

    p, q, r = f[:3]
    b, o = sc["beta"], sc["omega"]
    vp = cblas.vector_pass
    return [
        (TypeError, "float32 or float64",
         lambda: vp("dot2", (p.half(), q.half()), (), msk.half())),
        (ValueError, "contiguous", lambda: vp("dot2", (strided(p), q), (), msk)),
        (ValueError, "contiguous", lambda: vp("dot2", (p, q), (), strided(msk))),
        (ValueError, "contiguous",
         lambda: vp("bicg_1", (p, r, strided(q)), (b, o), msk)),
        (ValueError, "must match", lambda: vp("dot2", (p, q[:-1]), (), msk)),
        (ValueError, "must match", lambda: vp("dot1", (p,), (), msk.float())),
        (ValueError, "must match",
         lambda: vp("bicg_1", (p, r, q.float()), (b, o), msk)),
        (ValueError, "(K, I, J)", lambda: vp("dot1", (p[0],), (), msk[0])),
        (ValueError, "0-d scalars",
         lambda: vp("bicg_1", (p, r, q), (b.reshape(1), o), msk)),
        (TypeError, "takes 3 fields and 2 scalars",
         lambda: vp("bicg_1", (p, r), (b, o), msk)),
    ]


@pytest.mark.parametrize("case", range(10))
def test_vector_pass_refuses_before_launching(case):
    """The pass's checks run before it loads the kernels: each refusal on
    CPU fields raises and launches nothing."""
    f, msk = _fields((6, 7, 8), torch.float64, "cpu")
    exc, match, call = _refusals(f, msk, _scalars(torch.float64, "cpu"))[case]
    before = cblas.vector_pass.launches
    with pytest.raises(exc, match=re.escape(match)):
        call()
    assert cblas.vector_pass.launches == before


# ---- on the card -------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", MAPS + ("update_xr",))
def test_map_pass_is_bitwise_its_twin(dev, op, dtype, shape):
    """Each map (update_xr's x and r too) equals ops/blas.py's function on
    the same CUDA fields bit for bit, with a NaN on the boundary shell of
    every field propagated where the twin propagates it; one pass a call,
    into new fields."""
    f, msk = _fields(shape, dtype, dev)
    K, I, J = shape
    for i, v in enumerate(f):  # a NaN on the shell of each field
        v[0 if i % 2 else K - 1, i % I, (3 * i) % J] = float("nan")
    sc = _scalars(dtype, dev)
    before = cblas.vector_pass.launches
    got = _call(cblas, op, f, msk, sc)
    torch.cuda.synchronize()
    assert cblas.vector_pass.launches == before + 1
    want = _call(blas, op, f, msk, sc)
    maps = 2 if op == "update_xr" else 1
    for g, w in zip(got[:maps], want[:maps]):
        assert g.data_ptr() not in [v.data_ptr() for v in (*f, msk)]
        assert torch.isnan(g).any() and _same_bits(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", DOTS)
def test_dot_pass_is_torch_sum_to_rounding_and_repeatable(dev, op, dtype, shape):
    """Each dot of a pass is within DOT_RTOL of the twin's torch ``sum``,
    relative to the sum of its terms' magnitudes (the sum itself for dot1),
    and the same bits in a second call; update_xr's and dots_t's fields and
    dots equal the composed plain sequence's (maps bitwise, dots to the
    same tolerance)."""
    f, msk = _fields(shape, dtype, dev)
    sc = _scalars(dtype, dev)
    got = _call(cblas, op, f, msk, sc)
    again = _call(cblas, op, f, msk, sc)
    want = _call(blas, op, f, msk, sc)
    torch.cuda.synchronize()
    n_dot = {"dot1": 1, "dot2": 1, "dots_t": 2, "update_xr": 2}[op]
    maps = len(want) - n_dot
    assert all(_same_bits(g, w) for g, w in zip(got[:maps], want[:maps]))
    # the dots' terms, as the twin forms them (update_xr's of its new r)
    t = f[0]
    terms = {"dot1": lambda: [t * t], "dot2": lambda: [t * f[1]],
             "dots_t": lambda: [t * f[1], t * t],
             "update_xr": lambda: [want[1] * want[1], want[1] * f[5]]}[op]()
    for g, a, w, tm in zip(got[maps:], again[maps:], want[maps:], terms):
        assert g.dim() == 0 and g.dtype == dtype and g.device == t.device
        assert _same_bits(g, a)
        scale = float((tm * msk).abs().sum())
        assert abs(float(g) - float(w)) <= DOT_RTOL[dtype] * scale, (float(g), float(w))


def _true_res(prob, x) -> float:
    """sqrt(sum (b - A x)^2 over inner nodes * res_normal) in float64."""
    r = blas.calc_rk(x.double(), prob.rhs.double(), prob.msk.double())
    return math.sqrt(float((r * r).sum()) * prob.grid.res_normal)


@pytest.mark.cuda
def test_pbicgstab_64_on_the_passes_against_the_plain_solve(dev):
    """A 64^3 float64 pbicgstab with the sor2sma preconditioner on the passes
    stops at the plain solve's count, its history within rtol 1e-10 of the
    plain one's over the first 8 entries (the dots' summation order alone
    differs), the true residual of its field below eps; 5 vector passes an
    iteration, none in the plain solve."""
    prob = czt.Problem.poisson_cube(64, torch.float64, device=dev)
    runs = {}
    for impl in ("auto", "plain"):
        before = cblas.vector_pass.launches
        r = czt.solve(prob, "pbicgstab", omega=1.1, itr_max=4000,
                      precond="sor2sma", impl=impl)
        torch.cuda.synchronize()
        runs[impl] = (r, cblas.vector_pass.launches - before)
    (ra, na), (rp, np_) = runs["auto"], runs["plain"]
    assert ra.iters == rp.iters > 2 and ra.res < 1e-5
    assert (na, np_) == (5 * ra.iters, 0)
    ha, hp = ra.history[:8], rp.history[:8]
    head = ((ha - hp).abs() / hp.abs()).max()
    assert float(head) <= 1e-10
    assert _true_res(prob, ra.x) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pbicgstab_on_the_passes_repeats_bit_for_bit(dev, dtype):
    """Two pbicgstab solves on the passes give the same count, history and
    field bit for bit: the dots are fixed-order sums."""
    prob = czt.Problem.poisson_cube(48, dtype, device=dev)
    a, b = (czt.solve(prob, "pbicgstab", omega=1.1, itr_max=4000,
                      precond="sor2sma") for _ in range(2))
    torch.cuda.synchronize()
    assert a.iters == b.iters > 2
    assert torch.equal(a.history, b.history) and torch.equal(a.x, b.x)


@pytest.mark.cuda
@pytest.mark.parametrize("solver,precond,omega,per_iter,once", [
    # bicg_1 from the second iteration, the start's dot2
    ("pbicgstab", "sor2sma", 1.1,
     {"bicg_1": 1, "dot2": 1, "triad": 1, "dots_t": 1, "update_xr": 1},
     {"bicg_1": -1, "dot2": 1}),
    # dot2 twice, axpy, triad twice, dot1; the start's dot2
    ("cg", "jacobi", 0.8, {"dot2": 2, "axpy": 1, "triad": 2, "dot1": 1},
     {"dot2": 1}),
])
def test_vector_pass_launches_per_iteration(dev, solver, precond, omega,
                                            per_iter, once):
    """The passes a Krylov solve launches, in all and pass by pass:
    pbicgstab 5 an iteration (the start's dot2 in place of the first
    bicg_1), cg 6 and its start's dot2."""
    prob = czt.Problem.poisson_cube(32, torch.float64, device=dev)
    before = cblas.vector_pass.launches
    by_op = dict(cblas.vector_pass.op_launches)
    r = czt.solve(prob, solver, omega=omega, itr_max=4000, precond=precond)
    torch.cuda.synchronize()
    assert r.iters > 2 and r.res < 1e-5
    assert (cblas.vector_pass.launches - before
            == sum(per_iter.values()) * r.iters + sum(once.values()))
    got = {op: n - by_op[op] for op, n in cblas.vector_pass.op_launches.items()}
    assert got == {op: per_iter.get(op, 0) * r.iters + once.get(op, 0)
                   for op in got}


@pytest.mark.cuda
def test_vector_impl_routes_the_vector_ops_alone(dev):
    """A solve under 'plain' inside ``vector_impl('auto')`` runs its vector
    work on the passes and its operator on the twin; a solve under 'auto'
    inside ``vector_impl('plain')`` the other way round."""
    prob = czt.Problem.poisson_cube(32, torch.float64, device=dev)
    counts = {}
    for impl, forced in (("plain", "auto"), ("auto", "plain")):
        vp, ax = cblas.vector_pass.launches, cblas.operator_pass.launches
        with cblas.vector_impl(forced):
            r = czt.solve(prob, "pbicgstab", omega=1.1, itr_max=4000,
                          precond="sor2sma", impl=impl)
        torch.cuda.synchronize()
        counts[impl] = (r.iters, cblas.vector_pass.launches - vp,
                        cblas.operator_pass.launches - ax)
    (ip, vp, ap), (ia, va, aa) = counts["plain"], counts["auto"]
    assert ip > 2 and (vp, ap) == (5 * ip, 0)
    assert ia > 2 and (va, aa) == (0, 2 * ia + 1)


@pytest.mark.cuda
def test_vector_pass_refuses_what_it_cannot_take(dev):
    """Every CPU refusal holds on the card, and fields or a mask on another
    device are refused too, before a launch."""
    f, msk = _fields((6, 7, 8), torch.float64, dev)
    sc = _scalars(torch.float64, dev)
    before = cblas.vector_pass.launches
    for exc, match, call in _refusals(f, msk, sc):
        with pytest.raises(exc, match=re.escape(match)):
            call()
    with pytest.raises(ValueError, match="must match"):
        cblas.dot2(f[0], f[1].cpu(), msk)
    with pytest.raises(ValueError, match="must match"):
        cblas.triad(f[0], f[1], sc["alpha"], msk.cpu())
    assert cblas.vector_pass.launches == before
