"""The spans of the stop's replay and of the layout conversions
(cubez_tpu_torch/perf/spans.py, solvers/driver.py): ``cz.replay`` with the
record's ``replayed`` and ``replay_s``, and ``cz.layout``.

The card's test is marked ``cuda`` and skips without one; this file imports
no JAX:

    python -m pytest --noconftest -q tests/test_torch_spans_replay.py
"""

import pytest
import torch

import cubez_tpu_torch as czt
from cubez_tpu_torch.perf import spans
from cubez_tpu_torch.solvers.driver import run_iterative

torch.set_num_threads(1)

ROOT = "cz.solve"
IPC = 3  # the toy step's sweeps a call
CHUNK = 6  # check_every, two calls


def _halving(device):
    """A toy step of IPC sweeps a call, each halving x, with r2 = x^2 after
    each; its ``single`` one sweep.  From x = 1, sweep k leaves 2^-k and
    r2 4^-k."""
    def step(x, b):
        r2 = torch.empty(IPC, dtype=torch.float64, device=device)
        for s in range(IPC):
            x = x * 0.5
            r2[s] = x * x
        return x, r2

    def single(x, b):
        x = x * 0.5
        return x, x * x

    step.iters_per_call, step.single = IPC, single
    return step


def _toy_solve(device, eps):
    """The toy solve under a recorder of its own: (result, record)."""
    x0 = torch.ones((), dtype=torch.float64, device=device)
    with spans.recording():
        rec = spans.begin(device)
        r = run_iterative(_halving(device), x0, None, 1.0, 100, eps=eps,
                          check_every=CHUNK)
        spans.end(rec, r.iters)
    return r, spans.solves()[-1]


# r2 of sweep k is 4^-k: eps^2 = 2^-21 stops at sweep 11, inside the second
# chunk (sweeps 7-12), so 11 - 6 = 5 sweeps are replayed; eps^2 = 2^-23
# stops at 12, the chunk's last sweep, and nothing is replayed
STOP_INSIDE, STOP_AT_END = 2.0 ** -10.5, 2.0 ** -11.5


def test_replay_span_and_count_off_the_card():
    r, rec = _toy_solve("cpu", STOP_INSIDE)
    assert r.iters == rec.iters == 11
    assert float(r.x) == 2.0 ** -11  # the stopping sweep's field
    start = (r.iters - 1) // CHUNK * CHUNK  # the stopping chunk's start
    assert rec.replayed == r.iters - start == 5
    assert rec.sweeps == 2 * CHUNK + rec.replayed
    assert rec.spans["cz.replay"].calls == 1
    assert rec.spans["cz.replay"].parents == {"cz.stop"}
    assert rec.replay_s is None  # no device timing off the card
    assert "cz.layout" not in rec.spans  # no pre, no post


def test_no_replay_where_the_stop_ends_a_chunk():
    r, rec = _toy_solve("cpu", STOP_AT_END)
    assert r.iters == rec.iters == 12
    assert rec.replayed == 0 and rec.sweeps == 2 * CHUNK
    assert "cz.replay" not in rec.spans
    assert rec.replay_s is None


@pytest.mark.parametrize("solver,omega", (("pcr", 1.5), ("sor2sma", 1.5)))
def test_layout_spans(solver, omega):
    """The skew (pcr) or the colour pack (sor2sma) of the start and the
    right-hand side, under the root, and the conversion back, under the
    stop: two calls of cz.layout."""
    p = czt.Problem.poisson_cube(8, device="cpu")
    with spans.recording():
        r = czt.solve(p, solver, omega=omega, itr_max=10000)
    rec = spans.solves()[-1]
    assert rec.iters == r.iters > 1
    assert rec.spans["cz.layout"].calls == 2
    assert rec.spans["cz.layout"].parents == {ROOT, "cz.stop"}
    if solver == "pcr":  # a sweep a call and a check a call on the CPU
        assert rec.replayed == 0 and "cz.replay" not in rec.spans


def test_report_names_the_replay():
    _, rec = _toy_solve("cpu", STOP_INSIDE)
    text = spans.report(rec)
    assert "replayed: 5 sweeps, device ms not measured" in text


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_replay_time_on_the_card(dev):
    """On the card the replay's event pair reads a positive time below the
    solve's wall, and 0 where the stop ends a chunk; a 64^3 pcr solve on
    P2 replays the stopping launch's sweeps up to its stop."""
    _toy_solve(dev, STOP_INSIDE)  # warm
    r, rec = _toy_solve(dev, STOP_INSIDE)
    assert rec.replayed == 5
    assert 0 < rec.replay_s < rec.wall_ns * 1e-9
    r, rec = _toy_solve(dev, STOP_AT_END)
    assert rec.replayed == 0 and rec.replay_s == 0
    p = czt.Problem.poisson_cube(64, device=dev)
    czt.solve(p, "pcr", omega=1.5, itr_max=10000)  # build, warm
    with spans.recording():
        r = czt.solve(p, "pcr", omega=1.5, itr_max=10000)
    rec = spans.solves()[-1]
    chunk = rec.sweeps - rec.replayed
    assert rec.iters == r.iters and chunk >= r.iters
    if rec.replayed:
        assert 0 < rec.replay_s < rec.wall_ns * 1e-9
        assert rec.spans["cz.replay"].calls == 1
    else:
        assert rec.replay_s == 0
