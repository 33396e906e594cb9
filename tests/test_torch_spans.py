"""The port's spans and counters (cubez_tpu_torch/perf/spans.py) on the CPU,
and on the card the device's idle across the host syncs.

The card's test is marked ``cuda`` and skips without one; this file imports
no JAX:

    python -m pytest --noconftest -q tests/test_torch_spans.py
"""

import dataclasses
import json

import pytest
import torch

import cubez_tpu_torch as czt
from cubez_tpu_torch.cli import main
from cubez_tpu_torch.cuda_kernels import rbpack
from cubez_tpu_torch.perf import spans
from cubez_tpu_torch.solvers import steps
from cubez_tpu_torch.solvers.fused_cache import get_fused_step

torch.set_num_threads(1)

OMEGA = 1.5
ROOT = "cz.solve"


def _recorded(fn):
    """(fn's result, the record of the one solve it ran) under recording()."""
    before = len(spans.solves())
    with spans.recording():
        out = fn()
    got = spans.solves()
    assert len(got) == min(before + 1, spans.KEEP)
    return out, got[-1]


def _check_nesting(rec):
    """Every span has self <= total and a chain of parents down to the
    root, which has none and is entered once."""
    assert set(rec.spans[ROOT].parents) == set()
    assert rec.spans[ROOT].calls == 1 and rec.wall_ns == rec.spans[ROOT].total_ns
    for name, s in rec.spans.items():
        assert 0 <= s.self_ns <= s.total_ns <= rec.wall_ns, name
        assert s.calls >= 1
        seen, todo = set(), set(s.parents)
        while todo:
            p = todo.pop()
            seen.add(p)
            todo |= set(rec.spans[p].parents) - seen
        assert name == ROOT or ROOT in seen, name


def _launches():
    return sum(getattr(m, n).launches for m, names in (
        (rbpack, ("rb_sweeps_n", "rb_single")),) for n in names)


@pytest.mark.parametrize("n", (8, 16))
def test_sor2sma_syncs_sweeps_and_spans(n, monkeypatch):
    """A recorded sor2sma solve counts a sync a chunk check, the stop's
    three (the stopping sweep, its index, the last residual) and the
    route's one (the zero RHS check); the chunks' sweeps and the replay;
    one span a chunk, a snapshot and a check each; the step calls' launches
    as the wrappers count them."""
    plain = rbpack.packed_sweeps_plain

    def launching(*args):  # a launch of K3/K1's wrapper, counted as on the card
        rbpack.rb_sweeps_n.launches += 1
        return plain(*args)

    monkeypatch.setattr(rbpack, "packed_sweeps_plain", launching)
    p = czt.Problem.poisson_cube(n, device="cpu")
    ipc = get_fused_step("sor2sma", p.grid, OMEGA, b_is_zero=True).iters_per_call
    before = _launches()
    r, rec = _recorded(lambda: czt.solve(p, "sor2sma", omega=OMEGA,
                                         itr_max=10000))
    chunk = ipc  # CPU tensors check every call
    checks = -(-r.iters // chunk)
    replay = r.iters - (checks - 1) * chunk
    replay = 0 if replay == chunk else replay
    assert rec.iters == r.iters > chunk
    assert rec.syncs == checks + 3 + 1
    assert rec.sweeps == checks * chunk + replay
    for name in ("cz.chunk", "cz.snapshot", "cz.check"):
        assert rec.spans[name].calls == checks
    assert rec.spans["cz.stop"].calls == rec.spans["cz.route"].calls == 1
    assert rec.steps == ("sor2sma",)
    assert rec.spans["sor2sma"].calls == checks + replay
    if replay:  # the stop's replay has a span of its own, inside cz.stop
        assert rec.spans["sor2sma"].parents == {"cz.chunk", "cz.replay"}
        assert rec.spans["cz.replay"].parents == {"cz.stop"}
    else:
        assert rec.spans["sor2sma"].parents == {"cz.chunk"}
    assert rec.replayed == replay
    assert rec.spans["cz.snapshot"].parents == {"cz.chunk"}
    assert rec.spans["cz.check"].parents == {ROOT}
    assert rec.launches == _launches() - before == checks + replay
    assert rec.sync_idle_s is None and rec.sync_pairs == 0  # no card
    _check_nesting(rec)
    assert rec.wait_ns > 0


def test_krylov_fetch_once_an_iteration():
    """pbicgstab and cg record one cz.iter and one cz.fetch an iteration, a
    sync each and the first rho's; the vector operations are spans inside
    the iteration, the preconditioner's steps inside cz.precon."""
    p = czt.Problem.poisson_cube(8, device="cpu")
    r, rec = _recorded(lambda: czt.solve(p, "pbicgstab", omega=1.1,
                                         itr_max=100, precond="sor2sma"))
    assert r.iters >= 2 and rec.iters == r.iters
    assert rec.spans["cz.fetch"].calls == rec.spans["cz.iter"].calls == r.iters
    assert rec.spans["cz.fetch"].parents == {"cz.iter"}
    assert rec.syncs == r.iters + 1
    assert rec.spans["cz.precon"].calls == 2 * r.iters
    assert rec.spans["cz.ax"].calls == 2 * r.iters + 1  # and rk's
    assert rec.spans["sor2sma"].parents == {"cz.precon"}
    assert rec.spans["sor2sma"].calls == 2 * r.iters * 8 // 2  # pairs
    assert rec.sweeps == 0
    _check_nesting(rec)
    r, rec = _recorded(lambda: czt.solve(p, "cg", omega=0.8, itr_max=100,
                                         precond="jacobi"))
    assert rec.spans["cz.fetch"].calls == rec.spans["cz.iter"].calls == r.iters
    assert rec.syncs == r.iters + 1
    _check_nesting(rec)


def test_solve_dist_is_recorded():
    p = czt.Problem.poisson_cube(8, device="cpu")
    cm = czt.make_mesh(p.grid.shape_kij, devices=["cpu"] * 8, div=(2, 2, 2))
    r, rec = _recorded(lambda: czt.solve_dist(p, cm, "jacobi", omega=0.8,
                                              itr_max=30))
    assert rec.iters == r.iters == 30
    assert {"cz.route", "cz.chunk", "cz.check", "jacobi"} <= set(rec.spans)
    _check_nesting(rec)
    r, rec = _recorded(lambda: czt.solve_dist(p, cm, "pbicgstab", omega=1.1,
                                              itr_max=4, precond="jacobi"))
    assert rec.spans["cz.fetch"].calls == r.iters
    _check_nesting(rec)


def test_off_path_enters_nothing(monkeypatch):
    """With no profiler and no recording(), a solve opens no recorder,
    enters no record_function and makes no CUDA event."""
    entered, events = [], []
    rf = torch.autograd.profiler.record_function
    enter = rf.__enter__

    def counting(self):
        entered.append(self.name)
        return enter(self)

    def no_recorder(*a, **k):
        raise AssertionError("a recorder was made")

    monkeypatch.setattr(rf, "__enter__", counting)
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: events.append(1))
    monkeypatch.setattr(spans, "Recorder", no_recorder)
    before, seen = steps.labeled.entered, spans.solves()
    p = czt.Problem.poisson_cube(8, device="cpu")
    assert czt.solve(p, "sor2sma", omega=OMEGA, itr_max=20).iters == 16
    czt.solve(p, "pbicgstab", omega=1.1, itr_max=3, precond="sor2sma")
    assert entered == [] and events == []
    assert steps.labeled.entered == before and spans.solves() == seen
    assert spans.current is None


def test_raising_solve_is_dropped():
    """A recorded solve that raises keeps no record and leaves no recorder
    open."""
    p = czt.Problem.poisson_cube(8, device="cpu")
    x0 = p.x0.clone()
    x0[4, 4, 4] = 1.0
    bad = dataclasses.replace(p, x0=x0)
    seen = spans.solves()
    with spans.recording(), pytest.raises(ValueError, match="fmg"):
        czt.solve(bad, "fmg", omega=1.0, itr_max=3)
    assert spans.current is None and spans.solves() == seen


def test_spans_under_the_profiler():
    """Under torch.profiler a solve's spans are record_function ranges,
    nested in the root's."""
    p = czt.Problem.poisson_cube(8, device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        r = czt.solve(p, "sor2sma", omega=OMEGA, itr_max=10000)
    rec = spans.solves()[-1]
    assert rec.iters == r.iters
    evs = prof.events()
    root = [e.time_range for e in evs if e.name == ROOT]
    assert len(root) == 1
    named = [e.time_range for e in evs if e.name == f"{ROOT}_id={rec.id}"]
    assert len(named) == 1
    assert root[0].start <= named[0].start <= named[0].end <= root[0].end
    for name in ("cz.chunk", "cz.check", "cz.snapshot", "cz.stop", "sor2sma"):
        got = [e.time_range for e in evs if e.name == name]
        assert len(got) == rec.spans[name].calls, name
        assert all(root[0].start <= t.start and t.end <= root[0].end
                   for t in got), name


def test_cli_profile_writes_trace_and_span_table(tmp_path, monkeypatch, capsys):
    """--profile at 8^3 also writes profile_trace.json, with the program's
    spans, and spans.txt, their table and the counters."""
    monkeypatch.chdir(tmp_path)
    assert main(["8", "8", "8", "sor2sma", "100", "1.5", "--device", "cpu",
                 "--profile"]) == 0
    assert "profile_trace.json and spans.txt written" in capsys.readouterr().out
    trace = json.loads((tmp_path / "profile_trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {ROOT, "cz.route", "cz.chunk", "cz.check", "cz.stop",
            "sor2sma"} <= names
    text = (tmp_path / "spans.txt").read_text()
    assert text.startswith("solve ") and "16 iterations" in text
    for head in ("cz.chunk ", "sor2sma ", "syncs: 7", "sync idle ms: ",
                 "host us a launch: ", "sweeps an iteration: 1.3750"):
        assert head in text, head
    assert (tmp_path / "profiling.txt").exists()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_sync_idle_pairs_on_the_card(dev, monkeypatch):
    """On the card every event pair of a recorded solve reads a positive
    idle, and their sum is at most the solve's wall time."""
    got = []
    finish = spans.Recorder.finish

    def reading(self, iters, wall_ns):
        torch.cuda.synchronize(dev)
        got.extend(a.elapsed_time(b) for a, b in zip(self.before, self.after))
        return finish(self, iters, wall_ns)

    monkeypatch.setattr(spans.Recorder, "finish", reading)
    p = czt.Problem.poisson_cube(64, device=dev)
    czt.solve(p, "sor2sma", omega=OMEGA, itr_max=10000)  # build, warm
    r, rec = _recorded(lambda: czt.solve(p, "sor2sma", omega=OMEGA,
                                         itr_max=10000))
    assert rec.iters == r.iters and rec.launches > 0
    assert rec.sync_pairs == rec.syncs - 1 == len(got)
    assert all(ms > 0 for ms in got)
    assert 0 < rec.sync_idle_s <= rec.wall_ns * 1e-9
    assert rec.sync_idle_s == pytest.approx(1e-3 * sum(got))
