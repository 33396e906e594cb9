"""Spans and counters of the port's solves: the one recorder of the program.

A solve is recorded when torch.profiler is recording at the entry of
``solvers.api.solve`` (or ``parallel.api.solve_dist``), or when it runs
inside ``recording()``; the choice is made once, there (``begin``).  While
a solve is recorded, ``current`` is its ``Recorder``; otherwise it is None,
and every span site in the program is one ``is None`` test of it: no span,
no CUDA event, no ``record_function``, nothing allocated.

A span has a name, a start and an end on the host's clock
(``time.perf_counter_ns``), a parent (the span open below it) and the
solve's id.  While the profiler records, each span is also a
``record_function`` range of the same name, so the program's spans sit in
the chrome trace on the clock of the device's records; inside the root
range ``cz.solve`` an empty range ``cz.solve_id=<id>`` names the solve's
record (torch's chrome trace drops a range's args).  Step calls are the
spans of ``steps.labeled``, named after their solver; their range is
entered through ``torch.profiler.record_function``, as the label always
was, and the other spans' through ``torch.autograd.profiler.record_function``
(the same class).

Every device-to-host wait on a solve's path goes through ``wait``.  On the
card a recorded solve records a CUDA event just before each wait blocks
(the end of the work queued before it), and a second one at the first span
entered after it (the first work queued after), or at the next wait where
one comes first; the device's idle across the solve's syncs is the sum of
``elapsed_time`` over those pairs, read at the solve's end from a pool of
events reused by every solve.  The last wait of a solve has no second
event and is not counted.  The replay of ``run_iterative``'s stopping
chunk (the span ``cz.replay``) is timed on the card the same way, by an
event pair from the same pool around its sweeps.

The solve's spans: ``cz.route`` (solvers/api.py, parallel/api.py: the
route's making), ``cz.layout`` (``pre`` of the start and the right-hand
side, and ``post``: the colour pack or the diagonal skew and back),
``cz.chunk`` with ``cz.snapshot`` inside, ``cz.check``, and ``cz.stop``
with ``cz.replay`` inside (solvers/driver.py); the Krylov loops'
``cz.iter``, ``cz.fetch``, ``cz.precon``, ``cz.ax`` and ``cz.blas``
(solvers/bicgstab.py, solvers/cg.py).

Per solve the recorder keeps aggregates (``SolveRecord``), not the spans:
per span name its calls, total and self time (total less its child
spans') and the names of its parents; the waits and their host time; the
device idle across them; the relaxation sweeps run (``run_iterative``'s
chunks and replayed singles), the replayed ones on their own and their
device time; and the launches the kernel wrappers counted
over the solve (``LAUNCH_COUNTERS``).  The last ``KEEP`` solves are kept;
``solves()`` lists them, newest last.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib
import itertools
import time

import torch

KEEP = 10_000
ROOT = "cz.solve"  # the root span of a solve

# the kernel wrappers' launch counters (``<wrapper>.launches``, by module of
# cubez_tpu_torch.cuda_kernels), read at a recorded solve's start and end
LAUNCH_COUNTERS = (
    ("rbpack", ("rb_sweeps_n", "rb_single")),
    ("sweeps", ("jacobi_k4", "sor2sma_k4")),
    ("rblines", ("rbl",)),
    ("lines", ("line_j", "line_rb")),
    ("pcr", ("fused_pcr",)),
    ("psor", ("psor_diag",)),
    ("pcr_gs", ("pcr_gs_diag",)),
    ("dist_rbpack", ("dist_rb_sweeps", "exchange_packed")),
    ("dist_sweeps", ("block_sweep",)),
    ("dist_pcr", ("block_pcr",)),
    ("dist_halo", ("halo_exchange", "fold_partials")),
)

current = None  # the Recorder of the solve being recorded, else None
_forced = 0  # depth of recording()
_done = collections.deque(maxlen=KEEP)
_ids = itertools.count(1)
_pools = {}  # device -> CUDA events with timing, reused by every solve


@dataclasses.dataclass(frozen=True)
class SpanStats:
    calls: int
    total_ns: int
    self_ns: int
    parents: frozenset  # names of the spans it was entered under


@dataclasses.dataclass(frozen=True)
class SolveRecord:
    """A finished recorded solve.  ``sync_idle_s`` and ``replay_s`` are
    None off the card (a wait on the host's own tensors is no device
    sync).  ``replayed`` counts the sweeps of the stop's replay, a part of
    ``sweeps``; ``replay_s`` is the device time between its event pair, 0
    where no sweep was replayed."""
    id: int
    iters: int
    wall_ns: int  # the root span
    spans: dict  # name -> SpanStats
    steps: tuple  # names of the step-call spans (steps.labeled)
    syncs: int
    wait_ns: int  # host time blocked in the waits
    sync_idle_s: float | None
    sync_pairs: int
    sweeps: int
    launches: int
    replayed: int
    replay_s: float | None

    def step_self_ns(self) -> int:
        return sum(self.spans[n].self_ns for n in self.steps)


def launch_count() -> int:
    """The kernel wrappers' launches so far, summed over LAUNCH_COUNTERS."""
    n = 0
    for mod, names in LAUNCH_COUNTERS:
        m = importlib.import_module(f"cubez_tpu_torch.cuda_kernels.{mod}")
        n += sum(getattr(m, name).launches for name in names)
    return n


class Recorder:
    """The spans and counters of one solve (see the module docstring).
    The open spans are kept in parallel lists, and the event pairs in two,
    so that a span or a wait makes no new container for the collector to
    scan."""

    def __init__(self, sid: int, device, profiled: bool):
        self.id = sid
        self.profiled = profiled
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.current_stream(self.device)
            self.pool = _pools.setdefault(self.device, [])
        # the open spans: name, start, time of their closed children, range
        self.names, self.starts, self.child, self.ranges = [], [], [], []
        self.stats = {}  # name -> [calls, total_ns, self_ns, parent names]
        self.steps = set()
        self.syncs = self.wait_ns = self.sweeps = 0
        self.events = 0  # events of the pool recorded by this solve
        self.before, self.after = [], []  # the events of each wait's pair
        self.replay_from, self.replay_to = [], []  # the replays' event pairs
        self.replayed = 0
        self.pending = None  # the event of a wait that awaits its pair
        self.launches0 = launch_count()

    def _record(self):
        if self.events == len(self.pool):
            self.pool.append(torch.cuda.Event(enable_timing=True))
        ev = self.pool[self.events]
        self.events += 1
        ev.record(self.stream)
        return ev

    def enter(self, name: str, step: bool = False):
        """Open a span ``name`` under the open one; ``step`` marks a step
        call (``steps.labeled``)."""
        if self.pending is not None:
            self.before.append(self.pending)
            self.after.append(self._record())
            self.pending = None
        rng = None
        if self.profiled:
            if step:
                rng = torch.profiler.record_function(name)
            else:
                rng = torch.autograd.profiler.record_function(name)
            rng.__enter__()
        if step:
            self.steps.add(name)
        self.names.append(name)
        self.ranges.append(rng)
        self.child.append(0)
        self.starts.append(time.perf_counter_ns())

    def exit(self, n: int = 1):
        """Close the ``n`` innermost open spans."""
        for _ in range(n):
            dur = time.perf_counter_ns() - self.starts.pop()
            rng = self.ranges.pop()
            if rng is not None:
                rng.__exit__(None, None, None)
            name, child = self.names.pop(), self.child.pop()
            st = self.stats.get(name)
            if st is None:
                st = self.stats[name] = [0, 0, 0, set()]
            st[0] += 1
            st[1] += dur
            st[2] += dur - child
            if self.names:
                self.child[-1] += dur
                st[3].add(self.names[-1])

    def wait(self, fn, *args):
        """``fn(*args)``, a call that waits for the device, counted and
        timed; on the card an event marks the work queued before it."""
        self.syncs += 1
        if self.cuda:
            ev = self._record()
            if self.pending is not None:
                self.before.append(self.pending)
                self.after.append(ev)
            self.pending = ev
        t = time.perf_counter_ns()
        out = fn(*args)
        self.wait_ns += time.perf_counter_ns() - t
        return out

    def replay_begin(self, sweeps: int):
        """Count the ``sweeps`` the stop replays; on the card an event
        marks the work queued before them."""
        self.sweeps += sweeps
        self.replayed += sweeps
        if self.cuda:
            self.replay_from.append(self._record())

    def replay_end(self):
        """On the card an event marks the end of the replay's work."""
        if self.cuda:
            self.replay_to.append(self._record())

    def finish(self, iters: int, wall_ns: int) -> SolveRecord:
        """The solve's record, its spans closed: the event pairs are read
        here, after the solve's last wait."""
        idle = replay = None
        if self.cuda:
            if self.after:
                self.after[-1].synchronize()
            idle = 1e-3 * sum(map(torch.cuda.Event.elapsed_time,
                                  self.before, self.after))
            if self.replay_to:
                self.replay_to[-1].synchronize()
            replay = 1e-3 * sum(map(torch.cuda.Event.elapsed_time,
                                    self.replay_from, self.replay_to))
        return SolveRecord(
            id=self.id, iters=iters, wall_ns=wall_ns,
            spans={k: SpanStats(c, t, s, frozenset(p))
                   for k, (c, t, s, p) in self.stats.items()},
            steps=tuple(sorted(self.steps)), syncs=self.syncs,
            wait_ns=self.wait_ns, sync_idle_s=idle,
            sync_pairs=len(self.after), sweeps=self.sweeps,
            launches=launch_count() - self.launches0,
            replayed=self.replayed, replay_s=replay)


def wait(fn, *args):
    """``fn(*args)``, a device-to-host wait on a solve's path: counted by
    the recorded solve, if any."""
    rec = current
    if rec is None:
        return fn(*args)
    return rec.wait(fn, *args)


def begin(device):
    """Open the root span ``ROOT`` of a solve on ``device`` where the solve
    is to be recorded (a profiler records, or inside ``recording()``), and
    no solve is being recorded already: its Recorder, else None."""
    global current
    if current is not None:
        return None
    profiled = torch.autograd._profiler_enabled()
    if not (_forced or profiled):
        return None
    rec = current = Recorder(next(_ids), device, profiled)
    rec.enter(ROOT)
    if profiled:
        with torch.autograd.profiler.record_function(f"{ROOT}_id={rec.id}"):
            pass
    return rec


def end(rec: Recorder, iters: int | None):
    """Close ``rec``'s solve: its record is kept, or with ``iters`` None (the
    solve raised) dropped, the spans it left open closed."""
    global current
    current = None
    if iters is None:
        while rec.ranges:
            rng = rec.ranges.pop()
            if rng is not None:
                rng.__exit__(None, None, None)
        return
    rec.exit(len(rec.names))
    _done.append(rec.finish(iters, rec.stats[ROOT][1]))


@contextlib.contextmanager
def recording():
    """Record the solves that start inside this block, with or without a
    profiler."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def solves() -> list:
    """The kept SolveRecords, newest last."""
    return list(_done)


def report(r: SolveRecord) -> str:
    """A solve's spans and counters as text (the CLI's spans.txt)."""
    lines = [f"solve {r.id}: {r.iters} iterations, {r.wall_ns * 1e-6:.3f} ms",
             f"{'span':<24}{'calls':>8}{'total ms':>12}{'self ms':>12}  parents"]
    for name, s in sorted(r.spans.items(), key=lambda kv: -kv[1].total_ns):
        lines.append(f"{name:<24}{s.calls:>8}{s.total_ns * 1e-6:>12.3f}"
                     f"{s.self_ns * 1e-6:>12.3f}  {','.join(sorted(s.parents))}")
    idle = ("not measured (no CUDA device)" if r.sync_idle_s is None
            else f"{r.sync_idle_s * 1e3:.3f}")
    per_launch = (f"{r.step_self_ns() * 1e-3 / r.launches:.2f}" if r.launches
                  else "no kernel launches")
    per_iter = f"{r.sweeps / r.iters:.4f}" if r.sweeps and r.iters else "-"
    replay = ("not measured (no CUDA device)" if r.replay_s is None
              else f"{r.replay_s * 1e3:.3f}")
    lines += [f"syncs: {r.syncs} (host wait {r.wait_ns * 1e-6:.3f} ms)",
              f"sync idle ms: {idle}",
              f"host us a launch: {per_launch} ({r.launches} launches)",
              f"sweeps an iteration: {per_iter} ({r.sweeps} sweeps)",
              f"replayed: {r.replayed} sweeps, device ms {replay}"]
    return "\n".join(lines) + "\n"
