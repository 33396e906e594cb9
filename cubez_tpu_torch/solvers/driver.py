"""Iteration driver: the while loop and convergence logic of cz_Poisson.cpp
(PyTorch port of ``cubez_tpu/solvers/driver.py``).

Residual definition (cz_Poisson.cpp:67-71, cz_Evaluate.cpp:222-224):
    res = sqrt(sum(dp^2 over inner) / N_inner),  stop when res < eps.
The default eps = 1.0e-5 matches cz.h:162.
"""

from __future__ import annotations

import dataclasses

import torch

from ..perf import spans
from ..utils.history import write_history

EPS_DEFAULT = 1.0e-5


@dataclasses.dataclass
class SolveResult:
    x: torch.Tensor
    iters: int
    res: float
    # residual per iteration, float64, length == iters, on x's device
    history: torch.Tensor

    def write_history(self, path):
        """History file in the reference's format (cz_Evaluate.cpp:217,
        cz_Poisson.cpp:71)."""
        write_history(path, self.history)


def run_iterative(step, x0, b, res_normal: float, itr_max: int,
                  eps: float = EPS_DEFAULT, check_every: int | None = None,
                  pre=None, post=None) -> SolveResult:
    """Run a relaxation sweep ``step(x, b) -> (x, r2)`` to convergence.

    Chunked loop: ``check_every`` sweeps run back to back, their residual
    sums go into a history kept on the device, and one host sync per chunk
    decides whether to stop.  The stopping iteration is recovered exactly
    from the recorded per-sweep residuals (the first sweep with r2 below
    eps^2 / res_normal, else itr_max), so counts and histories do not
    depend on ``check_every``.  The field does not either: the stopping
    chunk is replayed from its start with ``step.single`` (a one-iteration
    step on the same layout) up to the stopping sweep.

    ``check_every`` None means the step's ``check_every_default`` where it
    has one (the exact serial orders: 1, a sweep being far longer than a
    host sync), else 16 for CUDA tensors (the JAX package's TPU default: a
    host sync costs more than a sweep) and 1 elsewhere; it is rounded up
    to whole calls of a multi-iteration step (``step.iters_per_call``).  ``pre``/``post`` convert to and from the
    step's state layout; ``pre`` must return new tensors, because steps may
    update their state in place.  The state may also be a list of tensors
    (the blocks of a distributed solve); the history then lives on the
    first block's device.

    In a recorded solve (perf/spans.py) the layout conversions are spans
    ``cz.layout`` (``pre`` of x0 and b, and ``post``), each chunk a span
    ``cz.chunk`` (the snapshot copy ``cz.snapshot``, the step calls, the
    history writes), its stop test ``cz.check``, and the end ``cz.stop``
    (the stopping sweep, the replay ``cz.replay``, the history, ``post``);
    the sweeps run, the replay's included, are counted, the replay's
    sweeps also on their own and on the card timed by a CUDA event pair
    (``Recorder.replay_begin``/``replay_end``), and the host syncs go
    through ``spans.wait``.
    """
    if itr_max < 1:
        raise ValueError("itr_max must be >= 1")
    first = x0[0] if isinstance(x0, list) else x0
    if check_every is None:
        check_every = getattr(step, "check_every_default", None) or (
            16 if first.is_cuda else 1)
    ipc = getattr(step, "iters_per_call", 1)
    single = getattr(step, "single", step)
    chunk = max(ipc, -(-check_every // ipc) * ipc)
    # never a chunk longer than the whole run
    chunk = min(chunk, -(-itr_max // ipc) * ipc)
    total = -(-itr_max // chunk) * chunk
    rec = spans.current
    x = x0
    if pre is not None:
        if rec is not None:
            rec.enter("cz.layout")
        x, b = pre(x0), pre(b)
        if rec is not None:
            rec.exit()
    hist = torch.zeros(total, dtype=torch.float64, device=first.device)
    # res >= eps  <=>  r2 >= eps^2 / res_normal
    thresh = eps * eps / res_normal
    snap = _like(x)
    done = 0
    while done < total:
        if rec is not None:
            rec.enter("cz.chunk")
            rec.enter("cz.snapshot")
        _copy(snap, x)  # the field at the start of this chunk
        if rec is not None:
            rec.exit()
        for c in range(done, done + chunk, ipc):
            x, r2 = step(x, b)
            hist[c:c + ipc] = r2
        done += chunk
        if rec is not None:
            rec.sweeps += chunk
            rec.exit()
            rec.enter("cz.check")
        stop = (hist[done - chunk:done] < thresh).any()
        if rec is None:
            stop = bool(stop)
        else:
            stop = rec.wait(bool, stop)
            rec.exit()
        if stop:
            break
    if rec is not None:
        rec.enter("cz.stop")
    ran = min(done, itr_max)
    below = spans.wait(torch.nonzero, hist[:ran] < thresh)
    iters = spans.wait(int, below[0, 0]) + 1 if below.numel() else ran
    if iters < done:
        x = snap
        replay = iters - (done - chunk)
        if rec is not None:
            rec.enter("cz.replay")
            rec.replay_begin(replay)
        for _ in range(replay):
            x, _ = single(x, b)
        if rec is not None:
            rec.replay_end()
            rec.exit()
    res_hist = torch.sqrt(hist[:iters] * res_normal)
    if post is not None:
        if rec is not None:
            rec.enter("cz.layout")
        x = post(x)
        if rec is not None:
            rec.exit()
    res = spans.wait(float, res_hist[-1])
    if rec is not None:
        rec.exit()
    return SolveResult(x=x, iters=iters, res=res, history=res_hist)


def _like(x):
    if isinstance(x, list):
        return [torch.empty_like(t) for t in x]
    return torch.empty_like(x)


def _copy(dst, src):
    if isinstance(dst, list):
        for d, s in zip(dst, src):
            d.copy_(s)
    else:
        dst.copy_(src)


def fixed_sweeps(step, x, b, count: int):
    """``count`` sweeps without convergence checks (the preconditioner mode,
    cz_Poisson.cpp:66,280); multi-iteration steps round the count up to
    whole calls."""
    ipc = getattr(step, "iters_per_call", 1)
    for _ in range(-(-count // ipc)):
        x, _ = step(x, b)
    return x
