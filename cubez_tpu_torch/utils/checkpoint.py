"""Checkpoint / restart of long solves (PyTorch port of
``cubez_tpu/utils/checkpoint.py``; an extension beyond the reference,
which dumps only the final field).

A checkpoint is a portable ``.npz`` of the canonical (K, I, J) field and
the solve's metadata, with the JAX package's keys and ``FORMAT_VERSION``,
so a checkpoint written by either package loads in the other.  The field
is saved from any device as a numpy array and restored onto the device of
the problem it resumes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

FORMAT_VERSION = 1


def _numpy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save(path, x, *, solver: str, iters: int, res: float, omega: float,
         eps: float, history=None) -> None:
    """Write a restart checkpoint of the (K, I, J) solution field."""
    np.savez_compressed(
        str(path),
        version=FORMAT_VERSION,
        x=_numpy(x),
        solver=str(solver),
        iters=int(iters),
        res=float(res),
        omega=float(omega),
        eps=float(eps),
        history=_numpy(history if history is not None else []),
    )


@dataclasses.dataclass(frozen=True)
class Checkpoint:
    x: np.ndarray
    solver: str
    iters: int
    res: float
    omega: float
    eps: float
    history: np.ndarray


def load(path) -> Checkpoint:
    """Read a checkpoint; ValueError for another format version."""
    with np.load(str(path), allow_pickle=False) as z:
        ver = int(z["version"])
        if ver != FORMAT_VERSION:
            raise ValueError(f"checkpoint version {ver} != {FORMAT_VERSION}")
        return Checkpoint(
            x=z["x"],
            solver=str(z["solver"]),
            iters=int(z["iters"]),
            res=float(z["res"]),
            omega=float(z["omega"]),
            eps=float(z["eps"]),
            history=z["history"],
        )


def _continue(problem, ckpt: Checkpoint, itr_max, solver, omega, eps):
    """The problem with the checkpoint's field as x0 (in the problem's
    dtype, on its device; ValueError for another shape), the solve's
    arguments (the checkpoint's omega and eps where not given) and the
    solver name."""
    if ckpt.x.shape != problem.grid.shape_kij:
        raise ValueError(
            f"checkpoint shape {ckpt.x.shape} != problem "
            f"{problem.grid.shape_kij}"
        )
    x0 = torch.tensor(ckpt.x, dtype=problem.grid.dtype,
                      device=problem.x0.device)
    prob = dataclasses.replace(problem, x0=x0)
    return prob, dict(
        omega=omega if omega is not None else ckpt.omega,
        itr_max=itr_max,
        eps=eps if eps is not None else ckpt.eps,
    ), solver or ckpt.solver


def resume(problem, ckpt: Checkpoint, itr_max: int, *,
           solver: Optional[str] = None, omega: Optional[float] = None,
           eps: Optional[float] = None, **kw):
    """Continue a checkpointed solve for up to ``itr_max`` more iterations
    (``solve``'s other arguments in ``kw``).  Returns the SolveResult of
    the continuation; the caller stitches histories if needed.  ``fmg``
    refuses the restarted interior (ValueError); ``mg`` resumes."""
    from ..solvers.api import solve

    prob, args, name = _continue(problem, ckpt, itr_max, solver, omega, eps)
    return solve(prob, name, **args, **kw)


def resume_dist(problem, cmesh, ckpt: Checkpoint, itr_max: int, *,
                solver: Optional[str] = None, omega: Optional[float] = None,
                eps: Optional[float] = None, **kw):
    """Distributed continuation of a checkpointed solve over ``cmesh``.
    The checkpoint holds the global field, so a solve checkpointed on one
    mesh (or serially) resumes on any other."""
    from ..parallel.api import solve_dist

    prob, args, name = _continue(problem, ckpt, itr_max, solver, omega, eps)
    return solve_dist(prob, cmesh, name, **args, **kw)
