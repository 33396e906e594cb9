#!/usr/bin/env python3
"""The JAX package's pbicgstab with the exact serial orders as its
preconditioner, against the port's, on the CPU: the evidence for the fault
of the reference package that ROADMAP.md records (its
cubez_tpu/solvers/bicgstab.py hands the unskewed Krylov vector to the
skewed psor/pcr diagonal step, with no ``_pre``/``_post``).

    python3 tools/jax_precond_fault.py [N]

Default N = 16, float64, omega 1.1, eps 1e-5, itr_max 200: pbicgstab with
the preconditioners psor, pcr and sor2sma, in the JAX package (impl
"jnp") and in the port (the twins on the CPU).  Prints one line per run
and the counts and final residuals as one JSON object on the last line.
CPU only; about half a minute.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import cubez_tpu_torch as czt  # noqa: E402
from cubez_tpu import Problem, solve  # noqa: E402

PRECONDS = ("psor", "pcr", "sor2sma")


def main(n: int = 16):
    torch.set_num_threads(2)
    out = {}
    for precond in PRECONDS:
        rj = solve(Problem.poisson_cube(n, dtype=jnp.float64), "pbicgstab",
                   omega=1.1, itr_max=200, precond=precond, impl="jnp")
        rt = czt.solve(czt.Problem.poisson_cube(n, dtype=torch.float64,
                                                device="cpu"),
                       "pbicgstab", omega=1.1, itr_max=200, precond=precond)
        out[precond] = {"jax": [int(rj.iters), float(rj.res)],
                        "port": [rt.iters, rt.res]}
        print(f"pbicgstab {n}^3 f64 omega 1.1 precond {precond}: JAX package "
              f"{int(rj.iters)} iterations, residual {float(rj.res):.3e}; port "
              f"{rt.iters} iterations, residual {rt.res:.3e}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:2]))
