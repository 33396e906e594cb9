#!/usr/bin/env python3
"""Iteration counts, last residual and Error max of the JAX package's
extensions on the reference's Laplace problem, float32, eps 1e-5: the
reference that ``chip_smoke.py`` holds the port's mg, fmg and fd solves
to.

    python3 tools/jax_ext_counts.py [N]

Default N = 128: mg, mg_maf, fmg, fmg_maf, fd and fd_maf at omega 1.0
(``solve``; the JAX package's XLA smoother off a TPU), and pbicgstab with
mg and cg with fd as preconditioners.  The relaxation solves run with
``check_every=1``, so the returned field is the one at the stopping
iteration (a chunked JAX solve returns the field at the end of its
stopping chunk) and Error max is comparable with the port's, which
replays to the stop.  The solves run under ``jax.disable_jit()``: op by
op, the JAX package's own solve takes seconds where compiling its
unrolled V-cycle takes XLA minutes on a CPU.  Prints one line per solve
and the results as one JSON object on the last line.  CPU only.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from cubez_tpu import Problem, solve  # noqa: E402
from cubez_tpu.core.grid import max_error_loc  # noqa: E402

SOLVES = (("mg", None), ("mg_maf", None), ("fmg", None), ("fmg_maf", None),
          ("fd", None), ("fd_maf", None), ("pbicgstab", "mg"), ("cg", "fd"))


def main(argv):
    n = int(argv[0]) if argv else 128
    out = {}
    for name, precond in SOLVES:
        prob = Problem.poisson_cube(n, dtype=jnp.float32,
                                    maf=name.endswith("_maf"))
        kw = {"precond": precond} if precond else {"check_every": 1}
        t0 = time.perf_counter()
        with jax.disable_jit():
            r = solve(prob, name, omega=1.0, itr_max=100, **kw)
        key = f"{name}+{precond}" if precond else name
        err = float(max_error_loc(prob.grid, r.x)[0])
        out[key] = [int(r.iters), float(r.res), err]
        print(f"{key} {n}^3 f32: {r.iters} iterations, res {float(r.res):e}, "
              f"Error max {err:e} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    print(json.dumps({"n": n, "iters_res_err": out}))


if __name__ == "__main__":
    main(sys.argv[1:])
