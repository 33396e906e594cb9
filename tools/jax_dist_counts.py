#!/usr/bin/env python3
"""Iteration counts and Error max of the JAX package's distributed line
solves on its explicit jnp steps (``solve_dist(..., impl="jnp")``,
parallel/dist.py's ``make_dist_step``) over a block mesh of virtual CPU
devices: the reference that ``chip_smoke.py`` holds the port's K-split
dist line solves to.

    python3 tools/jax_dist_counts.py [N] [dz dx dy]

Default N = 64 over (2, 2, 2): pcr_rb and pcr_rb_maf at omega 1.5 and
pcr_j_esa at omega 1.0, float32, eps 1e-5.  Prints one line per solver
and the counts and Error max as one JSON object on the last line.  CPU
only; about 20 s at 64^3, some minutes at 128^3.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from cubez_tpu import Problem  # noqa: E402
from cubez_tpu.core.grid import max_error_loc  # noqa: E402
from cubez_tpu.parallel.api import solve_dist  # noqa: E402
from cubez_tpu.parallel.mesh import make_mesh  # noqa: E402

SOLVES = (("pcr_rb", 1.5), ("pcr_rb_maf", 1.5), ("pcr_j_esa", 1.0))


def main(argv):
    n = int(argv[0]) if argv else 64
    div = tuple(int(v) for v in argv[1:4]) if len(argv) >= 4 else (2, 2, 2)
    ndev = div[0] * div[1] * div[2]
    counts, errs = {}, {}
    for name, omega in SOLVES:
        prob = Problem.poisson_cube(n, dtype=jnp.float32,
                                    maf=name.endswith("_maf"))
        cm = make_mesh((n, n, n), devices=jax.devices("cpu")[:ndev], div=div)
        t0 = time.perf_counter()
        r = solve_dist(prob, cm, name, omega=omega, itr_max=20000, impl="jnp")
        counts[name] = int(r.iters)
        errs[name] = float(max_error_loc(prob.grid, r.x)[0])
        print(f"{name} {n}^3 over {div} omega {omega}: {r.iters} iterations, "
              f"res {float(r.res):e}, Error max {errs[name]:e} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps({"n": n, "div": list(div), "counts": counts,
                      "error_max": errs}))


if __name__ == "__main__":
    main(sys.argv[1:])
