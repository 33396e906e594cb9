"""Memory-requirement report — the MemoryRequirement/displayMemoryInfo
equivalent (cz_miscel.cpp:61-139; PyTorch port of
``cubez_tpu/perf/memory.py``).

The reference prints the allocated array bytes per rank before solving;
this models the device-memory footprint of a solver configuration
analytically (the reference's state arrays and solver work vectors) so
capacity planning works without allocating.  The port holds more than
this: the packed layout's two fields, the driver's snapshot and history
(``torch.cuda.max_memory_allocated`` against this estimate: PERF.md §6).
"""

from __future__ import annotations

import torch

from ..solvers.steps import parse_name


def _fmt(nbytes: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if nbytes < 1024 or unit == "TiB":
            return f"{nbytes:.1f} {unit}"
        nbytes /= 1024.0
    return f"{nbytes:.1f} TiB"


# work arrays per solver family, in units of one (K, I, J) field
# (reference allocation lists, cz_Evaluate.cpp:239-313)
_FIELDS = {
    "jacobi": 4,      # P, RHS, MSK, WRK
    "psor": 3,        # P, RHS, MSK
    "sor2sma": 3,
    "pcr": 4,         # + line RHS d
    "pcr_rb": 4,
    "pbicgstab": 12,  # P, RHS, MSK + pcg_p/p_/r/r0/q/s/s_/t_ + wk (cz_Evaluate.cpp:316-330)
}


def memory_requirement(shape, solver: str, dtype=torch.float32, ndiv=1) -> dict:
    """Estimated per-device bytes for a (nk, ni, nj) problem.

    ``ndiv``: number of devices the cube is divided over.
    """
    kind, is_maf = parse_name(solver)
    nk, ni, nj = shape
    field = nk * ni * nj * torch.empty((), dtype=dtype).element_size() / ndiv
    n = _FIELDS.get(kind, 4)
    if is_maf:
        n += 1  # pvt (the 1D metric tables are negligible)
    total = n * field
    return {
        "per_field_bytes": field,
        "fields": n,
        "total_bytes": total,
        "human": _fmt(total),
    }


def report(shape, solver: str, dtype=torch.float32, ndiv=1) -> str:
    m = memory_requirement(shape, solver, dtype, ndiv)
    return (
        f"Memory requirement [{solver} @ {shape} /{ndiv} device(s)]: "
        f"{m['fields']} fields x {_fmt(m['per_field_bytes'])} = {m['human']}"
    )
