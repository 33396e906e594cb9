"""The work of a sweep of kernel P2 (csrc/pcr_gs.cu, the exact line
Gauss-Seidel of ``pcr``): the least time a sweep could take, for
``p2_roofline``.

``pcr_flops_per_pt`` is a frozen copy of the reference's count of its
full-plane PCR, operations a point of a line of n inner rows
(cz_solver.f90:694-701), as the port's cubez_tpu_torch/perf/roofline.py
held it when this file was written: 107.4 a point at 122 rows.  A sweep
relaxes every inner point once.  Its bytes are the field read and written
and the right-hand side read, once each: 3 n^3 values.
"""

from __future__ import annotations

from .work import ITEMSIZE


def pcr_flops_per_pt(n: int) -> float:
    """Operations a point of the full-plane PCR of a line of ``n`` rows."""
    pn = 1
    while (1 << pn) <= n:
        pn += 1
    return 6 + 14 * max(pn - 2, 0) + 74 * (2 ** max(pn - 2, 0)) / n + 6 + 6


def sweep_flops(n: int) -> float:
    """Operations of a sweep of an n^3 grid: (n - 2)^3 inner points on
    lines of n - 2 rows."""
    return pcr_flops_per_pt(n - 2) * (n - 2) ** 3


def sweep_bytes(n: int, dtype: str) -> float:
    """The field read and written and the right-hand side read."""
    return 3.0 * n ** 3 * ITEMSIZE[dtype]


def sweep_least_seconds(n: int, dtype: str, peaks) -> float:
    """The larger of a sweep's operations over the peak rate of its type
    and its bytes over HBM."""
    return max(sweep_flops(n) / (peaks[dtype] * 1e9),
               sweep_bytes(n, dtype) / (peaks["hbm_gbps"] * 1e9))
