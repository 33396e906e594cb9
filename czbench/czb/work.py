"""The work of a solve and the card's peaks: the least time a solve could
take, for the roofline share.

``OPS`` is a frozen copy of the reference's flop accounting, as the port's
cubez_tpu_torch/perf/roofline.py ``COSTS`` held it when this benchmark was
written: operations a point of each kernel (jacobi/psor 18:
cz_solver.f90:238-241,315-318; sor2sma 18 a full red-black iteration:
cz_solver.f90:438-441; calc_ax 13, calc_rk 14: cz_blas.f90:607-610,686-689;
triad 2, dot 2, bicg_1 4, bicg_2 4: cz_blas.f90:278,341,407,471,536; the
MAF point kernels 66: cz_maf.f90:50-53).  A configuration's ``work`` names
how many of each kernel an iteration runs (``per_iter``) and a solve runs
once besides (``per_solve``), over the inner points.

Bytes are what a solve must move whatever the kernels do: its start and
its right-hand side read once and its field written once.  An iteration's
traffic is the implementation's, not the work's: a kernel that runs
several iterations a pass over the field moves less, and would read above
its roofline against it.

``CARDS`` is a copy of perf/pmlib.py's table, NVIDIA's data sheets: HBM
GB/s and the peak GFLOP/s outside the tensor cores in float32 and float64.
"""

from __future__ import annotations

OPS = {
    "jacobi": 18, "psor": 18, "sor2sma": 18,
    "jacobi_maf": 66, "psor_maf": 66, "sor2sma_maf": 66,
    "calc_ax": 13, "calc_rk": 14, "calc_ax_maf": 63, "calc_rk_maf": 63,
    "dot1": 2, "dot2": 2, "triad": 2, "bicg_1": 4, "bicg_2": 4,
}

CARDS = (
    ("h100 nvl", {"hbm_gbps": 3900.0, "float32": 60e3, "float64": 30e3}),
    ("h100 pcie", {"hbm_gbps": 2000.0, "float32": 51e3, "float64": 26e3}),
    ("h100 80gb hbm3", {"hbm_gbps": 3350.0, "float32": 67e3, "float64": 34e3}),
    ("h100 sxm", {"hbm_gbps": 3350.0, "float32": 67e3, "float64": 34e3}),
)

ITEMSIZE = {"float32": 4, "float64": 8}


def card_peaks(kind: str):
    """The table entry of a card named ``kind``, None for another card."""
    name = kind.lower()
    for key, peaks in CARDS:
        if key in name:
            return peaks
    return None


def _ops(counts: dict) -> float:
    return sum(OPS[k] * c for k, c in counts.items())


def solve_flops(work: dict, n: int, iters: int) -> float:
    """Operations of a solve of ``iters`` iterations on an n^3 grid."""
    inner = (n - 2) ** 3
    return inner * (_ops(work["per_iter"]) * iters
                    + _ops(work.get("per_solve", {})))


def solve_bytes(n: int, dtype: str) -> float:
    """Start and right-hand side read once, field written once."""
    return 3.0 * n ** 3 * ITEMSIZE[dtype]


def least_seconds(work: dict, n: int, dtype: str, iters: int, peaks) -> float:
    """The least time a solve could take on the card: the larger of its
    operations over the peak rate of its type and its bytes over HBM."""
    flops = solve_flops(work, n, iters) / (peaks[dtype] * 1e9)
    return max(flops, solve_bytes(n, dtype) / (peaks["hbm_gbps"] * 1e9))
