#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cubez_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It imports only the port, builds its CUDA kernels from ``cubez_tpu_torch/
csrc``, and raises (exit code != 0, no result line) on any failure:

1. prints the card's name and power limit (nvidia-smi);
2. builds the kernels (one nvcc per source, in parallel) and prints the
   build time;
3. holds every kernel against its plain PyTorch twin on the card, float32
   fields bitwise equal, float64 within 1e-14, residuals to rtol 1e-5:
   - the constant-coefficient packed steps at 128^3, 124^3 and a ragged
     (37, 22, 45) (K, I, J): the single sweep (K1, one rb_single launch
     an iteration) with zero and seeded b, the pair with b, n = 3, 4, 6,
     offsets 0 and 1;
   - rb_sweeps_n (K1-K3) in both forms of its plan: the one-pass tile
     form (n = 2 with a zero b, and K1's n = 1 with zero and seeded b;
     constant and MAF; also at forced small regions and k chunks) at those
     shapes and the plan's edges (RBN_EDGES: K - 2 < 2n, J % 4 != 0, one
     tile and several), the row form (n = 1, 2, 3, 6, zero and seeded b)
     at the edges; ``out`` poisoned with NaN, x never written;
   - the MAF packed steps (single with and without b, pair with and
     without b, n = 3 and 6) on stretched-grid coefficients, and K4 on
     its plane tiles (the one-pass red-black step, and the Jacobi step
     and its single form: JACOBI_N iterations a launch and one, constant
     and MAF, with and without b) at 128^3, 125^3 (odd I: K4 only) and
     the ragged shape, offsets 0 and 1;
   - the line steps, constant and MAF, with and without b: K5 (rbl) at
     128^3 and the ragged shape, K6's line-Jacobi (line_j) at all three,
     K6's red-black form (line_rb) at 125^3 and the ragged shape, and all
     three at the shared-memory tile's edges (LINE_EDGES: 2 and 3 inner
     rows, K - 2 not a multiple of a tile's thread rows, line counts not a
     multiple of its 32 lines, odd I and J);
4. the main path, ``solve(Problem.poisson_cube(128, device="cuda"),
   "sor2sma", omega=1.5, itr_max=10000)``, with the kernels' launch counts
   zeroed just before: 1813 iterations (the f32 oracle's count, which the
   kernels, bitwise their twins, must give exactly), history to rtol 1e-3,
   every kernel launched (the stopping chunk replayed through K1's
   rb_single launches), and the stopping field bitwise a plain-twin
   solve's on the card;
5. float64 at 128^3: the f64 oracle's count +-1%, history to rtol 1e-6;
6. float32 at 512^3: 5787 iterations (within 2% of the f64 oracle's
   5781), the chain on the one-pass tile form and its replay on K1's tile
   form (their launches counted); then 20 fixed
   sweeps of the MAF chain the dispatch builds there (the tile form's MAF
   kernel), its field bitwise its plain twin's;
7. the slice-2 paths at 128^3 f32, each with the counts zeroed just before
   and read just after: sor2sma_maf (the packed MAF chain at the
   dispatch's depth, its stopping chunk replayed on the MAF single sweep;
   1813 +-2%), jacobi and
   jacobi_maf at omega 0.8 (K4, one launch a call of JACOBI_N
   iterations; 5378 and 5377 +-2%), histories to rtol 1e-3
   (the jacobi pair's against the oracle with float64 sums of dp^2,
   tests/torch_ref_histories), Error max equal to a plain-twin solve's
   (1e-5);
8. odd I: sor2sma and sor2sma_maf at 125^3 on K4's one-pass red-black
   step (one launch an iteration), the plain twin's iteration count and
   field;
9. the line solvers (slice 5), each with the counts zeroed just before
   and read just after: at 128^3 f32 pcr_rb (K5; the f32 oracle's 1356
   +-2%), pcr_rb_maf (K5-MAF; 1355) and pcr_j_esa at omega 1.0 (K6
   line_j; 4230), histories to rtol 1e-3 (pcr_rb_maf's and pcr_j_esa's
   against the oracle with float64 sums of dp^2, tests/torch_ref_histories)
   and Error max to the float64 oracle's (rtol 1e-2); 60 fixed sweeps of K6's MAF
   line-Jacobi, which no solver name dispatches; f64 pcr_rb at 64^3 (459
   +-1%, rtol 1e-6); odd I at 125^3, pcr_rb on K6's red-black form (the
   plain twin's count and field) and pcr_rb_maf (its MAF form);
10. the stretched grid (Problem.manufactured_stretched) at 128^3 f32,
    sor2sma_maf to eps 1e-5: the MAF pair with b (K2), whose only path a
    nonzero b is, its launches counted at the shape phase 12 times it at;
    then float64 at 24^3 and
    48^3: sor2sma_maf (the MAF pair with b), jacobi_maf (K4-MAF with b) and
    pcr_rb_maf (K5-MAF with b, the "krylov" sign) to eps 1e-9 on the
    kernels, error ratio in the h^2 band (3.4, 5.0);
11. the CLI in subprocesses, ``124 124 124 sor2sma 10000 1.5``, ``... jacobi
    10000 0.8``, ``... sor2sma_maf 10000 1.5`` and ``... pcr_rb 10000 1.5``
    (pcr_rb's count to the JAX package's CLI's +-2%, its Error max at rtol
    1e-2), ``124 124 124 sor2sma 10000 1.5 2 2 2`` (solve_dist over a
    (2, 2, 2) mesh on the card), which must give the serial CLI's count,
    and ``124 124 124 pcr_rb 10000 1.5 2 2 2`` (K9 on K-split blocks), held
    to the JAX package's jnp dist step on that mesh (1317 iterations +-2%,
    Error max 9.888023e-03 at rtol 1e-2; tools/jax_dist_counts.py);
12. times each step and its plain twin at 128^3 and 512^3 (sor2sma and
    sor2sma_maf on the dispatch's chain, the MAF chain at n = 6, jacobi on
    K4, pcr_rb on K5, pcr_rb_maf on K5-MAF, pcr_j_esa on K6; CUDA events,
    distinct random starts, long-minus-short differencing), and every
    kernel per call against its twin at 128^3 (K4 through its steps: a
    Jacobi call runs JACOBI_N iterations; K2/K3 through rb_sweeps_n's
    launcher, printing the plan it takes, the first call of each held to
    the twin bit for bit), and K2/K3 (both forms), K4's
    Jacobi, K5's and K6's also at 512^3 (the ``_512`` keys of their rows;
    the tile form's rows, whose path is 512^3, take those as their own);
13. the distributed kernels against their twins: one block at a time at
    nonzero offsets, K7 (dist_rb_sweeps) on the (2, 2, 2) blocks of 128^3
    at n = 2, 6 and the one-iteration form n = 1 on the depth-12 ring,
    K7-MAF at n = 2 and 3, K8 (block_sweep: its launch over one block) in
    every variant with and without b, and a (2, 1, 1) mesh ragged in J;
    then K8 over all eight blocks of 128^3 in one launch (sweep_blocks),
    every variant, the face exchange (one launch, and gather then scatter)
    and the residual fold (dist_halo.py); K7 over the eight extended
    blocks of 128^3 in one launch (n = 6, 1 and MAF 2) and the pack
    path's one-launch ring refresh against its twin and the three-phase
    transitive copy, edges and corners included; float32 bitwise,
    float64 within 1e-14, residuals to rtol 1e-5, the fold to 1e-15;
14. solve_dist with eight blocks on the card (``make_mesh(..., devices=
    ["cuda:0"] * 8)``), each path with the counts zeroed just before and
    read just after: at 128^3 f32 sor2sma pack (the serial count exactly,
    history to rtol 1e-5, the field at the stop bit for bit; two launches
    a call, the ring refresh and K7), sor2sma_maf pack (the same),
    sor2sma 'color' (the serial count), jacobi at omega
    0.8 (the serial count), 'overlap' (the 'color' field bit for bit), each
    with its K8/K9 step launches an iteration, 60 fixed sweeps of 'iter'
    against its twin (bitwise; 60 launches each of K8, exchange and fold);
    512^3 f32 sor2sma pack (the serial 512^3 count and field);
15. times the distributed steps per iteration at 128^3 (pack, 'color',
    'overlap', jacobi, with the device time, device launches and busy
    share an iteration under torch.profiler) and 512^3 (pack, 'color')
    over (2, 2, 2) beside the serial n = 6 chain, and K7, the ring
    refresh, K8, the face exchange and the fold per launch over the eight
    blocks, against their twins;
16. K9 (block_pcr, its launch over one block) against its twin in every
    variant, 'pcr' and 'fastdiag', constant and MAF, colours 0, 1 and the
    line-Jacobi pass, zero and streamed b, on the 64^3 blocks of 128^3 over
    (2, 2, 2) and a (128, 64, 64) block over (1, 2, 2); K9 over all the
    blocks of a mesh in one launch (pcr_blocks: 'pcr' on the eight of 128^3
    and of 512^3 over (2, 2, 2) and on the four of 128^3 over (1, 2, 2),
    'fastdiag' on those four), every variant; K10 (fused_pcr) in its line
    form at 128^3 in every variant and at 512^3 (colour 1 and line-Jacobi,
    zero b), and in its tile form on a (600, 14, 40) field of lines past
    512 rows; float32 bitwise, float64 within 1e-14;
17. the dist line path, each solve with the counts zeroed just before and
    read just after: solve_dist at 128^3 f32 of pcr_rb, pcr_rb_maf (omega
    1.5) and pcr_j_esa (1.0) over (1, 2, 2) (K9 'fastdiag'; the serial
    counts 1356, 1356, 4232 +-2% and the serial Error max, rtol 1e-2) and
    over (2, 2, 2) (K9 'pcr'; the JAX package's jnp dist counts 1379,
    1379, 4236 +-2% and its Error max, rtol 1e-2), the same three at 64^3
    over (2, 2, 2) (JAX's 479, 479, 1814 +-2%; both references from
    tools/jax_dist_counts.py), f64 pcr_rb at 64^3 and jacobi_maf /
    sor2sma_maf 'color' at 128^3 on parallel/dist.py (no kernel; the serial
    counts 5380 and 1813 +-2%), and K10's own entry point
    (make_fused_pcr_step 'pcr_rb' and 'pcr', constant and MAF) for 60
    fixed sweeps, one launch a sweep, within 1e-4 of K5/K6's;
18. times the dist line steps per iteration at 128^3 over (2, 2, 2) and
    (1, 2, 2) (with the device time, device launches and busy share an
    iteration) and at 512^3 over (2, 2, 2), K9 per launch over all the
    blocks of the path's meshes (and its 'pcr' form over the eight blocks
    of 512^3) and K10 per colour pass at 128^3 and 512^3 (and its pcr_rb
    step at 128^3), against their twins;
19. the Krylov solvers (slice 4), each solve with the counts zeroed just
    before and read just after: pbicgstab with sor2sma (omega 1.1) at
    256^3 in float64 (the oracle's 38 +-1, history to rtol 1e-4 before
    its last KRYLOV_TAIL entries) and float32 (41-45 iterations, Error max
    under KRYLOV_ERR_256), K2's pair with b launched exactly 8 times an
    iteration, the vector passes (csrc/blas.cu) 5 times, and the plain-twin
    solve's count (its vector maps and dots on the same passes; float32:
    field and history bit for bit; float64: history to 1e-4 before the
    tail, the twin being an ulp off without fma); at 128^3 f32 sor2sma (20
    +-1, rtol 3e-3 before the last KRYLOV_TAIL entries: the f32 oracle's
    serial float32 dots are that far off from its first entry),
    pbicgstab_maf with sor2sma_maf (19 +-1, K2's MAF pair with b), and
    jacobi (K4), pcr_rb (K5), pcr_j_esa (K6) and cg with jacobi, each the
    plain-twin solve's count and field bit for bit with its launches
    counted; pbicgstab none at 64^3 (the oracle's 44 and 56, +-2: the curve
    is chaotic near its stop); the stretched grid's "krylov" sign at 24^3
    and 48^3 f64 (h^2 band); the CLI ``64 64 64 pbicgstab 4000 1.1
    sor2sma`` (the oracle's 11 +-1); solve_dist over (2, 2, 2) at 128^3
    (K8 with b, the serial count +-1, Error max within a factor 2 of the
    serial solve's with its dots summed eagerly, as the blocks sum them); K2's
    pair with b
    per call at 256^3 against its twin; the operator pass (csrc/blas.cu:
    A x and b - A x, launched 2 iters + 1 times a pbicgstab solve, iters +
    1 a cg solve, never under impl 'plain', by pbicgstab_maf or on the
    mesh) bit for bit against its twin at 256^3 in float64 and float32,
    A x per call in float64 beside its bound; and the wall, device time, device
    launches and busy share an iteration of the 256^3 and 128^3 solves
    beside the bound of an iteration;
20. the exact serial orders (slice 6): one sweep of P1 (psor, csrc/psor.cu)
    and P2 (pcr, csrc/pcr_gs.cu) on the diagonal layout against its plain
    twin, bit for bit, and the steps' launch of n lagged sweeps against n
    twin calls, at 128^3 float32 (timed: ms a sweep in one-sweep launches
    and in launches of n) and 64^3 float64, constant and MAF; then, each
    with the counts zeroed just before and read just after (launches of n
    sweeps and the stop's one-sweep launches, no other kernel of the
    slice), psor, psor_maf, pcr and pcr_maf at 128^3 float32
    (DIAG_MAF_N for the MAF forms) against the f32 oracle (3249, 3249,
    1357, 1356 +-2%; at 128^3 the curves rtol 1e-3 but for the last entry
    against the oracle with float64 sums of dp^2, tests/
    torch_ref_histories) and at 64^3
    float64 (+-1%, rtol 1e-6); pcr_eda and pcr_esa at 32^3 (pcr's count and
    field); solve_dist of psor and pcr over (2, 2, 2) at 64^3 (the serial
    count, history and field bit for bit); pbicgstab with psor at 64^3
    (2 P1 launches of 8 sweeps an iteration); the CLI ``124 124 124 pcr
    10000 1.5`` (the in-process count); and the wall, device time, device
    launches and busy share a sweep of psor and pcr solve windows of whole
    calls (at least 200 sweeps) at 128^3;
21. the extensions (slice 7), each solve with the counts zeroed just before
    and read just after: mg, mg_maf, fmg, fmg_maf, fd and fd_maf at 128^3
    float32 (omega 1.0) at the JAX package's counts (JAX_EXT_128, tools/
    jax_ext_counts.py) and Error max (rtol 1e-2), K4 launched for each
    finest-level sweep of the V-cycles (none for fd) and no other kernel,
    the field at the stop bitwise a plain-twin solve's on the card;
    pbicgstab with mg and cg with fd at JAX's counts; solve_dist of mg and
    fd over (2, 2, 2) (the serial count and field bit for bit); the CLI
    ``128 128 128 fmg 100 1.0 --dump p.sph``, read back equal to the field;
    mg's wall and device time a V-cycle, K4's share, device launches and
    busy share; fd at 128^3 and 512^3 (one iteration, the same result bit
    for bit after set_float32_matmul_precision("high")), its ms a solve
    and the contraction's against its bound; mg at 512^3 (the plain-twin
    solve's count and field);
22. the perf layer (slice 8, cubez_tpu_torch/perf): the CLI ``128 128 128
    sor2sma 10000 1.5 --profile``, serial (1813 iterations; profiling.txt's
    sor2sma_sweep, driver_overhead and solve_total rows with calls and
    seconds, the sweep's %SoL against the card's table entry) and over
    ``2 2 2`` (the pack route: the halo_exchange and residual_allreduce
    COMM rows with bytes, sor2sma_block_sweep); torch's peak memory over a
    512^3 sor2sma solve against perf/memory.py's model (printed, with the
    ratio); profile_solve's 512^3 sweep time an iteration within
    TIMER_RTOL of phase 12's; weak scaling of 128^3 sor2sma blocks, 1 to 8
    on the card, every point on the kernels' route; a 128^3 solve under
    torch.profiler, in a fresh process: its ``sor2sma`` label ranges hold
    the runtime launches of its K1/K3 kernels, and a solve with no
    profiler on never enters the label (``steps.labeled.entered``).

The line before the last is a JSON object with one entry per kernel
variant (its bound: the larger of the bytes it must move over the card's
HBM rate and its operations over its float32 rate outside the tensor cores,
from its entry in cubez_tpu_torch/perf/pmlib.py's table: 3.35 TB/s and 67
TFLOP/s on the H100 SXM); the
last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HIST = ROOT / "tests" / "ref_histories"
# the oracle with float64 dp^2 sums in jacobi(_maf), pcr_j_esa and pcr_rb_maf
# (tools/ref_oracle_f64sum.py)
HIST64 = ROOT / "tests" / "torch_ref_histories"
# Error max of the float64 oracle at 128^3 (tools/ref_oracle.cpp --fp64),
# and (Iter, Error max) of the JAX package's CLI at 124^3 (124 124 124
# pcr_rb 10000 1.5, float32).  Rounding alone moves a float32 solve's
# Error max by up to 0.7% from the float64 one (the f32 oracle's pcr_rb:
# 9.994804e-03; the JAX package's pcr_rb_maf: 1.003075e-02), so Error max
# is held to these at rtol 1e-2.
ERR_F64_128 = {"pcr_rb": 1.006167e-02, "pcr_rb_maf": 1.006167e-02,
               "pcr_j_esa": 6.054431e-02}
JAX_CLI_124 = {"pcr_rb": (1294, 9.358376e-03)}
# (Iter, Error max) of the JAX package's jnp dist step at 124^3 over
# (2, 2, 2), eps 1e-5, Problem.poisson_cube, float32, the CLI's own
# settings: ``python3 tools/jax_dist_counts.py 124 2 2 2`` on the host's
# CPU printed "pcr_rb 124^3 over (2, 2, 2) omega 1.5: 1317 iterations, res
# 9.973868e-06, Error max 9.888023e-03".  Block-local K-lines change the
# trajectory, so the CLI's ``124 124 124 pcr_rb 10000 1.5 2 2 2`` is held
# to these (count +-2%, Error max at ERR_RTOL), as phase 17 holds 64^3.
JAX_DIST_CLI_124 = {"pcr_rb": (1317, 9.888023e-03)}
# (Iter, res, Error max) of the JAX package's extensions at 128^3, float32,
# eps 1e-5, omega 1.0, the field at the stopping iteration:
# ``python3 tools/jax_ext_counts.py 128`` on the host's CPU printed these
# (pbicgstab with the mg preconditioner, cg with fd: "solver+precond").
# Phase 21 holds the port's counts to them exactly and Error max at
# ERR_RTOL.
JAX_EXT_128 = {
    "mg": (6, 4.055880e-06, 3.550649e-04),
    "mg_maf": (5, 5.478421e-06, 8.127093e-04),
    "fmg": (2, 6.957753e-06, 6.577373e-04),
    "fmg_maf": (1, 9.164844e-07, 1.873970e-04),
    "fd": (1, 5.359026e-08, 3.597140e-05),
    "fd_maf": (1, 5.381472e-08, 3.606081e-05),
    "pbicgstab+mg": (3, 1.866319e-06, 4.249811e-05),
    "cg+fd": (1, 3.213745e-07, 3.594160e-05),
}
ERR_RTOL = 1e-2
# BiCGSTAB's last iterations amplify rounding about fivefold an iteration:
# at 256^3 f64 the port's curve holds the oracle's to 3e-5 up to its last
# five entries and then drifts 2e-4, 1e-3, 9e-3, 0.26, and the unpacked
# plain sweep (another arithmetic) drifts as far, so the curves are held
# before those entries.  Error max at eps 1e-5 is the algebraic error left
# by those iterations: equally valid 256^3 trajectories of the port give
# 0.0064 (f64) to 0.027 (f32), so it is held under a bound.
KRYLOV_TAIL = 5
# the MAF forms of slice 6's solves (phase 20) run at this size in float32
DIAG_MAF_N = 128
KRYLOV_ERR_256 = 0.05
OMEGA = 1.5
OMEGA_J = 0.8
OMEGA_L = 1.0  # pcr_j_esa: line-Jacobi diverges above about 1.0
SEED = 20261016
RAGGED = (37, 22, 45)  # (K, I, J)
# the line tile's edges (csrc/line_tile.cuh; 32 lines and 4 thread rows a
# tile at these K): 2 and 3 inner rows, odd I (K6's red-black form), line
# counts that are no multiple of 32, K - 2 no multiple of 4
LINE_EDGES = ((4, 22, 45), (5, 21, 37), (39, 9, 70), (130, 14, 97))
# rb_sweeps_n's edges (csrc/rbpack.cu): K - 2 < 2n, J % 4 != 0 (no aligned
# copies), one tile and several, odd packed rows, a tall region
RBN_EDGES = ((6, 10, 9), (5, 12, 14), (16, 16, 16), (40, 22, 46),
             (24, 130, 70))
# the card's peaks for the bounds: its entry in the port's table
# (cubez_tpu_torch/perf/pmlib.py, NVIDIA's data sheets; the H100 SXM's
# 3.35 TB/s and 67 TFLOP/s), set by main() from the card it runs on
HBM_BYTES_S = F32_FLOPS_S = None
# phase 22: the 512^3 sweep time of profile_solve against phase 12's
TIMER_RTOL = 0.25
# phase 19: a vector pass's dot against the twin's torch sum, relative to
# the sum of its terms' magnitudes, by dtype name (the two sum in
# different orders)
VEC_DOT_RTOL = {"float64": 1e-13, "float32": 1e-5}
# the lines of the JAX package's ops/blas.py each vector pass replaces:
# bicg_1, triad, dot2, dots_t's dot2 (and dot1), update_xr's bicg_2 (and
# triad, dot1, dot2)
VEC_SITES = {"bicg_1": 31, "triad": 26, "dot2": 21, "dots_t": 21,
             "update_xr": 38}


def bound(nbytes, flops):
    """(ms, what bounds it): the least time for ``nbytes`` moved and
    ``flops`` done at the card's peaks."""
    tb, tf = nbytes / HBM_BYTES_S, flops / F32_FLOPS_S
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def load_history(name, where=HIST):
    rows = (where / name).read_text().splitlines()[1:]
    return [float(r.split(",")[1]) for r in rows]


def profile_rows(path):
    """{label: (type, calls, seconds, GB/s, %SoL or "")} of the section
    rows of a profiling.txt (perf/pmlib.py's report)."""
    lines = path.read_text().splitlines()
    dashes = [i for i, ln in enumerate(lines) if ln and set(ln) == {"-"}]
    check(len(dashes) == 2, f"{path}: not a profiling report")
    rows = {}
    for ln in lines[dashes[0] + 1:dashes[1]]:
        f = ln.split()
        rows[f[0]] = (f[1], int(f[2]), float(f[3]), float(f[5]), ln[72:].strip())
    return rows


def perf_phase(ms_512, tag, env):
    """Phase 22, the perf layer on the card: the CLI's --profile serial and
    over 2 2 2 at 128^3, profile_solve's 512^3 sweep time against phase
    12's (``ms_512`` a sor2sma iteration), the memory model against
    torch's peak, weak scaling of eight blocks on the card, and the solver
    label around a solve's launches under torch.profiler (and never
    entered without a profiler, by its counter), in a process of its own
    (``label_window``)."""
    import gc

    import torch

    from cubez_tpu_torch import Problem, solve
    from cubez_tpu_torch.perf import memory as perf_memory
    from cubez_tpu_torch.perf import scaling as perf_scaling
    from cubez_tpu_torch.perf.profile import profile_solve

    dev = torch.device("cuda", 0)
    hbm_gbps = HBM_BYTES_S / 1e9

    # the CLI with --profile: serial, and over 2 2 2 (the pack route)
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for label, gdv in (("serial", ()), ("dist", ("2", "2", "2"))):
            d = Path(tmp) / label
            d.mkdir()
            procs.append((label, d, subprocess.Popen(
                [sys.executable, "-m", "cubez_tpu_torch.cli", "128", "128",
                 "128", "sor2sma", "10000", "1.5", *gdv, "--profile"],
                cwd=d, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        rows = {}
        for label, d, proc in procs:
            out, errs_ = proc.communicate(timeout=300)
            check(proc.returncode == 0,
                  f"CLI --profile {label} exited {proc.returncode}:\n{errs_}")
            check("Iter = 1813  Res = " in out and "profiling.txt written" in out,
                  f"CLI --profile {label}: not 1813 iterations, or no report")
            print(f"CLI 128^3 sor2sma {label} --profile, profiling.txt {tag}:\n"
                  + (d / "profiling.txt").read_text(), flush=True)
            rows[label] = profile_rows(d / "profiling.txt")
    serial, dist = rows["serial"], rows["dist"]
    for lab in ("sor2sma_sweep", "driver_overhead", "solve_total"):
        check(lab in serial and serial[lab][1] > 0 and serial[lab][2] > 0,
              f"CLI --profile: no {lab} row with calls and seconds")
    kind, calls, secs, gbps, sol = serial["sor2sma_sweep"]
    check(sol and abs(float(sol) - 100 * gbps / hbm_gbps) <= 0.1 + 5e-3 * gbps,
          f"CLI --profile: sor2sma_sweep %SoL {sol!r} is not {gbps} GB/s "
          f"against the table's {hbm_gbps}")
    print(f"128^3 sor2sma_sweep: {gbps} GB/s, {sol}% of the table's "
          f"{hbm_gbps:.0f} GB/s (the field lives in the L2: printed, not "
          f"checked) {tag}", flush=True)
    for lab, want in (("halo_exchange", "COMM"), ("residual_allreduce", "COMM"),
                      ("sor2sma_block_sweep", "CALC")):
        check(lab in dist and dist[lab][0] == want and dist[lab][1] > 0,
              f"CLI --profile over 2 2 2: no {want} row {lab}")
    for lab in ("halo_exchange", "residual_allreduce"):
        check(dist[lab][4] != "", f"CLI --profile over 2 2 2: {lab} has no "
              "bytes (no %SoL)")

    # memory: the model's fields against torch's peak around a 512^3 solve
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    p512 = Problem.poisson_cube(512, device=dev)
    r = solve(p512, "sor2sma", omega=OMEGA, itr_max=20000)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    model = perf_memory.memory_requirement((512,) * 3, "sor2sma")["total_bytes"]
    check(r.iters == 5787, f"512^3 solve: {r.iters} iterations")
    check(peak > 0 and model > 0, "memory: no bytes")
    print(f"memory 512^3 sor2sma: {perf_memory.report((512,) * 3, 'sor2sma')}; "
          f"torch peak over the problem and its solve {peak / 1e9:.4f} GB, "
          f"ratio {peak / model:.4f} {tag}", flush=True)
    del r

    # two timers: profile_solve's sweep section against phase 12's events
    pm = profile_solve(p512, "sor2sma", OMEGA, iters=50)
    print(f"profile_solve 512^3 sor2sma {tag}:\n{pm.report()}", flush=True)
    sw = pm.sections["sor2sma_sweep"]
    ms_prof = sw.seconds / sw.calls * 1e3
    check(abs(ms_prof / ms_512 - 1) <= TIMER_RTOL,
          f"512^3 sweep: profile_solve {ms_prof:.4f} ms an iteration, phase "
          f"12 {ms_512:.4f}")
    print(f"two timers 512^3 sor2sma: profile_solve {ms_prof * 1e3:.3f} us an "
          f"iteration, phase 12 {ms_512 * 1e3:.3f} (ratio "
          f"{ms_prof / ms_512:.4f}); {sw.gbps:.1f} GB/s, "
          f"{100 * sw.gbps / hbm_gbps:.1f}% of {hbm_gbps:.0f} GB/s {tag}",
          flush=True)
    del p512, pm

    # weak scaling: 128^3 blocks, 1 to 8 of them on the one card
    pts = perf_scaling.weak_scaling(block=128, solver="sor2sma", omega=OMEGA,
                                    device_counts=[1, 2, 4, 8],
                                    devices=["cuda:0"] * 8)
    check(all(p.step_impl == "fused" for p in pts),
          f"weak scaling: routes {[p.step_impl for p in pts]}")
    print(f"weak scaling, 128^3 blocks on one card (the mesh's cost on the "
          f"card, not scaling) {tag}:\n{perf_scaling.report(pts)}", flush=True)

    # the label: its ranges hold the solve's launches under the profiler,
    # in a process of its own (label_window)
    proc = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "import chip_smoke; chip_smoke.label_window(sys.argv[2])", str(ROOT), tag],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    print(proc.stdout, end="", flush=True)
    check(proc.returncode == 0,
          f"label window exited {proc.returncode}:\n{proc.stderr[-3000:]}")


def label_window(tag):
    """The solver label around a solve's launches under torch.profiler:
    every K1/K3 launch of a 128^3 sor2sma solve has its kernel record on
    the card, linked to its launch call, and the call lies inside a
    ``sor2sma`` range; a solve with no profiler on never enters the label.
    perf_phase runs it in a fresh process: late in this script's process
    the profiler at times recorded 313 or 314 of the 316 kernels (on an
    H100 80GB HBM3; with the allocator's cache emptied and 77 of 79 GiB
    free too, and with the window held open 20 ms on both sides), while a
    fresh process recorded all 316 in 13 captures of 13, and
    tools/prof_dist.py's K9 rows late in a run at times got no record at
    all."""
    import torch

    from cubez_tpu_torch import Problem, solve
    from cubez_tpu_torch.cuda_kernels import _build
    from cubez_tpu_torch.cuda_kernels import rbpack as rb
    from cubez_tpu_torch.solvers import steps as steps_mod

    dev = torch.device("cuda", 0)
    _build.load()
    p = Problem.poisson_cube(128, device=dev)
    solve(p, "sor2sma", omega=OMEGA, itr_max=30)  # warm
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    wrappers = (rb.rb_single, rb.rb_sweeps_n)
    for w in wrappers:
        w.launches = w.maf_launches = 0
    with torch.profiler.profile(activities=acts) as prof:
        r = solve(p, "sor2sma", omega=OMEGA, itr_max=10000)
        torch.cuda.synchronize()
    ours = sum(w.launches - w.maf_launches for w in wrappers)
    check(r.iters == 1813, f"profiled solve: {r.iters} iterations")
    # the host's label ranges (the profiler also marks them on the card's
    # timeline), the runtime launch calls, and the K1/K3 kernels on the
    # card, each linked to its launch call by the correlation id
    evs = prof.events()
    ranges = [(e.time_range.start, e.time_range.end) for e in evs
              if e.name == "sor2sma" and e.device_type == cpu]
    check(ranges, "no sor2sma event under torch.profiler")
    launches = {e.id: e for e in evs if e.device_type == cpu
                and e.name.startswith("cu") and "Launch" in e.name}
    kernels = [e for e in evs if e.device_type == cuda
               and "sweeps_kernel" in e.name]
    linked = [launches[k.id] for k in kernels if k.id in launches]

    def within(e):
        return any(a <= e.time_range.start and e.time_range.end <= b
                   for a, b in ranges)

    inside = [e for e in linked if within(e)]
    # launch calls inside the ranges with no record of any kind on the card
    on_card = {e.id for e in evs if e.device_type == cuda}
    calls = sorted(launches.values(), key=lambda e: e.time_range.start)
    unrecorded = [i for i, e in enumerate(calls) if e.id not in on_card and within(e)]
    print(f"labels: {len(ranges)} sor2sma ranges on the host; {len(kernels)} "
          f"K1/K3 kernels on the card, {len(linked)} linked to their launch "
          f"calls, {len(inside)} of those inside the ranges; the wrappers "
          f"counted {ours} launches; launch calls inside the ranges with no "
          f"record on the card: {unrecorded} of {len(calls)} {tag}", flush=True)
    check(ours > 0 and len(kernels) == ours,
          f"profiled solve: {len(kernels)} K1/K3 kernels, {ours} launches counted")
    check(len(inside) == len(linked) == ours,
          f"{ours} launches: {len(linked)} linked, {len(inside)} inside the "
          "sor2sma ranges")
    before = steps_mod.labeled.entered
    r = solve(p, "sor2sma", omega=OMEGA, itr_max=10000)
    check(r.iters == 1813 and steps_mod.labeled.entered == before,
          "a solve with no profiler on entered the label")




def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    check(out, "nvidia-smi printed nothing")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    sys.path.insert(0, str(ROOT))
    from cubez_tpu_torch import (Grid, Problem, make_mesh, max_error_loc, solve,
                                 solve_dist)
    from cubez_tpu_torch.cuda_kernels import _build, dist_halo
    from cubez_tpu_torch.cuda_kernels import blas as kax
    from cubez_tpu_torch.cuda_kernels import dist_pcr as k9
    from cubez_tpu_torch.cuda_kernels import dist_rbpack as k7
    from cubez_tpu_torch.cuda_kernels import dist_sweeps as k8
    from cubez_tpu_torch.cuda_kernels import pcr as k10
    from cubez_tpu_torch.cuda_kernels import lines as k6
    from cubez_tpu_torch.cuda_kernels import rblines as k5
    from cubez_tpu_torch.cuda_kernels import rbpack as rb
    from cubez_tpu_torch.cuda_kernels import sweeps as k4
    from cubez_tpu_torch.cuda_kernels import pcr_gs as kp2
    from cubez_tpu_torch.cuda_kernels import psor as kp1
    from cubez_tpu_torch.ops import blas as blas_ops
    from cubez_tpu_torch.ops import pcr_gs as gs_ops
    from cubez_tpu_torch.ops import psor_scan
    from cubez_tpu_torch.ops.pcr import num_stage
    from cubez_tpu_torch.parallel import dist_fused, dist_pack
    from cubez_tpu_torch.solvers.driver import fixed_sweeps
    from cubez_tpu_torch.solvers.fused_cache import get_fused_step

    from cubez_tpu_torch.perf import pmlib

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    f32, f64 = torch.float32, torch.float64
    t_start = time.perf_counter()
    global HBM_BYTES_S, F32_FLOPS_S
    hbm_gbps, f32_gflops = (pmlib.device_hbm_gbps(dev),
                            pmlib.device_peak_gflops(dev, f32))
    check(hbm_gbps and f32_gflops, f"{torch.cuda.get_device_name(dev)} has no "
          "entry in cubez_tpu_torch/perf/pmlib.py's table")
    HBM_BYTES_S, F32_FLOPS_S = hbm_gbps * 1e9, f32_gflops * 1e9

    # each wrapper counts its launches, and separately its MAF launches; a
    # kernel variant is a wrapper's constant or MAF form
    wrappers = {"rb_single": rb.rb_single, "rb_sweeps_n": rb.rb_sweeps_n,
                "k4_jacobi": k4.jacobi_k4, "k4_rb_color": k4.sor2sma_k4,
                "rbl": k5.rbl, "line_j": k6.line_j, "line_rb": k6.line_rb,
                "dist_rb_sweeps": k7.dist_rb_sweeps, "fused_pcr": k10.fused_pcr,
                "psor_diag": kp1.psor_diag, "pcr_gs_diag": kp2.pcr_gs_diag}
    k9_variants = ("block_pcr", "block_pcr_maf", "block_pcr_fastdiag",
                   "block_pcr_fastdiag_maf")

    def zero_counts():
        for w in wrappers.values():
            w.launches = w.maf_launches = 0
        # K1, K2/K3, K8, K9 and K10 count their launches by variant too
        for w in (rb.rb_single, rb.rb_sweeps_n, k8.block_sweep, k9.block_pcr,
                  k10.fused_pcr, kp2.pcr_gs_diag):
            w.variant_launches = {}
        for w in (k8.block_sweep, k9.block_pcr):
            w.launches = 0
        dist_halo.halo_exchange.launches = dist_halo.fold_partials.launches = 0
        k7.exchange_packed.launches = 0
        kax.operator_pass.launches = kax.vector_pass.launches = 0
        kax.vector_pass.op_launches.update(
            dict.fromkeys(kax.vector_pass.op_launches, 0))

    def read_counts():
        out = {}
        for name, w in wrappers.items():
            out[name] = w.launches - w.maf_launches
            out[name + "_maf"] = w.maf_launches
        # K2/K3 by (form, MAF, b): the row form's chain (rb_sweeps_n, MAF
        # rb_sweeps_n_maf_chain) and the MAF pair with b (rb_sweeps_n_maf,
        # K2), the tile form's chain (rb_sweeps_n_tile, _maf_tile)
        vl = rb.rb_sweeps_n.variant_launches
        for name, form, maf, has_b in (
                ("rb_sweeps_n", "rows", False, None),
                ("rb_sweeps_n_maf", "rows", True, True),
                ("rb_sweeps_n_maf_chain", "rows", True, False),
                ("rb_sweeps_n_tile", "tile", False, None),
                ("rb_sweeps_n_maf_tile", "tile", True, None)):
            out[name] = sum(v for (f, m, b_), v in vl.items() if f == form
                            and m == maf and has_b in (None, b_))
        # K1 by form: the row form (rb_single, rb_single_maf, counted
        # above), the one-pass tile form beyond the L2 (rb_single_tile)
        out["rb_single_tile"] = sum(
            v for (f, _, _), v in rb.rb_single.variant_launches.items()
            if f == "tile")
        for name in ("rb_single", "rb_single_maf"):
            out[name] -= sum(v for (f, m, _), v in
                             rb.rb_single.variant_launches.items()
                             if f == "tile" and m == name.endswith("_maf"))
        for v in ("jacobi", "colour", "both", "interior", "shell"):
            out["block_sweep_" + v] = k8.block_sweep.variant_launches.get(v, 0)
        for v in k9_variants:
            out[v] = k9.block_pcr.variant_launches.get(v, 0)
        out["halo_exchange"] = dist_halo.halo_exchange.launches
        out["fold_partials"] = dist_halo.fold_partials.launches
        out["pack_exchange"] = k7.exchange_packed.launches
        # the Krylov loop's operator pass (csrc/blas.cu), A x and b - A x
        out["ax_kernel"] = kax.operator_pass.launches
        # its vector passes (maps and dots), in all and pass by pass
        out["vector_pass"] = kax.vector_pass.launches
        out.update({f"vec_kernel.{op}": n
                    for op, n in kax.vector_pass.op_launches.items()})
        return out

    # the launches of the dist K8/K9 steps: exchange, sweep, fold
    dist_launch_names = ("halo_exchange", "fold_partials") + tuple(
        "block_sweep_" + v for v in ("jacobi", "colour", "both", "interior",
                                     "shell")) + k9_variants

    path_launches = {}  # variant -> launches in the first path that runs it

    def stamp(phase):
        print(f"[{time.perf_counter() - t_start:.1f} s] phase {phase}", flush=True)

    # ---- 1. the card ------------------------------------------------------
    card = card_line()
    print(card, flush=True)
    tag = f"[{card}]"

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load(rebuild=True)
    print(f"build: {time.perf_counter() - t0:.2f} s, "
          f"{len(_build.sources())} sources in parallel "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for ln in _build.build_log.splitlines():
        if "registers" in ln or "spill" in ln:
            print("  " + ln.strip())

    # ---- 3. kernels vs plain twins ------------------------------------------
    stamp(3)
    gen = torch.Generator().manual_seed(SEED)

    def rand(shape, dtype):
        return (torch.rand(shape, generator=gen, dtype=torch.float64) * 2 - 1).to(dtype)

    def stretched_mc(shape, dtype):
        K, I, J = shape
        return Problem.manufactured_stretched((I, J, K), dtype=dtype,
                                              device=dev)[0].mc

    # (label, variant, shapes it runs at, build(shape, dtype, offset, mc, plain))
    def packed(make, **kw):
        return lambda sh, dt, off, mc, pl: make(sh, dt, omega=OMEGA, offset=off,
                                                mc=mc, plain=pl, **kw)

    def unpacked(kind, bz, single=False):
        def build(sh, dt, off, mc, pl):
            st = k4.make_fused_sweep(
                kind, sh, dt, omega=OMEGA if kind == "sor2sma" else OMEGA_J,
                offset=off, b_is_zero=bz, mc=mc, plain=pl)
            return st.single if single else st
        return build

    def line_step(kind, bz):
        if kind == "rbl":
            return lambda sh, dt, off, mc, pl: k5.make_rbl_step(
                sh, dt, omega=OMEGA, offset=off, b_is_zero=bz, mc=mc, plain=pl)
        return lambda sh, dt, off, mc, pl: k6.make_line_step(
            kind, sh, dt, omega=OMEGA_L if kind == "pcr_j" else OMEGA,
            offset=off, b_is_zero=bz, mc=mc, plain=pl)

    const_shapes = ((128, 128, 128), (124, 124, 124), RAGGED)
    new_shapes = ((128, 128, 128), (125, 125, 125), RAGGED)
    # (kind, variant, shapes): K5 where I is even, K6's red-black form where
    # the dispatch takes it (odd I) and on the ragged shape
    line_kinds = (("rbl", "rbl", ((128, 128, 128), RAGGED) + LINE_EDGES),
                  ("pcr_j", "line_j", new_shapes + LINE_EDGES),
                  ("pcr_rb", "line_rb", ((125, 125, 125), RAGGED) + LINE_EDGES))
    cases = [
        ("single b=0", "rb_single", const_shapes, False,
         packed(rb.make_packed_sweep, b_is_zero=True)),
        ("single b", "rb_single", const_shapes, False,
         packed(rb.make_packed_sweep, b_is_zero=False)),
        ("pair b", "rb_sweeps_n", const_shapes, False,
         packed(rb.make_packed_sweep2x, b_is_zero=False)),
    ] + [
        (f"n={n}", "rb_sweeps_n", const_shapes, False,
         packed(rb.make_packed_sweepnx, n=n))
        for n in (3, 4, 6)
    ] + [
        ("MAF single b=0", "rb_single_maf", new_shapes, True,
         packed(rb.make_packed_sweep, b_is_zero=True)),
        ("MAF single b", "rb_single_maf", new_shapes, True,
         packed(rb.make_packed_sweep, b_is_zero=False)),
        ("MAF pair b=0", "rb_sweeps_n_maf_chain", new_shapes, True,
         packed(rb.make_packed_sweep2x, b_is_zero=True)),
        ("MAF pair b", "rb_sweeps_n_maf", new_shapes, True,
         packed(rb.make_packed_sweep2x, b_is_zero=False)),
    ] + [
        (f"MAF n={n}", "rb_sweeps_n_maf_chain", new_shapes, True,
         packed(rb.make_packed_sweepnx, n=n))
        for n in (3, 6)
    ] + [
        # K4's one-pass red-black step, and its Jacobi step (JACOBI_N
        # iterations a launch) and single form (one)
        (f"K4 {kind}{' single' if single else ''}{' MAF' if maf else ''} "
         f"b={'0' if bz else 'b'}",
         f"k4_{'jacobi' if kind == 'jacobi' else 'rb_color'}"
         f"{'_maf' if maf else ''}", new_shapes, maf, unpacked(kind, bz, single))
        for kind, single in (("sor2sma", False), ("jacobi", False), ("jacobi", True))
        for maf in (False, True) for bz in (True, False)
    ] + [
        (f"{kind}{' MAF' if maf else ''} b={'0' if bz else 'b'}",
         f"{variant}{'_maf' if maf else ''}", shapes, maf, line_step(kind, bz))
        for kind, variant, shapes in line_kinds
        for maf in (False, True) for bz in (True, False)
    ]
    err = {}
    n_cmp = 0
    for shape in ((128, 128, 128), (124, 124, 124), (125, 125, 125), RAGGED,
                  *LINE_EDGES):
        for dtype in (f32, f64):
            tol = 0.0 if dtype == f32 else 1e-14
            mc = None
            if shape in new_shapes or shape in LINE_EDGES:
                mc = stretched_mc(shape, dtype)
            x, b = rand(shape, dtype).to(dev), rand(shape, dtype).to(dev)
            for offset in (0, 1):
                for label, variant, shapes, maf, build in cases:
                    # line-Jacobi has no colours, so no offset
                    if shape not in shapes or (offset and "line_j" in variant):
                        continue
                    ks = build(shape, dtype, offset, mc if maf else None, False)
                    ps = build(shape, dtype, offset, mc if maf else None, True)
                    if ks is None:  # odd I: no packed layout
                        continue
                    x0, b0 = ks.pad(x), ks.pad(b)
                    xk, xp = x0.clone(), x0.clone()
                    for _ in range(2):
                        xk, rk = ks(xk, b0)
                        xp, rp = ps(xp, b0)
                    sync()
                    e = float((xk - xp).abs().max())
                    err[variant] = max(err.get(variant, 0.0), e)
                    rel = float(((rk - rp).abs() / rp.abs()).max())
                    where = f"{label} {shape} {dtype} offset={offset}"
                    check(torch.isfinite(xk).all(), f"non-finite field: {where}")
                    check(e <= tol, f"field differs by {e}: {where}")
                    check(rel <= 1e-5, f"residual differs by rtol {rel}: {where}")
                    n_cmp += 1
    # both forms of rb_sweeps_n (K2/K3) against the twin: the tile form
    # (its n with a zero b, and n = 1, K1's launch, with and without b;
    # also at forced small regions and k chunks, so that a CTA takes
    # several work items) at the main shapes and the edges, the row form at
    # the edges; out poisoned with NaN, x never written
    for shape in ((128, 128, 128), (124, 124, 124), RAGGED) + RBN_EDGES:
        for dtype in (f32, f64):
            tol = 0.0 if dtype == f32 else 1e-14
            tabs = {False: None, True: rb.maf_tables(stretched_mc(shape, dtype),
                                                     shape, dtype)}
            x = rb.pack_rb(rand(shape, dtype)).to(dev)
            b = rb.pack_rb(rand(shape, dtype)).to(dev)
            settings = [("tile", None, None), ("tile", 12, 3)]
            if shape in RBN_EDGES:
                settings.append(("rows", None, None))
            for form, rows, kchunk in settings:
                # the launcher's plan, forced (a test hook of rbpack)
                rb._force_plan = dict(form=form, rows=rows, kchunk=kchunk)
                tile = form == "tile"
                for n in (1, rb.TILE_N) if tile else (1, 2, 3, 6):
                    for maf in (False, True):
                        for bb in (None,) if tile and n > 1 else (None, b):
                            variant = ("rb_sweeps_n" + ("_maf" if maf else "")
                                       + ("_tile" if tile else "")
                                       + ("_chain" if maf and not tile and bb is None
                                          else ""))
                            if tile and n == 1:
                                variant = "rb_single_tile"
                            for offset in (0, 1):
                                launch = rb.RbSweeps(n, OMEGA, offset, tabs[maf])
                                x0 = x.clone()
                                out = torch.full_like(x, float("nan"))
                                rk = launch(x, bb, out)
                                xp = x.clone()
                                _, rp = rb.packed_sweeps_plain(xp, bb, n, OMEGA,
                                                               offset, tabs[maf])
                                sync()
                                e = float((out - xp).abs().max())
                                err[variant] = max(err.get(variant, 0.0), e)
                                rel = float(((rk - rp).abs() / rp.abs()).max())
                                where = (f"{variant} {form} rows={rows} kchunk="
                                         f"{kchunk} n={n} b={bb is not None} "
                                         f"{shape} {dtype} offset={offset}")
                                check(launch.plan.form == form, f"plan: {where}")
                                check(torch.equal(x, x0), f"x written: {where}")
                                check(bool(torch.isfinite(out).all()),
                                      f"out not written or not finite: {where}")
                                check(e <= tol, f"field differs by {e}: {where}")
                                check(rel <= 1e-5, f"residual rtol {rel}: {where}")
                                n_cmp += 1
            rb._force_plan = {}
    print(f"kernels vs plain twins: {n_cmp} comparisons passed "
          f"(f32 bitwise, f64 <= 1e-14); max |field diff| "
          + ", ".join(f"{k} {v:.3e}" for k, v in sorted(err.items())),
          flush=True)

    # ---- 4. the main path ------------------------------------------------------
    stamp(4)
    prob = Problem.poisson_cube(128, dtype=torch.float32, device="cuda")
    sync()
    zero_counts()
    t0 = time.perf_counter()
    res = solve(prob, "sor2sma", omega=OMEGA, itr_max=10000)
    sync()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = {k: counts[k] for k in ("rb_single", "rb_sweeps_n")}
    path_launches.update(launches)
    ref = load_history("f32_sor2sma_128_w1.5.txt")
    check(res.x.shape == (128, 128, 128) and bool(torch.isfinite(res.x).all()),
          "main path: field of the wrong shape or not finite")
    check(1777 <= res.iters <= 1849, f"main path: {res.iters} iterations")
    # the kernels are bitwise their twins, so the count is the twins' and
    # the f32 oracle's (1813), the stopping chunk replayed through K1
    check(res.iters == 1813, f"main path: {res.iters} iterations, not 1813")
    m = min(res.iters, len(ref)) - 1
    hist = res.history.cpu().tolist()
    worst = max(abs(h / r - 1) for h, r in zip(hist[:m], ref[:m]))
    check(worst <= 1e-3, f"main path: history off the f32 oracle by rtol {worst}")
    for k, v in launches.items():
        check(v > 0, f"main path: {k} was not launched")
    err_k, loc_k = max_error_loc(prob.grid, res.x)
    res_p = solve(prob, "sor2sma", omega=OMEGA, itr_max=10000, impl="plain")
    err_p, loc_p = max_error_loc(prob.grid, res_p.x)
    check(res_p.iters == res.iters, f"plain solve: {res_p.iters} iterations")
    check(abs(err_k - err_p) <= 1e-5, f"Error max {err_k} vs plain {err_p}")
    check(torch.equal(res.x, res_p.x),
          "main path: the stopping field differs from the plain twin's")
    print(f"main path 128^3 f32: {res.iters} iterations (f32 oracle "
          f"{len(ref)}), res {res.res:e}, history rtol {worst:.2e}, "
          f"wall {wall:.3f} s, launches {launches}, Error max {err_k:e} at "
          f"{loc_k} (plain twin: {err_p:e} at {loc_p}; field bitwise the "
          f"twin's) {tag}", flush=True)

    # ---- 5. float64 at 128^3 -------------------------------------------------
    stamp(5)
    prob64 = Problem.poisson_cube(128, dtype=torch.float64, device="cuda")
    res64 = solve(prob64, "sor2sma", omega=OMEGA, itr_max=10000)
    ref64 = load_history("f64_sor2sma_128_w1.5.txt")
    check(abs(res64.iters - len(ref64)) <= len(ref64) // 100,
          f"f64 128^3: {res64.iters} vs oracle {len(ref64)}")
    m = min(res64.iters, len(ref64))
    h64 = res64.history.cpu().tolist()
    worst64 = max(abs(h / r - 1) for h, r in zip(h64[:m], ref64[:m]))
    check(worst64 <= 1e-6, f"f64 128^3: history rtol {worst64}")
    print(f"f64 128^3: {res64.iters} iterations (f64 oracle {len(ref64)}), "
          f"history rtol {worst64:.2e}", flush=True)
    del prob64, res64

    # ---- 6. float32 at 512^3 ---------------------------------------------------
    stamp(6)
    prob512 = Problem.poisson_cube(512, dtype=torch.float32, device="cuda")
    sync()
    zero_counts()
    t0 = time.perf_counter()
    res512 = solve(prob512, "sor2sma", omega=OMEGA, itr_max=20000)
    sync()
    wall512 = time.perf_counter() - t0
    counts = read_counts()
    check(bool(torch.isfinite(res512.x).all()), "512^3: field not finite")
    check(abs(res512.iters - 5781) <= 5781 * 2 // 100,
          f"512^3: {res512.iters} iterations vs the f64 oracle's 5781")
    check(res512.iters == 5787, f"512^3: {res512.iters} iterations, not 5787")
    # beyond the L2 the dispatch's chain runs the one-pass tile form, and
    # the stopping chunk's replay K1's tile form
    path_launches["rb_sweeps_n_tile"] = counts["rb_sweeps_n_tile"]
    path_launches["rb_single_tile"] = counts["rb_single_tile"]
    check(counts["rb_single_tile"] > 0 and counts["rb_single"] == 0,
          f"512^3: the replay did not run K1's tile form "
          f"({counts['rb_single_tile']} tile, {counts['rb_single']} row launches)")
    check(counts["rb_sweeps_n_tile"] > 0 and counts["rb_sweeps_n"] == 0,
          f"512^3: the tile form was not launched ({counts['rb_sweeps_n_tile']} "
          f"tile, {counts['rb_sweeps_n']} row launches)")
    print(f"512^3 f32: {res512.iters} iterations (f64 oracle 5781), "
          f"res {res512.res:e}, wall {wall512:.3f} s, launches "
          f"{ {k: counts[k] for k in ('rb_sweeps_n_tile', 'rb_single_tile')} } {tag}",
          flush=True)
    # phase 14 holds the distributed 512^3 solve to this count and field
    iters512, x512 = res512.iters, res512.x
    # the MAF chain the dispatch builds there (the tile form's MAF kernel):
    # 20 fixed sweeps, counts zeroed just before; then the same sweeps of
    # its plain twin, bit for bit
    mc512 = Problem.poisson_cube(512, device=dev, maf=True).mc
    chain512 = get_fused_step("sor2sma", prob512.grid, OMEGA, mc=mc512,
                              b_is_zero=True)
    x_chain = chain512.pad(prob512.x0)
    sync()
    zero_counts()
    x_chain = fixed_sweeps(chain512, x_chain, None, 20)
    sync()
    path_launches["rb_sweeps_n_maf_tile"] = read_counts()["rb_sweeps_n_maf_tile"]
    check(path_launches["rb_sweeps_n_maf_tile"] == 20 // chain512.iters_per_call,
          f"512^3 MAF chain: {path_launches['rb_sweeps_n_maf_tile']} tile launches")
    check(bool(torch.isfinite(x_chain).all()), "512^3 MAF chain: not finite")
    twin512 = get_fused_step("sor2sma", prob512.grid, OMEGA, mc=mc512,
                             b_is_zero=True, plain=True)
    check(twin512.iters_per_call == chain512.iters_per_call,
          "512^3 MAF chain: the twin's depth differs")
    x_twin = fixed_sweeps(twin512, twin512.pad(prob512.x0), None, 20)
    sync()
    check(torch.equal(x_chain, x_twin),
          f"512^3 MAF chain: field differs from the plain twin's by "
          f"{float((x_chain - x_twin).abs().max())}")
    print(f"512^3 f32 MAF chain (dispatch): 20 fixed sweeps in "
          f"{path_launches['rb_sweeps_n_maf_tile']} tile launches of n="
          f"{chain512.iters_per_call}, field bitwise the plain twin's {tag}",
          flush=True)
    del prob512, res512, chain512, twin512, x_chain, x_twin, mc512

    # ---- 7. the slice-2 paths at 128^3 f32 -------------------------------------
    stamp(7)
    def drive(name, omega, n, variants, itr_max=10000, twin=True,
              dtype=torch.float32):
        """Solve with the counts zeroed just before and read just after;
        every kernel variant of the path must have launched.  ``twin``: also
        solve on the plain twins (None otherwise), which must stop at the
        same iteration."""
        p = Problem.poisson_cube(n, dtype=dtype, device="cuda",
                                 maf=name.endswith("_maf"))
        sync()
        zero_counts()
        t0 = time.perf_counter()
        r = solve(p, name, omega=omega, itr_max=itr_max)
        sync()
        wall = time.perf_counter() - t0
        counts = read_counts()
        for v in variants:
            check(counts[v] > 0, f"{name} {n}: {v} was not launched")
            path_launches.setdefault(v, counts[v])
        check(bool(torch.isfinite(r.x).all()), f"{name} {n}: field not finite")
        rp = None
        if twin:
            rp = solve(p, name, omega=omega, itr_max=itr_max, impl="plain")
            check(rp.iters == r.iters,
                  f"{name} {n}: {r.iters} iterations, plain twin {rp.iters}")
        return p, r, rp, wall, {v: counts[v] for v in variants}

    # The f32 oracle's jacobi and jacobi_maf sum dp^2 serially in float32
    # over all 2M points (res1 is REAL, cz_solver.f90:284-387), which moves
    # their curves by rtol 1.52e-3 at 128^3; K4 folds float32 row sums in
    # float64.  Their counts are held to the f32 oracle's, their curves to
    # the same oracle with float64 sums (HIST64); sor2sma_maf's, whose
    # oracle sums per colour, to the f32 oracle's.
    for name, omega, oracle, variants, curve in (
        ("sor2sma_maf", OMEGA, "f32_sor2sma_maf_128_w1.5.txt",
         ("rb_sweeps_n_maf_chain", "rb_single_maf"), None),
        ("jacobi", OMEGA_J, "f32_jacobi_128_w0.8.txt", ("k4_jacobi",),
         "f32_jacobi_128_w0.8_f64sum.txt"),
        ("jacobi_maf", OMEGA_J, "f32_jacobi_maf_128_w0.8.txt",
         ("k4_jacobi_maf",), "f32_jacobi_maf_128_w0.8_f64sum.txt"),
    ):
        p, r, rp, wall, cnt = drive(name, omega, 128, variants)
        ref = load_history(oracle)
        check(abs(r.iters - len(ref)) <= len(ref) * 2 // 100,
              f"{name} 128^3: {r.iters} iterations vs the oracle's {len(ref)}")
        if curve is not None:
            ref = load_history(curve, HIST64)
        m = min(r.iters, len(ref)) - 1
        h = r.history.cpu().tolist()
        worst = max(abs(a / b - 1) for a, b in zip(h[:m], ref[:m]))
        check(worst <= 1e-3, f"{name} 128^3: history rtol {worst}")
        ek, lk = max_error_loc(p.grid, r.x)
        ep, lp = max_error_loc(p.grid, rp.x)
        check(abs(ek - ep) <= 1e-5, f"{name}: Error max {ek} vs plain {ep}")
        if name.startswith("jacobi"):
            # one K4 launch a call of JACOBI_N iterations; run_iterative's
            # whole chunks run up to 15 iterations past the stop, and its
            # replay of the stopping chunk takes up to 16 one-iteration calls
            (v,) = variants
            most = -(-(r.iters + 15) // k4.JACOBI_N) + 16
            check(cnt[v] <= most, f"{name}: {cnt[v]} K4 launches for {r.iters} "
                  f"iterations (at most {most})")
            cnt["K4 launches an iteration"] = round(cnt[v] / r.iters, 3)
        print(f"{name} 128^3 f32 omega {omega}: {r.iters} iterations (f32 "
              f"oracle {len(load_history(oracle))}), res {r.res:e}, history "
              f"rtol {worst:.2e} (vs {curve or oracle}), "
              f"wall {wall:.3f} s, launches {cnt}, Error max {ek:e} at {lk} "
              f"(plain twin: {ep:e} at {lp}) {tag}", flush=True)

    # ---- 8. odd I on K4 ----------------------------------------------------------
    stamp(8)
    for name, variant in (("sor2sma", "k4_rb_color"),
                          ("sor2sma_maf", "k4_rb_color_maf")):
        p, r, rp, wall, cnt = drive(name, OMEGA, 125, (variant,))
        check(torch.equal(r.x, rp.x), f"{name} 125^3: field != plain twin's")
        # one launch an iteration (both colours), and the replay's
        check(r.iters <= cnt[variant] <= r.iters + 16,
              f"{name} 125^3: {cnt[variant]} K4 launches for {r.iters} iterations")
        print(f"{name} 125^3 f32 (odd I, K4): {r.iters} iterations, res "
              f"{r.res:e}, wall {wall:.3f} s, launches {cnt} (one a "
              f"red-black iteration), field bitwise equal to the plain "
              f"twin's {tag}", flush=True)

    # ---- 9. the line solvers ---------------------------------------------------
    stamp(9)
    # pcr_rb's oracle sums dp^2 in double, so its curve is held to the f32
    # oracle; pcr_rb_maf's and pcr_j_esa's sum in one float (ref_oracle.cpp
    # line_sweep_maf, line_sweep's JACOBI branch), so theirs to the variant
    # with float64 sums (HIST64), as jacobi's above.  Their twins at 128^3
    # would take minutes (a Python loop over k per sweep), so Error max is
    # held to the float64 oracle's (ERR_F64_128); the twin's count and field
    # are checked at 125^3 below.
    for name, omega, oracle, variant, curve in (
        ("pcr_rb", OMEGA, "f32_pcr_rb_128_w1.5.txt", "rbl", None),
        ("pcr_rb_maf", OMEGA, "f32_pcr_rb_maf_128_w1.5.txt", "rbl_maf",
         "f32_pcr_rb_maf_128_w1.5_f64sum.txt"),
        ("pcr_j_esa", OMEGA_L, "f32_pcr_j_esa_128_w1.0.txt", "line_j",
         "f32_pcr_j_esa_128_w1.0_f64sum.txt"),
    ):
        p, r, _, wall, cnt = drive(name, omega, 128, (variant,), twin=False)
        ref = load_history(oracle)
        check(abs(r.iters - len(ref)) <= len(ref) * 2 // 100,
              f"{name} 128^3: {r.iters} iterations vs the oracle's {len(ref)}")
        if curve is not None:
            ref = load_history(curve, HIST64)
        m = min(r.iters, len(ref)) - 1
        h = r.history.cpu().tolist()
        worst = max(abs(a / b - 1) for a, b in zip(h[:m], ref[:m]))
        check(worst <= 1e-3, f"{name} 128^3: history rtol {worst}")
        ek, lk = max_error_loc(p.grid, r.x)
        e64 = ERR_F64_128[name]
        check(abs(ek / e64 - 1) <= ERR_RTOL,
              f"{name}: Error max {ek} vs the f64 oracle's {e64}")
        print(f"{name} 128^3 f32 omega {omega}: {r.iters} iterations (f32 "
              f"oracle {len(load_history(oracle))}), res {r.res:e}, history "
              f"rtol {worst:.2e} (vs {curve or oracle}), wall {wall:.3f} s, "
              f"launches {cnt}, Error max {ek:e} at {lk} (f64 oracle "
              f"{e64:e}) {tag}", flush=True)
        del p, r

    # K6's MAF line-Jacobi has no solver name of its own (the reference has
    # no pcr_j_esa_maf): drive it through the dispatch in fixed sweeps.
    p = Problem.poisson_cube(128, dtype=torch.float32, device="cuda", maf=True)
    step = get_fused_step("pcr", p.grid, OMEGA_L, mc=p.mc, b_is_zero=True)
    sync()
    zero_counts()
    xl = step.unpad(fixed_sweeps(step, step.pad(p.x0), None, 60))
    sync()
    path_launches["line_j_maf"] = read_counts()["line_j_maf"]
    check(path_launches["line_j_maf"] == 60,
          f"MAF line-Jacobi: {path_launches['line_j_maf']} launches")
    check(bool(torch.isfinite(xl).all()), "MAF line-Jacobi: field not finite")
    print(f"MAF line-Jacobi 128^3 f32: 60 fixed sweeps in "
          f"{path_launches['line_j_maf']} launches {tag}", flush=True)
    del p, step, xl

    # f64 pcr_rb at 64^3 against the f64 oracle
    p, r, _, _, _ = drive("pcr_rb", OMEGA, 64, ("rbl",), twin=False,
                          dtype=torch.float64)
    ref64 = load_history("f64_pcr_rb_64_w1.5.txt")
    check(abs(r.iters - len(ref64)) <= max(1, len(ref64) // 100),
          f"f64 pcr_rb 64^3: {r.iters} vs oracle {len(ref64)}")
    m = min(r.iters, len(ref64))
    h = r.history.cpu().tolist()
    worst64 = max(abs(a / b - 1) for a, b in zip(h[:m], ref64[:m]))
    check(worst64 <= 1e-6, f"f64 pcr_rb 64^3: history rtol {worst64}")
    print(f"f64 pcr_rb 64^3: {r.iters} iterations (f64 oracle {len(ref64)}), "
          f"history rtol {worst64:.2e}", flush=True)

    # odd I: K6's red-black form, against the twin for the constant form
    p, r, rp, wall, cnt = drive("pcr_rb", OMEGA, 125, ("line_rb",))
    check(torch.equal(r.x, rp.x), "pcr_rb 125^3: field != plain twin's")
    print(f"pcr_rb 125^3 f32 (odd I, K6): {r.iters} iterations, res "
          f"{r.res:e}, wall {wall:.3f} s, launches {cnt}, field bitwise equal "
          f"to the plain twin's {tag}", flush=True)
    odd_iters = r.iters
    p, r, _, wall, cnt = drive("pcr_rb_maf", OMEGA, 125, ("line_rb_maf",),
                               twin=False)
    check(abs(r.iters - odd_iters) <= odd_iters * 2 // 100,
          f"pcr_rb_maf 125^3: {r.iters} iterations vs pcr_rb's {odd_iters}")
    print(f"pcr_rb_maf 125^3 f32 (odd I, K6-MAF): {r.iters} iterations, res "
          f"{r.res:e}, wall {wall:.3f} s, launches {cnt} {tag}", flush=True)
    del p, r, rp

    # ---- 10. stretched grids, float64 -----------------------------------------
    stamp(10)
    # K2 (the MAF pair with a streamed b) runs only where b is nonzero, as
    # in the stretched manufactured problem: its launches at the shape and
    # dtype phase 12 times it at, 128^3 f32
    p, _ = Problem.manufactured_stretched(128, dtype=f32, family="relax",
                                          device=dev)
    zero_counts()
    r = solve(p, "sor2sma_maf", omega=OMEGA, itr_max=20000)
    sync()
    counts = read_counts()
    path_launches["rb_sweeps_n_maf"] = counts["rb_sweeps_n_maf"]
    check(counts["rb_sweeps_n_maf"] > 0 and counts["rb_sweeps_n_maf_chain"] == 0,
          f"stretched sor2sma_maf 128^3: the pair with b was not launched "
          f"({counts['rb_sweeps_n_maf']}; chain {counts['rb_sweeps_n_maf_chain']})")
    check(bool(torch.isfinite(r.x).all()) and r.res < float(r.history[0]),
          f"stretched sor2sma_maf 128^3: res {r.res}, first {r.history[0]}")
    print(f"stretched f32 sor2sma_maf 128^3 (K2): {r.iters} iterations, res "
          f"{r.res:e}, launches {counts['rb_sweeps_n_maf']} {tag}", flush=True)
    del p, r
    # the line solvers solve L x = b, the point sweeps take rp + b: the
    # stretched problem's "krylov" sign for pcr_rb_maf
    for name, omega, variant, family in (
            ("sor2sma_maf", OMEGA, "rb_sweeps_n_maf", "relax"),
            ("jacobi_maf", OMEGA_J, "k4_jacobi_maf", "relax"),
            ("pcr_rb_maf", OMEGA, "rbl_maf", "krylov")):
        errs, its = {}, {}
        for n in (24, 48):
            p, u = Problem.manufactured_stretched(n, dtype=torch.float64,
                                                  family=family, device=dev)
            zero_counts()
            r = solve(p, name, omega=omega, itr_max=40000, eps=1e-9)
            sync()
            check(read_counts()[variant] > 0, f"stretched {name}: {variant} idle")
            check(r.res < 1e-8, f"stretched {name} {n}: res {r.res}")
            errs[n] = float(((r.x - u).abs() * p.msk).max())
            its[n] = r.iters
        ratio = errs[24] / errs[48]
        check(3.4 < ratio < 5.0, f"stretched {name}: h^2 ratio {ratio}")
        print(f"stretched f64 {name}: err 24^3 {errs[24]:.4e} ({its[24]} it), "
              f"48^3 {errs[48]:.4e} ({its[48]} it), ratio {ratio:.3f} "
              f"(h^2 band 3.4-5.0)", flush=True)

    # ---- 11. the CLI -------------------------------------------------------------
    stamp(11)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p]
    )
    # (directory, solver, omega, process division); the last is solve_dist
    runs = (("sor2sma", "sor2sma", "1.5", ()), ("jacobi", "jacobi", "0.8", ()),
            ("sor2sma_maf", "sor2sma_maf", "1.5", ()),
            ("pcr_rb", "pcr_rb", "1.5", ()),
            ("sor2sma_dist", "sor2sma", "1.5", ("2", "2", "2")),
            ("pcr_rb_dist", "pcr_rb", "1.5", ("2", "2", "2")))
    cli_iters, cli_err = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for label, solver, omega, gdv in runs:
            d = Path(tmp) / label
            d.mkdir()
            procs.append((label, solver, d, subprocess.Popen(
                [sys.executable, "-m", "cubez_tpu_torch.cli", "124", "124",
                 "124", solver, "10000", omega, *gdv],
                cwd=d, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            )))
        for label, solver, d, proc in procs:
            out, errs_ = proc.communicate(timeout=300)
            check(proc.returncode == 0,
                  f"CLI {label} exited {proc.returncode}:\n{errs_}")
            hist_file = d / f"{solver}.txt"
            check(hist_file.exists(), f"CLI wrote no {solver}.txt")
            check(hist_file.read_text().startswith("Itration      Residual\n"),
                  f"CLI {label} history header")
            check("Error max" in out, f"CLI {label} printed no Error max")
            for ln in out.splitlines():
                if ln.startswith(("Iter =", "wall =", "Error max", "mesh")):
                    print(f"CLI 124^3 {label}: {ln.strip()}")
                if ln.startswith("Iter ="):
                    cli_iters[label] = int(ln.split()[2])
                if ln.startswith("Error max"):
                    cli_err[label] = float(ln.split()[3])
                if solver not in JAX_CLI_124 or label != solver:
                    continue
                its, err_j = JAX_CLI_124[solver]
                if ln.startswith("Iter ="):
                    it = int(ln.split()[2])
                    check(abs(it - its) <= its * 2 // 100,
                          f"CLI {solver}: {it} iterations vs the JAX CLI's {its}")
                if ln.startswith("Error max"):
                    e = float(ln.split()[3])
                    check(abs(e / err_j - 1) <= ERR_RTOL,
                          f"CLI {solver}: Error max {e} vs the JAX CLI's {err_j}")
            if label.endswith("_dist"):
                check("mesh division (z,x,y) = (2, 2, 2) on 1 device(s)" in out,
                      f"CLI {label}: no (2, 2, 2) mesh")
    check(cli_iters["sor2sma_dist"] == cli_iters["sor2sma"],
          f"CLI 124^3: solve_dist {cli_iters['sor2sma_dist']} iterations, "
          f"serial {cli_iters['sor2sma']}")
    # block-local K-lines (K split) change the trajectory: the count and
    # Error max are held to the JAX package's jnp dist step on that mesh
    its, err_j = JAX_DIST_CLI_124["pcr_rb"]
    it, e = cli_iters["pcr_rb_dist"], cli_err["pcr_rb_dist"]
    check(abs(it - its) <= its * 2 // 100,
          f"CLI pcr_rb over 2 2 2: {it} iterations vs the JAX dist {its}")
    check(abs(e / err_j - 1) <= ERR_RTOL,
          f"CLI pcr_rb over 2 2 2: Error max {e} vs the JAX dist {err_j}")
    print(f"CLI 124^3 pcr_rb over (2, 2, 2): {it} iterations (JAX jnp dist "
          f"{its}; serial CLI {cli_iters['pcr_rb']}), Error max {e:e} (JAX "
          f"dist {err_j:e}) {tag}", flush=True)

    # ---- 12. timing ------------------------------------------------------------
    stamp(12)
    def events_ms(fn, reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / reps

    def device_time(prof, kernel=None):
        """(device us, device events) of a torch.profiler run: the card's own
        events (kernels, copies; those whose name holds ``kernel``), not
        the solver labels the profiler mirrors on the card's timeline
        (user annotations, whose ranges span those events)."""
        us = n_ev = 0
        for ev in prof.key_averages():
            if (ev.device_type != torch.autograd.DeviceType.CUDA
                    or getattr(ev, "is_user_annotation", False)
                    or (kernel is not None and kernel not in ev.key)):
                continue
            t = getattr(ev, "self_device_time_total", None)
            t = ev.self_cuda_time_total if t is None else t
            if t > 0:
                us += t
                n_ev += ev.count
        return us, n_ev

    dgen = torch.Generator(device=dev).manual_seed(SEED)

    def per_iter_ms(step, shape, short, long, reps=3):
        """Long-minus-short ms per iteration over distinct random starts."""
        starts = [step.pad(torch.rand(shape, device=dev, generator=dgen))
                  for _ in range(reps + 1)]
        fixed_sweeps(step, starts[-1], None, short)  # warm-up
        med = {}
        for count in (short, long, long, short):
            ts = []
            for s in starts[:reps]:
                x = s.clone()
                ts.append(events_ms(lambda: fixed_sweeps(step, x, None, count), 1))
            med.setdefault(count, []).append(statistics.median(ts))
        return (min(med[long]) - min(med[short])) / (long - short)

    # (label, solver kind, MAF, n of the packed chain or None for the
    # dispatch, {size: ((kernel short, long), (plain short, long, reps))});
    # the line twins loop over k in Python, so they get few iterations
    timed = (
        ("sor2sma", "sor2sma", False, None,
         {128: ((60, 600), (6, 36, 3)), 512: ((12, 72), (6, 18, 3))}),
        ("jacobi (K4)", "jacobi", False, None,
         {128: ((60, 600), (6, 36, 3)), 512: ((12, 72), (4, 12, 1))}),
        ("sor2sma_maf (dispatch)", "sor2sma", True, None,
         {128: ((60, 600), (4, 16, 3)), 512: ((12, 72), (2, 6, 1))}),
        ("MAF chain n=6 (K3-MAF)", "sor2sma", True, 6,
         {128: ((60, 600), (6, 18, 3)), 512: ((12, 72), (6, 12, 1))}),
        ("pcr_rb (K5)", "pcr_rb", False, None,
         {128: ((40, 400), (2, 6, 3)), 512: ((4, 24), (1, 3, 1))}),
        ("pcr_rb_maf (K5-MAF)", "pcr_rb", True, None,
         {128: ((40, 400), (2, 6, 3)), 512: ((4, 24), (1, 3, 1))}),
        ("pcr_j_esa (K6)", "pcr", False, None,
         {128: ((40, 400), (2, 6, 3)), 512: ((4, 24), (1, 3, 1))}),
    )
    omegas = {"jacobi": OMEGA_J, "pcr": OMEGA_L}
    timing = {}
    for n in (128, 512):
        g = Grid(n, n, n, f32, dev)
        mc = Problem.poisson_cube(n, device=dev, maf=True).mc
        for label, kind, maf, nx, sizes in timed:
            (ks, kl), (ps, pl, preps) = sizes[n]
            for impl in ("kernel", "plain"):
                plain = impl == "plain"
                if nx is None:
                    step = get_fused_step(kind, g, omegas.get(kind, OMEGA),
                                          mc=mc if maf else None, plain=plain,
                                          b_is_zero=True)
                else:
                    step = rb.make_packed_sweepnx(g.shape_kij, f32, omega=OMEGA,
                                                  n=nx, mc=mc, plain=plain)
                short, long, reps = (ks, kl, 3) if not plain else (ps, pl, preps)
                ms = per_iter_ms(step, g.shape_kij, short, long, reps)
                check(ms > 0, f"timing {label} {impl} {n}^3: non-positive")
                timing[(label, impl, n)] = ms
                print(f"timing {label} {n}^3 f32 {impl} (n="
                      f"{step.iters_per_call} per call): {ms * 1e3:.3f} "
                      f"us/iteration, {g.num_inner / (ms * 1e-3) / 1e6:.1f} "
                      f"Mcell-updates/s {tag}", flush=True)
        del g, mc

    # per-call kernel times at the main path's shape (128^3 f32), each
    # against its plain twin, in turns: plain, kernel, kernel, plain
    sh = (128, 128, 128)
    xs = rb.pack_rb(rand(sh, f32)).to(dev)
    bs = rb.pack_rb(rand(sh, f32)).to(dev)
    xu = rand(sh, f32).to(dev)
    xl = k5.pack_rb_lines(rand(sh, f32).to(dev))
    tab = rb.maf_tables(Problem.poisson_cube(128, device=dev, maf=True).mc,
                        sh, f32)
    out = torch.empty_like(xu)  # line-Jacobi's second field
    mc128 = Problem.poisson_cube(128, device=dev, maf=True).mc

    def rb_calls(name, x, b, n, tab, form=None):
        """(kernel, twin) calls of rb_sweeps_n's launcher (the plan's form,
        or ``form``) on x, each handing the launcher the field its last
        call wrote, as the steps do; the twin updates its own copy.  The
        first call of each is held to the other here (the field bit for
        bit, r2 to rtol 1e-5)."""
        rb._force_plan = {} if form is None else {"form": form}
        launch = rb.RbSweeps(n, OMEGA, 0, tab)
        held, twin = [x.clone(), torch.empty_like(x)], [x.clone()]

        def run():
            r2 = launch(held[0], b, held[1])
            held.reverse()
            return r2

        def run_twin():
            return rb.packed_sweeps_plain(twin[0], b, n, OMEGA, tab=tab)[1]
        rk, rp = run(), run_twin()
        sync()
        rb._force_plan = {}
        e = float((held[0] - twin[0]).abs().max())
        rel = float(((rk - rp).abs() / rp.abs()).max())
        where = f"{name} {tuple(x.shape)} n={n} {launch.plan.form}"
        check(launch.plan.form == ("tile" if name.endswith("_tile") else "rows"),
              f"timed call: the plan's form: {where}")
        check(e == 0.0, f"timed call: field differs by {e}: {where}")
        check(rel <= 1e-5, f"timed call: residual rtol {rel}: {where}")
        err[name] = max(err.get(name, 0.0), e)
        print(f"plan {tuple(x.shape)} n={n} maf={tab is not None} b="
              f"{b is not None}: {launch.plan.form}, grid {launch.grid} CTAs, "
              f"{launch.plan} {tag}", flush=True)
        return run, run_twin

    def k1_calls(name, x, b, mc, form=None):
        """(kernel, twin) calls of K1's single step (one launch an
        iteration, both colours; the plan's form, or ``form``) on x, each
        handing the step the field its last call returned.  The first call
        of each is held to the other here (bit for bit)."""
        sh_ = (x.shape[1], 2 * x.shape[2], x.shape[3])
        kw = dict(omega=OMEGA, b_is_zero=b is None, mc=mc)
        rb._force_plan = {} if form is None else {"form": form}
        step = rb.make_packed_sweep(sh_, x.dtype, **kw)
        held = [x.clone()]
        twin_step = rb.make_packed_sweep(sh_, x.dtype, plain=True, **kw)
        twin = [x.clone()]

        def run():
            held[0], r2 = step(held[0], b)
            return r2

        def run_twin():
            twin[0], r2 = twin_step(twin[0], b)
            return r2
        rk, rp = run(), run_twin()
        sync()
        rb._force_plan = {}
        e = float((held[0] - twin[0]).abs().max())
        where = f"{name} {sh_} {step.launcher.plan.form}"
        check(step.launcher.plan.form == ("tile" if name.endswith("_tile") else "rows"),
              f"timed call: the plan's form: {where}")
        check(e == 0.0, f"timed call: field differs by {e}: {where}")
        check(float((rk - rp).abs() / rp.abs()) <= 1e-5, f"timed call: r2: {where}")
        err[name] = max(err.get(name, 0.0), e)
        print(f"K1 plan {sh_} maf={mc is not None} b={b is not None}: "
              f"{step.launcher.plan.form}, grid {step.launcher.grid} CTAs {tag}",
              flush=True)
        return run, run_twin

    def k4_calls(kind, x, mc):
        """(kernel, twin) calls of K4's step on x's shape, each handing the
        step the field its last call returned."""
        out_ = []
        for plain in (False, True):
            st = k4.make_fused_sweep(kind, tuple(x.shape), x.dtype,
                                     omega=OMEGA_J if kind == "jacobi" else OMEGA,
                                     b_is_zero=True, mc=mc, plain=plain)
            held = [x.clone()]

            def run(st=st, held=held):
                held[0], r2 = st(held[0], None)
                return r2
            out_.append(run)
        return tuple(out_)

    calls = {
        # K1: one iteration a launch (both colours), as the replays call it
        "rb_single": k1_calls("rb_single", xs, None, None),
        "rb_single_maf": k1_calls("rb_single_maf", xs, None, mc128),
        # K3 at the dispatch's depth (the row form at 128^3), K2 (the MAF
        # pair with b), the MAF chain
        "rb_sweeps_n": rb_calls("rb_sweeps_n", xs, None, rb.chain_depth(sh),
                                None),
        "rb_sweeps_n_maf": rb_calls("rb_sweeps_n_maf", xs, bs, 2, tab),
        "rb_sweeps_n_maf_chain": rb_calls("rb_sweeps_n_maf_chain", xs, None,
                                          rb.chain_depth(sh, f32, True), tab),
        # K4 through its steps, as the paths call it: a Jacobi call runs
        # JACOBI_N iterations, a red-black call one, into the step's buffers
        "k4_jacobi": k4_calls("jacobi", xu, None),
        "k4_jacobi_maf": k4_calls("jacobi", xu, mc128),
        "k4_rb_color": k4_calls("sor2sma", xu, None),
        "k4_rb_color_maf": k4_calls("sor2sma", xu, mc128),
        "rbl": (lambda: k5.rbl(xl, None, OMEGA),
                lambda: k5.rbl_plain(xl, None, OMEGA)),
        "rbl_maf": (lambda: k5.rbl(xl, None, OMEGA, tab=tab),
                    lambda: k5.rbl_plain(xl, None, OMEGA, tab=tab)),
        "line_j": (lambda: k6.line_j(xu, None, OMEGA_L, out=out),
                   lambda: k6.line_j_plain(xu, None, OMEGA_L)),
        "line_j_maf": (lambda: k6.line_j(xu, None, OMEGA_L, tab, out=out),
                       lambda: k6.line_j_plain(xu, None, OMEGA_L, tab)),
        "line_rb": (lambda: k6.line_rb(xu, None, OMEGA),
                    lambda: k6.line_rb_plain(xu, None, OMEGA)),
        "line_rb_maf": (lambda: k6.line_rb(xu, None, OMEGA, tab=tab),
                        lambda: k6.line_rb_plain(xu, None, OMEGA, tab=tab)),
    }
    per_call = {}
    for name, (kfn, pfn) in calls.items():
        kfn(), pfn()
        sync()
        p1 = events_ms(pfn, 5)
        k1 = events_ms(kfn, 50)
        k2 = events_ms(kfn, 50)
        p2 = events_ms(pfn, 5)
        per_call[name] = (min(k1, k2), min(p1, p2))
        print(f"per call at 128^3 f32: {name} {per_call[name][0]:.4f} ms, "
              f"plain twin {per_call[name][1]:.4f} ms {tag}")
    check(all(bool(torch.isfinite(t).all()) for t in (xs, xu, xl, out)),
          "timing fields not finite")
    # K4's Jacobi, K5 and K6 at 512^3 too, where the bytes bound them: the
    # same calls, kernel against twin in turns (the line twins loop over k
    # in Python: one call each side)
    sh5 = (512, 512, 512)
    xl5 = k5.pack_rb_lines(torch.rand(sh5, device=dev, generator=dgen) * 2 - 1)
    xu5 = torch.rand(sh5, device=dev, generator=dgen) * 2 - 1
    out5 = torch.empty_like(xu5)
    mc512 = Problem.poisson_cube(512, device=dev, maf=True).mc
    tab5 = rb.maf_tables(mc512, sh5, f32)
    xs5 = rb.pack_rb(torch.rand(sh5, device=dev, generator=dgen) * 2 - 1)
    bs5 = rb.pack_rb(torch.rand(sh5, device=dev, generator=dgen) * 2 - 1)
    n5, nm5 = rb.chain_depth(sh5), rb.chain_depth(sh5, f32, True)
    calls512 = {
        # K3: the row form at the 128^3 depth and the tile form at the
        # dispatch's (the form the plan takes at 512^3); K2 (the MAF pair
        # with b); the MAF chain in both forms
        "rb_sweeps_n": rb_calls("rb_sweeps_n", xs5, None, rb.chain_depth(sh),
                                None, "rows"),
        "rb_sweeps_n_tile": rb_calls("rb_sweeps_n_tile", xs5, None, n5, None),
        "rb_sweeps_n_maf": rb_calls("rb_sweeps_n_maf", xs5, bs5, 2, tab5),
        "rb_sweeps_n_maf_chain": rb_calls("rb_sweeps_n_maf_chain", xs5, None,
                                          rb.chain_depth(sh, f32, True), tab5,
                                          "rows"),
        "rb_sweeps_n_maf_tile": rb_calls("rb_sweeps_n_maf_tile", xs5, None, nm5,
                                         tab5),
        # K1 at 512^3: the one-pass tile form the replays take there, and
        # the row form beside it
        "rb_single": k1_calls("rb_single", xs5, None, None, "rows"),
        "rb_single_tile": k1_calls("rb_single_tile", xs5, None, None),
        "k4_jacobi": k4_calls("jacobi", xu5, None),
        "k4_jacobi_maf": k4_calls("jacobi", xu5, mc512),
        "rbl": (lambda: k5.rbl(xl5, None, OMEGA),
                lambda: k5.rbl_plain(xl5, None, OMEGA)),
        "rbl_maf": (lambda: k5.rbl(xl5, None, OMEGA, tab=tab5),
                    lambda: k5.rbl_plain(xl5, None, OMEGA, tab=tab5)),
        "line_j": (lambda: k6.line_j(xu5, None, OMEGA_L, out=out5),
                   lambda: k6.line_j_plain(xu5, None, OMEGA_L)),
        "line_j_maf": (lambda: k6.line_j(xu5, None, OMEGA_L, tab5, out=out5),
                       lambda: k6.line_j_plain(xu5, None, OMEGA_L, tab5)),
        "line_rb": (lambda: k6.line_rb(xu5, None, OMEGA),
                    lambda: k6.line_rb_plain(xu5, None, OMEGA)),
        "line_rb_maf": (lambda: k6.line_rb(xu5, None, OMEGA, tab=tab5),
                        lambda: k6.line_rb_plain(xu5, None, OMEGA, tab=tab5)),
    }
    per_call_512 = {}
    for name, (kfn, pfn) in calls512.items():
        kfn(), pfn()
        sync()
        p1 = events_ms(pfn, 1)
        k1 = events_ms(kfn, 10)
        k2 = events_ms(kfn, 10)
        p2 = events_ms(pfn, 1)
        per_call_512[name] = (min(k1, k2), min(p1, p2))
        print(f"per call at 512^3 f32: {name} {per_call_512[name][0]:.4f} ms, "
              f"plain twin {per_call_512[name][1]:.4f} ms {tag}", flush=True)
    check(all(bool(torch.isfinite(t).all()) for t in (xl5, xu5, out5)),
          "512^3 line timing fields not finite")
    del xl5, xu5, out5, tab5, calls512, mc512, xs5, bs5

    # the least work of each call above: (bytes that must move, each input
    # read once and each output written once; operations), float32 at
    # 128^3.  Operations per updated point: a constant-coefficient update
    # 11 (five adds, the fma, the omega product, the centre add, dp^2 and
    # its sum), MAF 20 (six weighted terms, dd, the division), a line
    # relaxation 14 (the right-hand side, the Thomas sweeps with
    # precomputed factors, the update), its MAF form 24.
    fb = 4 * 128**3  # one float32 field
    inner = 126**3
    work = {
        # K1: an iteration reads x and writes out once
        "rb_single": (2 * fb, 11 * inner),
        "rb_single_maf": (2 * fb, 20 * inner),
        "rb_sweeps_n": (2 * fb, rb.chain_depth(sh) * 11 * inner),
        "rb_sweeps_n_maf": (3 * fb, 2 * 21 * inner),
        "rb_sweeps_n_maf_chain": (2 * fb,
                                  rb.chain_depth(sh, f32, True) * 20 * inner),
        # a K4 Jacobi call runs JACOBI_N iterations, reading x and writing
        # out once; a red-black call one iteration, both colours
        "k4_jacobi": (2 * fb, k4.JACOBI_N * 11 * inner),
        "k4_jacobi_maf": (2 * fb, k4.JACOBI_N * 20 * inner),
        "k4_rb_color": (2 * fb, 11 * inner),
        "k4_rb_color_maf": (2 * fb, 20 * inner),
        "rbl": (2 * fb, 14 * inner),
        "rbl_maf": (2 * fb, 24 * inner),
        "line_j": (2 * fb, 14 * inner),
        "line_j_maf": (2 * fb, 24 * inner),
        "line_rb": (2 * fb, 14 * inner),
        "line_rb_maf": (2 * fb, 24 * inner),
    }
    del xs, bs, xu, xl, out
    # the least work of the 512^3 calls of K2/K3 (the others scale the
    # 128^3 row's operations, over two fields): each at its own depth; the
    # tile form's rows, whose path runs at 512^3 only, take these as their
    # own (ms, bound)
    fb5, inner5 = 4 * 512**3, 510**3
    d128, dm128 = rb.chain_depth(sh), rb.chain_depth(sh, f32, True)
    work512 = {
        "rb_sweeps_n": (2 * fb5, d128 * 11 * inner5),
        "rb_sweeps_n_tile": (2 * fb5, n5 * 11 * inner5),
        "rb_sweeps_n_maf": (3 * fb5, 2 * 21 * inner5),
        "rb_sweeps_n_maf_chain": (2 * fb5, dm128 * 20 * inner5),
        "rb_sweeps_n_maf_tile": (2 * fb5, nm5 * 20 * inner5),
        "rb_single": (2 * fb5, 11 * inner5),
        "rb_single_tile": (2 * fb5, 11 * inner5),
    }
    for name in ("rb_sweeps_n_tile", "rb_sweeps_n_maf_tile", "rb_single_tile"):
        work[name] = work512[name]
        per_call[name] = per_call_512[name]

    # ---- 13. the distributed kernels vs their twins ----------------------------
    stamp(13)
    # (global shape for K7, for K8, division, block coordinates to check);
    # the second mesh splits K only and is ragged in J (K7 needs even
    # blocks, K8 takes an odd J)
    dist_cases = (((128, 128, 128), (128, 128, 128), (2, 2, 2),
                   ((1, 1, 1), (0, 1, 0))),
                  ((64, 48, 46), (64, 48, 45), (2, 1, 1), ((1, 0, 0),)))
    # (n, ring depth, MAF): the window chain, its one-iteration form on the
    # depth-12 ring, the MAF chain at the JAX package's MAF depths
    k7_cases = ((2, 4, False), (6, 12, False), (1, 12, False), (2, 4, True),
                (3, 6, True))
    k8_variants = (("jacobi", None, "all"), ("sor2sma", 0, "all"),
                   ("sor2sma", 1, "all"), ("sor2sma", None, "all"),
                   ("sor2sma", 0, "interior"), ("sor2sma", 1, "interior"),
                   ("sor2sma", 0, "shell"), ("sor2sma", 1, "shell"))
    n_cmp = 0
    for gsz, kg, div, coords in dist_cases:
        bsz = tuple(g // d for g, d in zip(gsz, div))
        kb = tuple(g // d for g, d in zip(kg, div))
        split = tuple(d > 1 for d in div)
        for dtype in (f32, f64):
            tol = 0.0 if dtype == f32 else 1e-14
            mc = stretched_mc(gsz, dtype)
            for c in coords:
                origin = tuple(a * b for a, b in zip(c, bsz))
                for n, h, maf in k7_cases:
                    kw = dict(omega=OMEGA, n=n, h=h, split=split,
                              mc=mc if maf else None)
                    ks = k7.make_dist_packed_sweepnx(bsz, gsz, dtype, **kw)
                    ps = k7.make_dist_packed_sweepnx(bsz, gsz, dtype, plain=True,
                                                     **kw)
                    tab = ks.block_tables(origin, dev) if maf else None
                    Ke, _, Je, I2e = k7.ext_dims(bsz, ks.hs)
                    x = rand((2, Ke, I2e, Je), dtype).to(dev)
                    xk, xp = x.clone(), x.clone()
                    rk, rp = ks(xk, origin, tab), ps(xp, origin, tab)
                    sync()
                    name = "dist_rb_sweeps" + ("_maf" if maf else "")
                    e = float((xk - xp).abs().max())
                    err[name] = max(err.get(name, 0.0), e)
                    rel = float(((rk - rp).abs() / rp.abs()).max())
                    where = f"K7 n={n} h={h} maf={maf} {gsz} {div} {c} {dtype}"
                    check(torch.isfinite(xk).all(), f"non-finite field: {where}")
                    check(e <= tol, f"field differs by {e}: {where}")
                    check(rel <= 1e-5, f"residual differs by rtol {rel}: {where}")
                    n_cmp += 1
                # K8 on the ghosted block
                geom = (*(a * b for a, b in zip(c, kb)), *kg, 1)
                x = rand(k8.block_layout(kb), dtype).to(dev)
                b = rand(x.shape, dtype).to(dev)
                for kind, colour, region in k8_variants:
                    for bb in (None, b):
                        xk, rk = k8.block_sweep(x.clone(), bb, kind, colour,
                                                OMEGA, geom, region)
                        xp, rp = k8.block_sweep_plain(x.clone(), bb, kind, colour,
                                                      OMEGA, geom, region)
                        sync()
                        name = "block_sweep_" + k8.variant(kind, colour, region)
                        e = float((xk - xp).abs().max())
                        err[name] = max(err.get(name, 0.0), e)
                        rel = float((rk - rp).abs() / rp.abs())
                        where = (f"K8 {kind} {colour} {region} b={bb is not None}"
                                 f" {kg} {c} {dtype}")
                        check(e <= tol, f"field differs by {e}: {where}")
                        check(rel <= 1e-5, f"residual differs by rtol {rel}: "
                              f"{where}")
                        n_cmp += 1
    # the launches the dist steps make: K8 over all eight blocks of 128^3
    # in one launch, the face exchange (one launch, and gather then
    # scatter) and the residual fold, each against its twin
    check(_build.load().cz_dist_max_blocks() == dist_halo.MAX_BLOCKS,
          "csrc/dist_halo.cu and dist_halo.py disagree on MAX_BLOCKS")
    cm8 = make_mesh((128, 128, 128), devices=[dev] * 8, div=(2, 2, 2))
    org8, bs8 = cm8.offsets((128, 128, 128)), (64, 64, 64)
    table8 = [[-1 if cm8.neighbor(b, f // 2, 1 if f % 2 else -1) is None
               else cm8.neighbor(b, f // 2, 1 if f % 2 else -1) for f in range(6)]
              for b in range(8)]
    for dtype in (f32, f64):
        tol = 0.0 if dtype == f32 else 1e-14
        xs = [rand(k8.block_layout(bs8), dtype).to(dev) for _ in range(8)]
        bb8 = [rand(k8.block_layout(bs8), dtype).to(dev) for _ in range(8)]
        for kind, colour, region in k8_variants:
            for bb in (None, bb8):
                res = dist_halo.Residual(dev)
                res.start()
                got = k8.sweep_blocks([x.clone() for x in xs], bb, kind, colour,
                                      OMEGA, org8, (128, 128, 128), 1, region,
                                      res=res)
                r_k = res.total()
                want, r_p = k8.sweep_blocks_plain([x.clone() for x in xs], bb, kind,
                                                  colour, OMEGA, org8,
                                                  (128, 128, 128), 1, region)
                sync()
                name = "block_sweep_" + k8.variant(kind, colour, region)
                e = max(float((g - w).abs().max()) for g, w in zip(got, want))
                err[name] = max(err.get(name, 0.0), e)
                rel = float((r_k - sum(r_p)).abs() / sum(r_p))
                where = (f"K8 8 blocks {kind} {colour} {region} "
                         f"b={bb is not None} {dtype}")
                check(e <= tol, f"field differs by {e}: {where}")
                check(rel <= 1e-5, f"residual differs by rtol {rel}: {where}")
                n_cmp += 1
        want = dist_halo.halo_exchange_plain([x.clone() for x in xs], table8)
        got = dist_halo.halo_exchange([x.clone() for x in xs], table8)
        st = torch.empty(8 * dist_halo.staging_size(bs8), dtype=dtype, device=dev)
        split = [x.clone() for x in xs]
        dist_halo.halo_exchange(split, table8, "gather", st)
        dist_halo.halo_exchange(split, table8, "scatter", st)
        sync()
        e = max(float((g - w).abs().max()) for g, w in zip(got + split, want * 2))
        err["halo_exchange"] = max(err.get("halo_exchange", 0.0), e)
        check(e == 0.0, f"halo_exchange differs by {e} ({dtype})")
        parts = rand(4000, dtype).abs().to(dev)
        e = abs(float(dist_halo.fold_partials(parts, 4000))
                - float(dist_halo.fold_partials_plain(parts)))
        err["fold_partials"] = max(err.get("fold_partials", 0.0), e)
        check(e <= 1e-15 * float(parts.double().sum()), f"fold differs by {e}")
        n_cmp += 2
    del xs, bb8, got, want, split, st

    def packed_ring_state(gshape, div, hs, dtype, cm):
        """Extended packed blocks of a seeded field whose ring cells inside
        the grid hold other seeded values (as K7 leaves them); cells past
        the grid keep the packing's zeros."""
        st = dist_pack.to_packed_state(cm, rand(gshape, dtype).to(dev), hs)
        bs = cm.block_shape(gshape)
        Ke, Ie, Je, _ = k7.ext_dims(bs, hs)
        for b, o in enumerate(cm.offsets(gshape)):
            idx = [torch.arange(e, device=dev) + (oo - h)
                   for e, oo, h in zip((Ke, Ie, Je), o, hs)]
            inside = ((idx[0] >= 0) & (idx[0] < gshape[0]))[:, None, None] & (
                (idx[1] >= 0) & (idx[1] < gshape[1]))[None, :, None] & (
                (idx[2] >= 0) & (idx[2] < gshape[2]))[None, None, :]
            st[b] = torch.where(k7.pack_rb(inside.to(dtype)) > 0,
                                rand(tuple(st[b].shape), dtype).to(dev), st[b])
        return st

    # the pack step's launches on the card: K7 over all eight extended
    # blocks of 128^3 in one launch (n = 6, its one-iteration form on the
    # depth-12 ring, MAF n = 2) against its twin on each block, and the
    # one-launch ring refresh against its twin (the owner gather) and the
    # three-phase transitive copy, edges and corners included
    g8 = (128, 128, 128)
    for dtype in (f32, f64):
        tol = 0.0 if dtype == f32 else 1e-14
        mc8 = stretched_mc(g8, dtype)
        for n, h, maf in ((6, 12, False), (1, 12, False), (2, 4, True)):
            hs8 = (h, h, h)
            kern = k7.make_dist_packed_sweepnx(bs8, g8, dtype, omega=OMEGA, n=n,
                                               h=h, mc=mc8 if maf else None)
            tabs = [kern.block_tables(o, dev) for o in org8] if maf else None
            xs = packed_ring_state(g8, (2, 2, 2), hs8, dtype, cm8)
            want = [x.clone() for x in xs]
            before = k7.dist_rb_sweeps.launches
            r_k = k7.BlockRbSweeps(n, OMEGA, bs8, g8, hs8, org8)(xs, tabs)
            r_p = torch.stack([
                k7.dist_sweeps_plain(w, n, OMEGA, k7.geometry(bs8, g8, hs8, o), t)
                for w, o, t in zip(want, org8, tabs or [None] * 8)]).sum(0)
            sync()
            where = f"K7 8 blocks n={n} h={h} maf={maf} {dtype}"
            check(k7.dist_rb_sweeps.launches == before + 1, f"{where}: launches")
            name = "dist_rb_sweeps" + ("_maf" if maf else "")
            e = max(float((g - w).abs().max()) for g, w in zip(xs, want))
            err[name] = max(err.get(name, 0.0), e)
            rel = float(((r_k - r_p).abs() / r_p.abs()).max())
            check(e <= tol, f"field differs by {e}: {where}")
            check(rel <= 1e-5, f"residual differs by rtol {rel}: {where}")
            # the refresh, of the field K7 left
            got = [x.clone() for x in xs]
            before = k7.exchange_packed.launches
            k7.PackExchange((2, 2, 2), bs8, hs8)(got)
            twin = k7.exchange_packed_plain([x.clone() for x in xs], (2, 2, 2),
                                            bs8, hs8)
            trans = dist_pack.exchange_ghosts_packed([x.clone() for x in xs],
                                                     cm8, bs8, hs8)
            sync()
            check(k7.exchange_packed.launches == before + 1,
                  f"pack exchange h={h}: launches")
            e = max(float((g - w).abs().max()) for g, w in zip(got + twin, trans * 2))
            err["pack_exchange"] = max(err.get("pack_exchange", 0.0), e)
            check(e == 0.0, f"pack exchange h={h} {dtype} differs by {e}")
            n_cmp += 2
    del xs, want, got, twin, trans
    print(f"distributed kernels vs plain twins: {n_cmp} comparisons passed "
          f"(f32 bitwise, f64 <= 1e-14); max |field diff| "
          + ", ".join(f"{k} {v:.3e}" for k, v in sorted(err.items())
                      if k.startswith(("dist", "block", "halo", "fold", "pack"))),
          flush=True)

    # ---- 14. solve_dist on the card --------------------------------------------
    stamp(14)
    cm128 = make_mesh((128, 128, 128), devices=[dev] * 8, div=(2, 2, 2))

    def drive_dist(name, omega, p, cm, sync_mode, variants):
        """solve_dist with the counts zeroed just before and read just
        after; every kernel variant of the path must have launched."""
        sync()
        zero_counts()
        t0 = time.perf_counter()
        r = solve_dist(p, cm, name, omega=omega, itr_max=20000, sync=sync_mode)
        sync()
        wall = time.perf_counter() - t0
        counts = read_counts()
        for v in variants:
            check(counts[v] > 0, f"solve_dist {name} {sync_mode}: {v} idle")
            path_launches.setdefault(v, counts[v])
        check(bool(torch.isfinite(r.x).all()), f"solve_dist {name}: not finite")
        cnt = {v: counts[v] for v in variants}
        step_launches = sum(counts[v] for v in dist_launch_names)
        if step_launches:  # run_iterative's stopping-chunk replay included
            cnt["K8/K9 step launches an iteration"] = round(step_launches / r.iters, 3)
        return r, wall, cnt

    def hist_rtol(a, b):
        return float(((a.history - b.history) / b.history).abs().max())

    dist_tag = "(2, 2, 2), 8 blocks on the card"
    def pack_launches(cnt, variant, what):
        """On one card a pack call is the ring refresh and one K7 launch
        (which folds r2 on the card): no face exchange, no fold launch."""
        c = read_counts()
        check(cnt["pack_exchange"] == cnt[variant] and not c["halo_exchange"]
              and not c["fold_partials"], f"{what}: launches {cnt}")
        cnt["launches a call"] = (cnt["pack_exchange"] + cnt[variant]) / cnt[variant]

    for name, variant in (("sor2sma", "dist_rb_sweeps"),
                          ("sor2sma_maf", "dist_rb_sweeps_maf")):
        p = Problem.poisson_cube(128, device=dev, maf=name.endswith("_maf"))
        s_ = solve(p, name, omega=OMEGA, itr_max=10000)
        r, wall, cnt = drive_dist(name, OMEGA, p, cm128, "pack",
                                  (variant, "pack_exchange"))
        pack_launches(cnt, variant, f"{name} pack")
        worst = hist_rtol(r, s_)
        check(r.iters == s_.iters, f"{name} pack: {r.iters} vs serial {s_.iters}")
        check(worst <= 1e-5, f"{name} pack: history rtol {worst}")
        check(torch.equal(r.x, s_.x), f"{name} pack: field != the serial one")
        print(f"solve_dist {name} 128^3 f32 pack {dist_tag}: {r.iters} "
              f"iterations (serial {s_.iters}), history rtol {worst:.2e}, field "
              f"bitwise the serial one, wall {wall:.3f} s, launches {cnt} {tag}",
              flush=True)
    p = Problem.poisson_cube(128, device=dev)
    s_ = solve(p, "sor2sma", omega=OMEGA, itr_max=10000)
    rc, wall, cnt = drive_dist("sor2sma", OMEGA, p, cm128, "color",
                               ("block_sweep_colour", "halo_exchange",
                                "fold_partials"))
    check(rc.iters == s_.iters, f"color: {rc.iters} vs serial {s_.iters}")
    print(f"solve_dist sor2sma 128^3 f32 color {dist_tag}: {rc.iters} "
          f"iterations (serial {s_.iters}), history rtol {hist_rtol(rc, s_):.2e},"
          f" max |x - serial| {float((rc.x - s_.x).abs().max()):.3e}, wall "
          f"{wall:.3f} s, launches {cnt} {tag}", flush=True)
    ro, wall, cnt = drive_dist("sor2sma", OMEGA, p, cm128, "overlap",
                               ("block_sweep_interior", "block_sweep_shell"))
    check(abs(ro.iters - rc.iters) <= 1, f"overlap: {ro.iters} vs {rc.iters}")
    same = ro.iters == rc.iters
    check(not same or torch.equal(ro.x, rc.x), "overlap: field != color's")
    print(f"solve_dist sor2sma 128^3 f32 overlap {dist_tag}: {ro.iters} "
          f"iterations (color {rc.iters}), field "
          f"{'bitwise the color one' if same else 'not compared'}, wall "
          f"{wall:.3f} s, launches {cnt} {tag}", flush=True)
    sj = solve(p, "jacobi", omega=OMEGA_J, itr_max=10000)
    rj, wall, cnt = drive_dist("jacobi", OMEGA_J, p, cm128, "auto",
                               ("block_sweep_jacobi",))
    check(rj.iters == sj.iters, f"jacobi: {rj.iters} vs serial {sj.iters}")
    print(f"solve_dist jacobi 128^3 f32 omega {OMEGA_J} {dist_tag}: {rj.iters} "
          f"iterations (serial {sj.iters}), history rtol {hist_rtol(rj, sj):.2e},"
          f" wall {wall:.3f} s, launches {cnt} {tag}", flush=True)
    del rc, ro, rj, s_, sj
    # sync='iter' (unstable at omega 1.5 to tolerance on small blocks):
    # fixed sweeps against its twin
    it_k = dist_fused.make_dist_fused_step(p, cm128, "sor2sma", OMEGA,
                                           b_is_zero=True, sync="iter")
    it_p = dist_fused.make_dist_fused_step(p, cm128, "sor2sma", OMEGA,
                                           b_is_zero=True, sync="iter", plain=True)
    sync()
    zero_counts()
    xk = fixed_sweeps(it_k, dist_fused.to_block_state(cm128, p.x0), None, 60)
    sync()
    c_iter = read_counts()
    path_launches["block_sweep_both"] = c_iter["block_sweep_both"]
    check(c_iter["block_sweep_both"] == 60 and c_iter["halo_exchange"] == 60
          and c_iter["fold_partials"] == 60, f"iter: {c_iter} launches")
    xp = fixed_sweeps(it_p, dist_fused.to_block_state(cm128, p.x0), None, 60)
    check(all(torch.equal(a, b) for a, b in zip(xk, xp)), "iter: != twin")
    print(f"solve_dist sor2sma 128^3 f32 iter {dist_tag}: 60 fixed sweeps in "
          f"60 K8 launches (one over all eight blocks an iteration), 60 "
          f"exchanges, 60 folds, bitwise the twin {tag}", flush=True)
    del xk, xp, p

    p512 = Problem.poisson_cube(512, device=dev)
    cm512 = make_mesh((512, 512, 512), devices=[dev] * 8, div=(2, 2, 2))
    r, wall, cnt = drive_dist("sor2sma", OMEGA, p512, cm512, "pack",
                              ("dist_rb_sweeps", "pack_exchange"))
    pack_launches(cnt, "dist_rb_sweeps", "512^3 pack")
    check(r.iters == iters512, f"512^3 pack: {r.iters} vs serial {iters512}")
    check(torch.equal(r.x, x512), "512^3 pack: field != the serial one")
    print(f"solve_dist sor2sma 512^3 f32 pack {dist_tag}: {r.iters} iterations "
          f"(serial {iters512}, f64 oracle 5781), field bitwise the serial one, "
          f"wall {wall:.3f} s, launches {cnt} {tag}", flush=True)
    del r, p512, x512

    # ---- 15. distributed timing --------------------------------------------------
    stamp(15)

    def per_iter_ms_state(step, to_state, shape, short, long, reps=3):
        """Long-minus-short ms per iteration over distinct random starts,
        for a step on any state layout (a block list too)."""
        starts = [to_state(torch.rand(shape, device=dev, generator=dgen))
                  for _ in range(reps + 1)]

        def clone(s):
            return [t.clone() for t in s] if isinstance(s, list) else s.clone()

        fixed_sweeps(step, starts[-1], None, short)  # warm-up
        med = {}
        for count in (short, long, long, short):
            ts = []
            for s in starts[:reps]:
                x = clone(s)
                ts.append(events_ms(lambda: fixed_sweeps(step, x, None, count), 1))
            med.setdefault(count, []).append(statistics.median(ts))
        return (min(med[long]) - min(med[short])) / (long - short)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def busy_share(step, to_state, shape, iters=100):
        """(device us, device launches, busy share) an iteration over a
        window of ``iters`` fixed sweeps under torch.profiler: the device's
        own events (kernels, copies) against the window's wall."""
        x = to_state(torch.rand(shape, device=dev, generator=dgen))
        x = fixed_sweeps(step, x, None, 4)  # warm-up
        sync()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fixed_sweeps(step, x, None, iters)
            sync()
            wall = time.perf_counter() - t0
        us, n_ev = device_time(prof)
        check(us > 0, "the profiler recorded no device time")
        return us / iters, n_ev / iters, us / 1e6 / wall

    dist_timing = {}
    for n, counts in ((128, {"serial": (60, 600), "pack": (60, 600),
                             "color": (20, 200), "overlap": (20, 200),
                             "jacobi": (20, 200)}),
                      (512, {"serial": (12, 72), "pack": (12, 72),
                             "color": (6, 36)})):
        p = Problem.poisson_cube(n, device=dev)
        cm = make_mesh((n, n, n), devices=[dev] * 8, div=(2, 2, 2))
        ser = get_fused_step("sor2sma", p.grid, OMEGA, b_is_zero=True)
        pk = dist_pack.make_dist_packed_step(p, cm, OMEGA)
        blocks = lambda a: dist_fused.to_block_state(cm, a)  # noqa: E731
        steps = (
            ("serial", ser, ser.pad),
            ("pack", pk, lambda a: dist_pack.to_packed_state(cm, a, pk.hs)),
            ("color", dist_fused.make_dist_fused_step(p, cm, "sor2sma", OMEGA,
                                                      b_is_zero=True), blocks),
            ("overlap", dist_fused.make_dist_fused_overlap_step(
                p, cm, OMEGA, b_is_zero=True), blocks),
            ("jacobi", dist_fused.make_dist_fused_step(p, cm, "jacobi", OMEGA_J,
                                                       b_is_zero=True), blocks))
        for label, step, to_state in steps:
            if label not in counts:
                continue
            ms = per_iter_ms_state(step, to_state, p.grid.shape_kij, *counts[label])
            check(ms > 0, f"dist timing {label} {n}^3: non-positive")
            dist_timing[(label, n)] = ms
            prof = ""
            if n == 128 and label not in ("serial", "pack"):
                d_us, d_n, share = busy_share(step, to_state, p.grid.shape_kij)
                prof = (f", device {d_us:.2f} us and {d_n:.2f} device launches "
                        f"an iteration, busy share {share:.3f}")
            print(f"timing dist {label} {n}^3 f32 (n={step.iters_per_call} per "
                  f"call{'' if label == 'serial' else ', (2, 2, 2) on the card'}"
                  f"): {ms * 1e3:.3f} us/iteration, "
                  f"{p.grid.num_inner / (ms * 1e-3) / 1e6:.1f} Mcell-updates/s"
                  f"{prof} {tag}", flush=True)
        del p, cm, ser, pk, steps

    # K7 and the ring refresh per call as the pack step makes them, one
    # launch over the eight extended blocks of 128^3 over (2, 2, 2); K8,
    # the face exchange and the fold per launch over all eight blocks;
    # each against its twin in turns
    bsz, gsz = (64, 64, 64), (128, 128, 128)
    mc = Problem.poisson_cube(128, device=dev, maf=True).mc
    k7m = k7.make_dist_packed_sweepnx(bsz, gsz, omega=OMEGA, n=2, mc=mc)
    tab7 = [k7m.block_tables(o, dev) for o in org8]
    hs6, hs2 = (12, 12, 12), k7m.hs
    e7, e7m = k7.ext_dims(bsz, hs6), k7.ext_dims(bsz, hs2)
    x7 = packed_ring_state(gsz, (2, 2, 2), hs6, f32, cm8)
    x7m = packed_ring_state(gsz, (2, 2, 2), hs2, f32, cm8)

    def k7call(n, hs, xs, tabs):
        """(kernel, twin) of the pack step's K7 launch over the blocks."""
        launch = k7.BlockRbSweeps(n, OMEGA, bsz, gsz, hs, org8)

        def twin():
            return [k7.dist_sweeps_plain(x, n, OMEGA, k7.geometry(bsz, gsz, hs, o), t)
                    for x, o, t in zip(xs, org8, tabs or [None] * 8)]
        return (lambda: launch(xs, tabs)), twin

    def ring_cells(hs):
        """Ring cells inside the grid over the eight blocks (the cells the
        refresh writes)."""
        cells = 0
        for o in org8:
            inside = 1
            for g, oo, h, l in zip(gsz, o, hs, bsz):
                inside *= min(oo + l + h, g) - max(oo - h, 0)
            cells += inside - bsz[0] * bsz[1] * bsz[2]
        return cells
    x8 = [rand(k8.block_layout(bsz), f32).to(dev) for _ in range(8)]
    o8 = [torch.empty_like(x) for x in x8]
    res8 = dist_halo.Residual(dev)

    def k8call(kind, colour, region, plain):
        # one launcher, as a step keeps it: its arguments built once
        launch = k8.BlockSweeps(kind, colour, OMEGA, org8, gsz, 0, region)

        def run():
            res8.start()
            launch(x8, None, o8 if kind == "jacobi" else None, res8, plain)
            return res8.total()
        return run

    parts8 = torch.rand(2 * 576, device=dev, generator=dgen)
    st8 = torch.empty(8 * dist_halo.staging_size(bsz), device=dev)
    dcalls = {
        "dist_rb_sweeps": k7call(6, hs6, x7, None),
        "dist_rb_sweeps_maf": k7call(2, hs2, x7m, tab7),
        "pack_exchange": ((lambda ex=k7.PackExchange((2, 2, 2), bsz, hs6): ex(x7)),
                          lambda: k7.exchange_packed_plain(x7, (2, 2, 2), bsz, hs6)),
        "halo_exchange": (lambda ex=dist_halo.Exchange(table8): ex(x8),
                          lambda: dist_halo.halo_exchange_plain(x8, table8)),
        "fold_partials": (lambda: dist_halo.fold_partials(parts8, parts8.numel()),
                          lambda: dist_halo.fold_partials_plain(parts8)),
    }
    library = {"fold_partials": lambda: parts8.sum(dtype=torch.float64)}
    for kind, colour, region in (("jacobi", None, "all"), ("sor2sma", 0, "all"),
                                 ("sor2sma", None, "all"),
                                 ("sor2sma", 0, "interior"),
                                 ("sor2sma", 0, "shell")):
        dcalls["block_sweep_" + k8.variant(kind, colour, region)] = (
            k8call(kind, colour, region, False), k8call(kind, colour, region, True))
    for name, (kfn, pfn) in dcalls.items():
        kfn(), pfn()
        sync()
        p1 = events_ms(pfn, 5)
        k1 = events_ms(kfn, 50)
        k2 = events_ms(kfn, 50)
        p2 = events_ms(pfn, 5)
        lib_ms = None
        if name in library:
            library[name]()
            lib_ms = events_ms(library[name], 50)
        per_call[name] = (min(k1, k2), min(p1, p2), lib_ms)
        what = "the eight 64^3 blocks of 128^3 (2, 2, 2) in one launch"
        print(f"per call on {what}, f32: {name} {per_call[name][0]:.4f} ms, plain "
              f"twin {per_call[name][1]:.4f} ms"
              + ("" if lib_ms is None else f", library {lib_ms:.4f} ms") + f" {tag}")
    check(all(bool(torch.isfinite(t).all()) for t in x7 + x7m + x8),
          "dist timing fields not finite")
    # their least work: K7 reads and writes the eight extended blocks once,
    # n iterations over their interiors; the ring refresh reads and writes
    # the ring cells inside the grid; K8 reads the eight ghosted blocks and
    # writes what it updates (the shell pass: the shell, the ghost planes
    # and the layer inside); the exchange reads and writes the 24 faces that
    # have a neighbour; the fold reads its partials
    gb = 8 * 4 * 66**3
    shell = 64**3 - 62**3
    work.update({
        "dist_rb_sweeps": (8 * 2 * 4 * e7[0] * e7[1] * e7[2],
                           8 * 6 * 11 * (e7[0] - 2) * (e7[1] - 2) * (e7[2] - 2)),
        "dist_rb_sweeps_maf": (8 * 2 * 4 * e7m[0] * e7m[1] * e7m[2],
                               8 * 2 * 20 * (e7m[0] - 2) * (e7m[1] - 2)
                               * (e7m[2] - 2)),
        "pack_exchange": (2 * 4 * ring_cells(hs6), 0),
        "block_sweep_jacobi": (2 * gb, 8 * 11 * 64**3),
        "block_sweep_colour": (1.5 * gb, 8 * 11 * 64**3 / 2),
        "block_sweep_both": (2 * gb, 8 * 11 * 64**3),
        "block_sweep_interior": (8 * (4 * 64**3 + 2 * 62**3), 8 * 11 * 62**3 / 2),
        "block_sweep_shell": (8 * (4 * (66**3 - 60**3) + 2 * shell),
                              8 * 11 * shell / 2),
        "halo_exchange": (2 * 4 * 24 * 64 * 64, 0),
        "fold_partials": (4 * parts8.numel() + 8, parts8.numel()),
    })

    # ---- 16. K9 and K10 against their twins -------------------------------------
    stamp(16)
    # (global shape, division, block coordinates, forms): the 64^3-owned
    # blocks of 128^3 over (2, 2, 2), K split, so 'pcr' only, and a
    # (128, 64, 64) block over (1, 2, 2), both forms; offset 1
    k9_cases = (((128, 128, 128), (2, 2, 2), ((0, 0, 0), (1, 1, 1)), ("pcr",)),
                ((128, 128, 128), (1, 2, 2), ((0, 1, 0),), ("pcr", "fastdiag")))
    n_cmp = 0
    for gsz, div, coords, forms in k9_cases:
        bsz = tuple(g // d for g, d in zip(gsz, div))
        for dtype in (f32, f64):
            tol = 0.0 if dtype == f32 else 1e-14
            mc = stretched_mc(gsz, dtype)
            for c in coords:
                origin = tuple(a * b for a, b in zip(c, bsz))
                x = rand(tuple(v + 2 for v in bsz), dtype).to(dev)
                b = rand(x.shape, dtype).to(dev)
                for form in forms:
                    for maf in (False, True):
                        for colour in (0, 1, None):
                            for bz in (True, False):
                                kw = dict(omega=OMEGA, color=colour, offset=1,
                                          b_is_zero=bz, maf=maf,
                                          mc=mc if maf else None, solver=form)
                                ks = k9.make_block_pcr(bsz, gsz, dtype, **kw)
                                ps = k9.make_block_pcr(bsz, gsz, dtype, plain=True,
                                                       **kw)
                                tab = ks.block_tables(origin, dev) if maf else None
                                xk, rk = ks(x.clone(), b, origin, tab)
                                xp, rp = ps(x.clone(), b, origin, tab)
                                sync()
                                name = k9.variant(form, maf)
                                e = float((xk - xp).abs().max())
                                err[name] = max(err.get(name, 0.0), e)
                                rel = float((rk - rp).abs() / rp.abs())
                                where = (f"K9 {form} maf={maf} colour={colour} "
                                         f"b={not bz} {div} {c} {dtype}")
                                check(torch.isfinite(xk).all(),
                                      f"non-finite field: {where}")
                                check(e <= tol, f"field differs by {e}: {where}")
                                check(rel <= 1e-5,
                                      f"residual differs by rtol {rel}: {where}")
                                n_cmp += 1
    # K9 over all the blocks of a mesh in one launch against the batched
    # twin: the 'pcr' form on the eight blocks of (2, 2, 2) at 128^3 and at
    # 512^3 (lines of 258 rows), both forms on the four of (1, 2, 2)
    for gn, div, form in ((128, (2, 2, 2), "pcr"), (128, (1, 2, 2), "pcr"),
                          (128, (1, 2, 2), "fastdiag"), (512, (2, 2, 2), "pcr")):
        gsz = (gn,) * 3
        cmk = make_mesh(gsz, devices=[dev] * (div[0] * div[1] * div[2]), div=div)
        bsz, orgs = cmk.block_shape(gsz), cmk.offsets(gsz)
        for dtype in (f32, f64):
            tol = 0.0 if dtype == f32 else 1e-14
            mc = stretched_mc(gsz, dtype)
            xs = [rand(tuple(v + 2 for v in bsz), dtype).to(dev) for _ in orgs]
            bbs = [rand(tuple(v + 2 for v in bsz), dtype).to(dev) for _ in orgs]
            for maf in (False, True):
                tabs = None
                if maf:
                    tabs = [k9.block_maf_tables(mc, o, bsz, gsz, dtype, form).to(dev)
                            for o in orgs]
                for colour in (0, 1, None):
                    for bb in (None, bbs):
                        res = dist_halo.Residual(dev)
                        res.start()
                        got = k9.pcr_blocks([x.clone() for x in xs], bb, form, colour,
                                            OMEGA, orgs, gsz, 1, tabs, res=res)
                        r_k = res.total()
                        want, r_p = k9.pcr_blocks_plain(
                            [x.clone() for x in xs], bb, form, colour, OMEGA, orgs,
                            gsz, 1, tabs)
                        sync()
                        name = k9.variant(form, maf)
                        e = max(float((g - w).abs().max()) for g, w in zip(got, want))
                        err[name] = max(err.get(name, 0.0), e)
                        rel = float((r_k - sum(r_p)).abs() / sum(r_p))
                        where = (f"K9 {len(orgs)} blocks of {gn}^3 {form} "
                                 f"maf={maf} colour={colour} b={bb is not None} "
                                 f"{dtype}")
                        check(all(bool(torch.isfinite(g).all()) for g in got),
                              f"non-finite field: {where}")
                        check(e <= tol, f"field differs by {e}: {where}")
                        check(rel <= 1e-5, f"residual differs by rtol {rel}: {where}")
                        n_cmp += 1
                print(f"K9 {form} maf={maf} {len(orgs)} blocks of {gn}^3 {dtype}: "
                      f"{k9.plan(form, bsz, dtype, maf, 0)} (colours), "
                      f"{k9.plan(form, bsz, dtype, maf, None)} (line-Jacobi)",
                      flush=True)
        del cmk, xs, bbs, got, want
    # K10: its line form at 128^3 and 512^3 (every variant at 128^3; at
    # 512^3 colour 1 and the line-Jacobi pass), and the tile form its plan
    # keeps for lines past 512 rows, on a (600, 14, 40) field
    k10_cases = (((128, 128, 128), (0, 1, None), "lines"),
                 ((512, 512, 512), (1, None), None),
                 ((600, 14, 40), (0, 1, None), "tile"))
    for (sh, colours, form), dtype in [(c, d) for c in k10_cases for d in (f32, f64)]:
        tol = 0.0 if dtype == f32 else 1e-14
        mc = stretched_mc(sh, dtype)
        x, b = rand(sh, dtype).to(dev), rand(sh, dtype).to(dev)
        for maf in (False, True):
            tab = rb.maf_tables(mc, sh, dtype) if maf else None
            for colour in colours:
                plan = k10.line_plan(sh[0] - 2, dtype, maf, colour is None)
                check(form in (None, plan.form), f"K10 plan at {sh}: {plan}")
                for bb in (None, b) if sh[0] < 512 else (None,):
                    xk, rk = k10.fused_pcr(x.clone(), bb, OMEGA, colour, 1, tab)
                    xp, rp = k10.fused_pcr_plain(x.clone(), bb, OMEGA, colour, 1,
                                                 tab)
                    sync()
                    name = "fused_pcr" + ("_maf" if maf else "")
                    e = float((xk - xp).abs().max())
                    err[name] = max(err.get(name, 0.0), e)
                    rel = float((rk - rp).abs() / rp.abs())
                    where = (f"K10 {plan.form} {sh} maf={maf} colour={colour} "
                             f"b={bb is not None} {dtype}")
                    check(torch.isfinite(xk).all(), f"non-finite field: {where}")
                    check(e <= tol, f"field differs by {e}: {where}")
                    check(rel <= 1e-5, f"residual differs by rtol {rel}: {where}")
                    n_cmp += 1
                    del xk, xp
        del x, b, mc
    print(f"K9 and K10 vs plain twins: {n_cmp} comparisons passed (f32 bitwise, "
          f"f64 <= 1e-14); max |field diff| "
          + ", ".join(f"{k} {v:.3e}" for k, v in sorted(err.items())
                      if k.startswith(("block_pcr", "fused_pcr"))), flush=True)

    # ---- 17. the dist line path at full width ----------------------------------
    stamp(17)
    # (omega, the serial port's 128^3 count: the f32 oracle's 1356, 1355,
    # 4230 within the +-2% of phase 9).  Block-local K-lines (K split)
    # change the trajectory: those solves are held to the JAX package's
    # counts and Error max on its jnp dist steps over (2, 2, 2), at 128^3
    # and 64^3 (python3 tools/jax_dist_counts.py 128, ... 64; the host's
    # CPU).  K-unsplit meshes solve whole lines: the serial count and
    # Error max.
    lines_128 = {"pcr_rb": (OMEGA, 1356), "pcr_rb_maf": (OMEGA, 1356),
                 "pcr_j_esa": (OMEGA_L, 4232)}
    jax_dist_128 = {"pcr_rb": (1379, 1.054138e-02),
                    "pcr_rb_maf": (1379, 1.058282e-02),
                    "pcr_j_esa": (4236, 6.126559e-02)}
    jax_dist_64 = {"pcr_rb": 479, "pcr_rb_maf": 479, "pcr_j_esa": 1814}

    def no_kernel(counts):
        return not any(counts.values())

    for div in ((1, 2, 2), (2, 2, 2)):
        nb = div[0] * div[1] * div[2]
        cm = make_mesh((128, 128, 128), devices=[dev] * nb, div=div)
        form = "fastdiag" if div[0] == 1 else "pcr"
        for name, (omega, serial) in lines_128.items():
            maf = name.endswith("_maf")
            p = Problem.poisson_cube(128, device=dev, maf=maf)
            r, wall, cnt = drive_dist(name, omega, p, cm, "auto",
                                      (k9.variant(form, maf),))
            ek, lk = max_error_loc(p.grid, r.x)
            s_ = solve(p, name, omega=omega, itr_max=10000)
            es, _ = max_error_loc(p.grid, s_.x)
            its, err_ref, ref = serial, es, "serial"
            if form == "pcr":
                (its, err_ref), ref = jax_dist_128[name], "JAX jnp dist"
            check(abs(r.iters - its) <= its * 2 // 100,
                  f"dist {name} {div}: {r.iters} vs {ref} {its}")
            check(abs(ek / err_ref - 1) <= ERR_RTOL,
                  f"dist {name} {div}: Error max {ek} vs {ref} {err_ref}")
            also = "" if ref == "serial" else f"; serial {s_.iters}"
            also_e = "" if ref == "serial" else f"; serial {es:e}"
            print(f"solve_dist {name} 128^3 f32 omega {omega} {div} ({nb} blocks "
                  f"on the card, K9 '{form}'): {r.iters} iterations ({ref} "
                  f"{its}{also}), res {r.res:e}, Error max {ek:e} at {lk} ({ref} "
                  f"{err_ref:e}{also_e}), wall {wall:.3f} s, launches {cnt} "
                  f"{tag}", flush=True)
            del p, r, s_
        del cm
    cm64 = make_mesh((64, 64, 64), devices=[dev] * 8, div=(2, 2, 2))
    for name, (omega, _) in lines_128.items():
        maf = name.endswith("_maf")
        p = Problem.poisson_cube(64, device=dev, maf=maf)
        r, wall, cnt = drive_dist(name, omega, p, cm64, "auto",
                                  (k9.variant("pcr", maf),))
        want = jax_dist_64[name]
        check(abs(r.iters - want) <= want * 2 // 100,
              f"dist {name} 64^3 (2, 2, 2): {r.iters} vs the JAX dist {want}")
        print(f"solve_dist {name} 64^3 f32 (2, 2, 2): {r.iters} iterations (JAX "
              f"jnp dist step {want}), wall {wall:.3f} s {tag}", flush=True)
    # float64 and the MAF point sweeps run parallel/dist.py: plain torch on
    # the card, no kernel of the port
    p = Problem.poisson_cube(64, dtype=f64, device=dev)
    r, wall, cnt = drive_dist("pcr_rb", OMEGA, p, cm64, "auto", ())
    check(no_kernel(read_counts()), "f64 dist pcr_rb launched a kernel")
    check(r.res < 1e-5, f"f64 dist pcr_rb: res {r.res}")
    print(f"solve_dist pcr_rb 64^3 f64 (2, 2, 2) on parallel/dist.py: {r.iters} "
          f"iterations, res {r.res:e}, wall {wall:.3f} s {tag}", flush=True)
    for name, omega, serial, sync_mode in (("jacobi_maf", OMEGA_J, 5380, "auto"),
                                           ("sor2sma_maf", OMEGA, 1813, "color")):
        p = Problem.poisson_cube(128, device=dev, maf=True)
        r, wall, cnt = drive_dist(name, omega, p, cm128, sync_mode, ())
        check(no_kernel(read_counts()), f"dist {name} launched a kernel")
        check(abs(r.iters - serial) <= serial * 2 // 100,
              f"dist {name} 128^3: {r.iters} vs serial {serial}")
        print(f"solve_dist {name} 128^3 f32 sync={sync_mode} (2, 2, 2) on "
              f"parallel/dist.py: {r.iters} iterations (serial {serial}), wall "
              f"{wall:.3f} s {tag}", flush=True)
    del p, r, cm64
    # K10's path: its own entry point (no solver dispatch takes it, as in
    # the JAX package), 60 fixed sweeps at 128^3 against 60 of K5/K6
    for maf in (False, True):
        p = Problem.poisson_cube(128, device=dev, maf=maf)
        for kind, omega in (("pcr_rb", OMEGA), ("pcr", OMEGA_L)):
            step = k10.make_fused_pcr_step(kind, p.grid.shape_kij, f32, omega=omega,
                                           b_is_zero=True, mc=p.mc)
            sync()
            zero_counts()
            xf = step.unpad(fixed_sweeps(step, step.pad(p.x0), None, 60))
            sync()
            v = "fused_pcr" + ("_maf" if maf else "")
            got = read_counts()[v]
            # the line form: one launch a sweep, both colours of pcr_rb in it
            check(got == 60, f"K10 {kind} maf={maf}: {got} launches")
            path_launches[v] = path_launches.get(v, 0) + got
            ref = get_fused_step(kind, p.grid, omega, mc=p.mc, b_is_zero=True)
            xr = ref.unpad(fixed_sweeps(ref, ref.pad(p.x0), None, 60))
            e = float((xf - xr).abs().max())
            check(bool(torch.isfinite(xf).all()) and e <= 1e-4,
                  f"K10 {kind} maf={maf}: |x - K5/K6| {e}")
            print(f"K10 make_fused_pcr_step('{kind}') 128^3 f32 maf={maf}: 60 "
                  f"sweeps in {got} launches, max |x - the K5/K6 sweeps| {e:.3e} "
                  f"{tag}", flush=True)
        del p, step, xf, ref, xr

    # ---- 18. timing of the dist line path ---------------------------------------
    stamp(18)
    line_timing = {}
    for n, divs, counts in ((128, ((2, 2, 2), (1, 2, 2)), (20, 200)),
                            (512, ((2, 2, 2),), (4, 24))):
        for div in divs:
            cm = make_mesh((n, n, n), devices=[dev] * (div[0] * div[1] * div[2]),
                           div=div)
            for name, (omega, _) in lines_128.items():
                kind = "pcr" if name == "pcr_j_esa" else "pcr_rb"
                p = Problem.poisson_cube(n, device=dev, maf=name.endswith("_maf"))
                step = dist_fused.make_dist_fused_step(p, cm, kind, omega,
                                                       b_is_zero=True)
                ms = per_iter_ms_state(
                    step, lambda a: dist_fused.to_block_state(cm, a),
                    p.grid.shape_kij, *counts)
                check(ms > 0, f"dist timing {name} {n}^3 {div}: non-positive")
                line_timing[(name, n, div)] = ms
                prof = ""
                if n == 128:
                    d_us, d_n, share = busy_share(
                        step, lambda a: dist_fused.to_block_state(cm, a),
                        p.grid.shape_kij)
                    prof = (f", device {d_us:.2f} us and {d_n:.2f} device "
                            f"launches an iteration, busy share {share:.3f}")
                print(f"timing dist {name} {n}^3 f32 {div} (K9 '{step.solver}', "
                      f"{div[0] * div[1] * div[2]} blocks on the card): "
                      f"{ms * 1e3:.3f} us/iteration, "
                      f"{p.grid.num_inner / (ms * 1e-3) / 1e6:.1f} "
                      f"Mcell-updates/s{prof} {tag}", flush=True)
                del p, step
            del cm

    # K9 per launch over all the blocks of the path's meshes (the eight 64^3
    # blocks of 128^3 over (2, 2, 2), the four (128, 64, 64) blocks over
    # (1, 2, 2)) and K10 at 128^3, colour 0, each against its twin
    mc = Problem.poisson_cube(128, device=dev, maf=True).mc
    k9calls = {}
    res9 = dist_halo.Residual(dev)
    for form, div in (("pcr", (2, 2, 2)), ("fastdiag", (1, 2, 2))):
        gsz = (128, 128, 128)
        cmk = make_mesh(gsz, devices=[dev] * (div[0] * div[1] * div[2]), div=div)
        bsz, orgs = cmk.block_shape(gsz), cmk.offsets(gsz)
        xb = [rand(tuple(v + 2 for v in bsz), f32).to(dev) for _ in orgs]
        for maf in (False, True):
            tabs = None
            if maf:
                tabs = [k9.block_maf_tables(mc, o, bsz, gsz, f32, form).to(dev)
                        for o in orgs]

            def call(plain, xb=xb, tabs=tabs, orgs=orgs, form=form, gsz=gsz):
                # one launcher, as a step keeps it: its arguments built once
                launch = k9.BlockPcr(form, 0, OMEGA, orgs, gsz, 0, tabs)

                def run():
                    res9.start()
                    launch(xb, None, None, res9, plain)
                    return res9.total()
                return run

            k9calls[k9.variant(form, maf)] = (call(False), call(True))
    sh = (128, 128, 128)
    x10 = rand(sh, f32).to(dev)
    tab10 = rb.maf_tables(mc, sh, f32)

    def k10_calls(x, tab):
        """(kernel, twin) calls of a colour-0 pass through its launcher,
        built once as a step keeps it."""
        launch = k10.PcrLines((0,), OMEGA, 0, tab)
        return (lambda: launch(x, None, x),
                lambda: k10.fused_pcr_plain(x, None, OMEGA, 0, tab=tab)[1])
    k9calls["fused_pcr"] = k10_calls(x10, None)
    k9calls["fused_pcr_maf"] = k10_calls(x10, tab10)
    for name, (kfn, pfn) in k9calls.items():
        kfn(), pfn()
        sync()
        p1 = events_ms(pfn, 3)
        k1 = events_ms(kfn, 50)
        k2 = events_ms(kfn, 50)
        p2 = events_ms(pfn, 3)
        per_call[name] = (min(k1, k2), min(p1, p2))
        print(f"per call, f32 colour 0 ({'128^3' if name.startswith('fused') else 'all the blocks of the path mesh, one launch'}): "
              f"{name} {per_call[name][0]:.4f} ms, plain twin "
              f"{per_call[name][1]:.4f} ms {tag}")
    check(bool(torch.isfinite(x10).all()), "K10 timing field not finite")
    # K10's step (pcr_rb: both colours, one launch) at 128^3, and its
    # colour pass at 512^3, kernel against twin in turns
    k10_extra = {}
    for maf in (False, True):
        t_ = tab10 if maf else None
        step = k10.make_fused_pcr_step("pcr_rb", sh, f32, omega=OMEGA,
                                       b_is_zero=True,
                                       mc=mc if maf else None)
        k10_extra["fused_pcr" + ("_maf" if maf else "")] = {
            "step_ms": events_ms(lambda: step(x10, None), 50)}
    x5 = rand((512,) * 3, f32).to(dev)
    mc5 = Problem.poisson_cube(512, device=dev, maf=True).mc
    tab5 = rb.maf_tables(mc5, (512,) * 3, f32)
    for name, t_ in (("fused_pcr", None), ("fused_pcr_maf", tab5)):
        kfn, pfn = k10_calls(x5, t_)
        kfn(), pfn()
        sync()
        p1 = events_ms(pfn, 1)
        k1 = events_ms(kfn, 10)
        k2 = events_ms(kfn, 10)
        p2 = events_ms(pfn, 1)
        per_call_512[name] = (min(k1, k2), min(p1, p2))
        print(f"per call at 512^3 f32 colour 0: {name} {per_call_512[name][0]:.4f} "
              f"ms, plain twin {per_call_512[name][1]:.4f} ms; pcr_rb step at "
              f"128^3 {k10_extra[name]['step_ms']:.4f} ms {tag}", flush=True)
    check(bool(torch.isfinite(x5).all()), "K10 512^3 timing field not finite")
    del x5, tab5
    # K9 'pcr' per launch over the eight 256^3 blocks of 512^3 (lines of 258
    # rows), colour 0, kernel against twin in turns
    cm5 = make_mesh((512,) * 3, devices=[dev] * 8, div=(2, 2, 2))
    bsz5, orgs5 = cm5.block_shape((512,) * 3), cm5.offsets((512,) * 3)
    xb5 = [rand(tuple(v + 2 for v in bsz5), f32).to(dev) for _ in orgs5]
    for maf in (False, True):
        tabs5 = None
        if maf:
            tabs5 = [k9.block_maf_tables(mc5, o, bsz5, (512,) * 3, f32, "pcr").to(dev)
                     for o in orgs5]
        launch = k9.BlockPcr("pcr", 0, OMEGA, orgs5, (512,) * 3, 0, tabs5)

        def run(plain, launch=launch):
            res9.start()
            launch(xb5, None, None, res9, plain)
            return res9.total()
        name = k9.variant("pcr", maf)
        run(False), run(True)
        sync()
        p1 = events_ms(lambda: run(True), 1)
        k1 = events_ms(lambda: run(False), 10)
        k2 = events_ms(lambda: run(False), 10)
        p2 = events_ms(lambda: run(True), 1)
        per_call_512[name] = (min(k1, k2), min(p1, p2))
        print(f"per call at 512^3 f32 colour 0 (the eight blocks of (2, 2, 2), one "
              f"launch): {name} {per_call_512[name][0]:.4f} ms, plain twin "
              f"{per_call_512[name][1]:.4f} ms {tag}", flush=True)
    check(all(bool(torch.isfinite(x).all()) for x in xb5),
          "K9 512^3 timing blocks not finite")
    del xb5, cm5, mc5, tabs5
    # their least work, colour 0 (half the lines) with b zero, over the rows
    # a pass updates (every inner point of 128^3 sits in one block's line,
    # so half of 126^3 rows on either mesh):
    # bytes, the blocks read once and the updated cells written once;
    # operations, those of the CUDA bodies per updated row: the system (4
    # constant, 15 MAF), each PCR stage (16 variable, pcr.cuh's
    # pcr_solve_var: K9 MAF; 5 on tables, pcr_solve_tab: K9 constant on its
    # wall pattern's, K10), the final pair (6 variable, 3 tables) and the
    # relaxation with its dp^2 (5); K10's end folds add 4 a line; a Thomas
    # line relaxation 14 (24 under MAF) a row, as K5/K6
    pn9, pn10 = num_stage(64 + 2), num_stage(126)
    blk, rows9 = 8 * 66**3, 126**3 / 2
    fd_blk, fd_rows = 4 * 130 * 66 * 66, 126**3 / 2
    lines10 = 126 * 126 / 2
    var9, tab9 = 16 * (pn9 - 1) + 6 + 5, 5 * (pn9 - 1) + 3 + 5
    var10, tab10_ops = 16 * (pn10 - 1) + 6 + 5, 5 * (pn10 - 1) + 3 + 5
    work.update({
        "block_pcr": (4 * (blk + rows9), (4 + tab9) * rows9),
        "block_pcr_maf": (4 * (blk + rows9), (15 + var9) * rows9),
        "block_pcr_fastdiag": (4 * (fd_blk + fd_rows), 14 * fd_rows),
        "block_pcr_fastdiag_maf": (4 * (fd_blk + fd_rows), 24 * fd_rows),
        "fused_pcr": (4 * (128**3 + inner / 2),
                      (4 + tab10_ops) * inner / 2 + 4 * lines10),
        "fused_pcr_maf": (4 * (128**3 + inner / 2),
                          (15 + var10) * inner / 2 + 4 * lines10),
    })
    pn5, pn95 = num_stage(510), num_stage(256 + 2)
    var5, tab5_ops = 16 * (pn5 - 1) + 6 + 5, 5 * (pn5 - 1) + 3 + 5
    blk5, rows95 = 8 * 258**3, inner5 / 2
    work512.update({
        "block_pcr": (4 * (blk5 + rows95), (4 + 5 * (pn95 - 1) + 3 + 5) * rows95),
        "block_pcr_maf": (4 * (blk5 + rows95), (15 + 16 * (pn95 - 1) + 6 + 5) * rows95),
        "fused_pcr": (4 * (512**3 + inner5 / 2),
                      (4 + tab5_ops) * inner5 / 2 + 4 * 510 * 510 / 2),
        "fused_pcr_maf": (4 * (512**3 + inner5 / 2),
                          (15 + var5) * inner5 / 2 + 4 * 510 * 510 / 2),
    })

    # ---- 19. the Krylov solvers (slice 4) -----------------------------------
    stamp(19)
    # a solve with the launch counts zeroed just before and read just after;
    # K2's constant pair with a streamed b is rb_sweeps_n's (rows, const, b)
    # ``vector``, if given, is the impl of the vector maps and dots
    # (cuda_kernels/blas.py's ``vector_impl``): a solve under 'plain' with
    # ``vector='auto'`` runs its preconditioner and operator on their twins
    # and its vector work on csrc/blas.cu's passes, as 'auto' does; the
    # passes' dots sum in their own order, so only so is a plain solve the
    # kernels' bit for bit
    def krylov(p, solver, precond, omega=1.1, impl="auto", eps=1e-5,
               itr_max=4000, vector=None):
        zero_counts()
        t0 = time.perf_counter()
        with (kax.vector_impl(vector) if vector else contextlib.nullcontext()):
            r = solve(p, solver, omega=omega, itr_max=itr_max, eps=eps,
                      precond=precond, impl=impl)
        sync()
        wall = time.perf_counter() - t0
        c = read_counts()
        c["rb_sweeps_n_b"] = rb.rb_sweeps_n.variant_launches.get(
            ("rows", False, True), 0)
        return r, c, wall

    def err_max(p, x):
        return max_error_loc(p.grid, x)[0]

    def curve_rtol(hist, ref):
        """The largest relative gap of a history to the oracle's before its
        last KRYLOV_TAIL entries, and in them."""
        m = min(len(hist), len(ref))
        rel = [abs(a / b_ - 1) for a, b_ in zip(hist[:m].tolist(), ref)]
        return (max(rel[:m - KRYLOV_TAIL], default=0.0),
                max(rel[m - KRYLOV_TAIL:], default=0.0))

    krylov_launches = {}
    for dtype, n_ref in ((f64, "f64"), (f32, "f32")):
        p = Problem.poisson_cube(256, dtype=dtype, device=dev)
        ref = load_history(f"{n_ref}_pbicgstab_sor2sma_256_w1.1.txt")
        r, c, wall = krylov(p, "pbicgstab", "sor2sma")
        if dtype == f64:
            check(abs(r.iters - len(ref)) <= 1,
                  f"pbicgstab 256^3 f64: {r.iters} iterations, oracle {len(ref)}")
            head, tail = curve_rtol(r.history, ref)
            check(head <= 1e-4, f"pbicgstab 256^3 f64 history rtol {head}")
            e64 = err_max(p, r.x)
        else:
            # the f32 oracle gives 42, the JAX package 44: f32 trajectory
            # noise near eps (BENCH_RESULTS.md)
            check(41 <= r.iters <= 45 and r.res < 1e-5,
                  f"pbicgstab 256^3 f32: {r.iters} iterations, res {r.res}")
            head, tail = curve_rtol(r.history, ref)
            e32 = err_max(p, r.x)
            check(e32 < KRYLOV_ERR_256,
                  f"pbicgstab 256^3 f32 Error max {e32} (f64 {e64})")
        # two applications an iteration, four pair calls (8 sweeps) each
        check(c["rb_sweeps_n_b"] == 8 * r.iters,
              f"pbicgstab 256^3 {n_ref}: {c['rb_sweeps_n_b']} K2 launches for "
              f"{r.iters} iterations")
        if dtype == f32:
            path_launches["rb_sweeps_n_b"] = c["rb_sweeps_n_b"]
        # the operator pass: A x twice an iteration, b - A x once for the
        # start's residual
        check(c["ax_kernel"] == 2 * r.iters + 1,
              f"pbicgstab 256^3 {n_ref}: {c['ax_kernel']} operator passes for "
              f"{r.iters} iterations")
        if dtype == f64:
            path_launches["ax_kernel"] = c["ax_kernel"]
        # the vector passes: bicg_1 (from the second iteration), dot2,
        # triad, dots_t and update_xr an iteration, the start's dot2
        check(c["vector_pass"] == 5 * r.iters,
              f"pbicgstab 256^3 {n_ref}: {c['vector_pass']} vector passes for "
              f"{r.iters} iterations")
        want_ops = {"bicg_1": r.iters - 1, "dot2": r.iters + 1,
                    "triad": r.iters, "dots_t": r.iters, "update_xr": r.iters}
        check(all(c[f"vec_kernel.{op}"] == n for op, n in want_ops.items()),
              f"pbicgstab 256^3 {n_ref}: vector passes "
              f"{ {op: c['vec_kernel.' + op] for op in want_ops} } for "
              f"{r.iters} iterations")
        if dtype == f64:
            for op in want_ops:
                path_launches[f"vec_kernel.{op}"] = c[f"vec_kernel.{op}"]
        # float32: the plain solve's vector work on the same passes, to hold
        # K2's pair bit for bit; float64: all of it on the twins, the
        # vector passes' dots summing in their own order
        rp, cp, wall_p = krylov(p, "pbicgstab", "sor2sma", impl="plain",
                                vector="auto" if dtype == f32 else None)
        check(cp["rb_sweeps_n"] == 0, "the plain Krylov solve launched K2")
        check(cp["ax_kernel"] == 0,
              f"the plain Krylov solve launched {cp['ax_kernel']} operator passes")
        check(cp["vector_pass"] == (c["vector_pass"] if dtype == f32 else 0),
              f"the plain Krylov solve {n_ref} launched {cp['vector_pass']} "
              "vector passes")
        check(rp.iters == r.iters, f"pbicgstab 256^3 {n_ref}: plain {rp.iters} "
              f"iterations, kernels {r.iters}")
        if dtype == f32:
            check(torch.equal(rp.x, r.x) and torch.equal(rp.history, r.history),
                  "pbicgstab 256^3 f32: field or history differs from the plain "
                  "solve's")
        else:
            head_p, tail_p = curve_rtol(rp.history, r.history.tolist())
            print(f"pbicgstab 256^3 f64: the plain solve's history within "
                  f"{head_p:.2e} before its last {KRYLOV_TAIL} entries, "
                  f"{tail_p:.2e} in them", flush=True)
            # the f64 twin has no fma (an ulp from the kernel a sweep), and
            # its dots are torch's sums; the iterations amplify both as they
            # do the oracle's gap
            check(head_p <= 1e-4,
                  f"pbicgstab 256^3 f64: plain history rtol {head_p}")
        print(f"pbicgstab sor2sma 256^3 {n_ref}: {r.iters} iterations (oracle "
              f"{len(ref)}), history rtol {head:.2e} before its last "
              f"{KRYLOV_TAIL} entries, {tail:.2e} in them, res {r.res:e}, "
              f"Error max {err_max(p, r.x):e}, wall "
              f"{wall:.3f} s, K2 pair-with-b launches {c['rb_sweeps_n_b']}, "
              f"operator passes {c['ax_kernel']}; plain twins {rp.iters} "
              f"iterations in {wall_p:.3f} s {tag}",
              flush=True)
        del p, r, rp

    # 128^3 f32: the oracle's sor2sma and sor2sma_maf curves, then each
    # kernel preconditioner against its plain-twin solve, bit for bit
    p = Problem.poisson_cube(128, device=dev)
    ref = load_history("f32_pbicgstab_sor2sma_128_w1.1.txt")
    r, c, wall = krylov(p, "pbicgstab", "sor2sma")
    check(abs(r.iters - len(ref)) <= 1,
          f"pbicgstab 128^3 f32: {r.iters} iterations, oracle {len(ref)}")
    head, tail = curve_rtol(r.history, ref)
    check(head <= 3e-3, f"pbicgstab 128^3 f32 history rtol {head}")
    check(c["rb_sweeps_n_b"] == 8 * r.iters, "pbicgstab 128^3: K2 launches")
    check(c["ax_kernel"] == 2 * r.iters + 1, "pbicgstab 128^3: operator passes")
    e128, it128 = err_max(p, r.x), r.iters
    print(f"pbicgstab sor2sma 128^3 f32: {r.iters} iterations (oracle "
          f"{len(ref)}), history rtol {head:.2e} before its last {KRYLOV_TAIL} "
          f"entries, {tail:.2e} in them, Error max {e128:e}, wall "
          f"{wall:.3f} s, K2 launches {c['rb_sweeps_n_b']} {tag}", flush=True)
    pm = Problem.poisson_cube(128, device=dev, maf=True)
    ref = load_history("f32_pbicgstab_maf_sor2sma_maf_128_w1.1.txt")
    r, c, wall = krylov(pm, "pbicgstab_maf", "sor2sma_maf")
    check(abs(r.iters - len(ref)) <= 1,
          f"pbicgstab_maf 128^3 f32: {r.iters} iterations, oracle {len(ref)}")
    check(c["rb_sweeps_n_maf"] == 8 * r.iters,
          f"pbicgstab_maf 128^3: {c['rb_sweeps_n_maf']} K2-MAF launches")
    krylov_launches["rb_sweeps_n_maf"] = c["rb_sweeps_n_maf"]
    # the MAF operator stays ops/maf.py's
    check(c["ax_kernel"] == 0, "pbicgstab_maf 128^3: operator passes")
    print(f"pbicgstab_maf sor2sma_maf 128^3 f32: {r.iters} iterations (oracle "
          f"{len(ref)}), wall {wall:.3f} s, K2-MAF pair-with-b launches "
          f"{c['rb_sweeps_n_maf']} {tag}", flush=True)
    del pm
    # (solver, preconditioner, omega, its kernel's counter, launches an
    # application of 8 sweeps: K4 JACOBI_N iterations a launch, K5 a launch
    # a colour, K6 a launch a sweep)
    for solver, precond, omega, variant, per_apply in (
            ("pbicgstab", "jacobi", OMEGA_J, "k4_jacobi", 8 // k4.JACOBI_N),
            ("pbicgstab", "pcr_rb", 1.1, "rbl", 16),
            ("pbicgstab", "pcr_j_esa", OMEGA_L, "line_j", 8),
            ("cg", "jacobi", OMEGA_J, "k4_jacobi", 8 // k4.JACOBI_N)):
        r, c, wall = krylov(p, solver, precond, omega=omega)
        rp, cp, wall_p = krylov(p, solver, precond, omega=omega, impl="plain",
                                vector="auto")
        applies = r.iters + 1 if solver == "cg" else 2 * r.iters
        label = f"{solver} {precond} 128^3 f32"
        check(r.res < 1e-5, f"{label}: res {r.res}")
        check(c[variant] == per_apply * applies and cp[variant] == 0,
              f"{label}: {c[variant]} {variant} launches, plain {cp[variant]}")
        # the operator: b - A x once, A x once (cg) or twice an iteration
        check(c["ax_kernel"] == (r.iters if solver == "cg" else 2 * r.iters) + 1
              and cp["ax_kernel"] == 0,
              f"{label}: {c['ax_kernel']} operator passes, plain "
              f"{cp['ax_kernel']}")
        check(rp.iters == r.iters and torch.equal(rp.x, r.x)
              and torch.equal(rp.history, r.history),
              f"{label}: kernels {r.iters} iterations, plain {rp.iters}, or "
              "their fields differ")
        krylov_launches.setdefault(variant, c[variant])
        print(f"{label}: {r.iters} iterations, wall {wall:.3f} s (plain twins "
              f"{wall_p:.3f} s), {variant} launches {c[variant]}, the plain "
              f"solve's field bit for bit {tag}", flush=True)

    # 64^3 without a preconditioner: the curve is chaotic near its stop (the
    # JAX package's f64 jnp solve stops at 46 against the oracle's 44; f32
    # 55 against 56), so the count is held within 2
    for dtype, n_ref in ((f64, "f64"), (f32, "f32")):
        ref = load_history(f"{n_ref}_pbicgstab_none_64_w1.1.txt")
        r, c, _ = krylov(Problem.poisson_cube(64, dtype=dtype, device=dev),
                         "pbicgstab", "none")
        check(abs(r.iters - len(ref)) <= 2 and r.res < 1e-5,
              f"pbicgstab none 64^3 {n_ref}: {r.iters} iterations, oracle "
              f"{len(ref)}")
        check(c["ax_kernel"] == 2 * r.iters + 1,
              f"pbicgstab none 64^3 {n_ref}: {c['ax_kernel']} operator passes")
        print(f"pbicgstab none 64^3 {n_ref}: {r.iters} iterations (oracle "
              f"{len(ref)})", flush=True)

    # the stretched grid's "krylov" sign (L x = b), float64, on the kernels:
    # sor2sma_maf's sweeps solve -L x = b and the sign is not flipped
    errs, its = {}, {}
    for n in (24, 48):
        ps, u = Problem.manufactured_stretched(n, dtype=f64, family="krylov",
                                               device=dev)
        r, c, _ = krylov(ps, "pbicgstab_maf", "sor2sma_maf", eps=1e-9,
                         itr_max=40000)
        check(c["rb_sweeps_n_maf"] == 8 * r.iters and r.res < 1e-8,
              f"stretched pbicgstab_maf {n}: res {r.res}, K2-MAF launches "
              f"{c['rb_sweeps_n_maf']}")
        errs[n] = float(((r.x - u).abs() * ps.msk).max())
        its[n] = r.iters
    ratio = errs[24] / errs[48]
    check(3.4 < ratio < 5.0, f"stretched pbicgstab_maf: h^2 ratio {ratio}")
    print(f"stretched f64 pbicgstab_maf: err 24^3 {errs[24]:.4e} ({its[24]} it), "
          f"48^3 {errs[48]:.4e} ({its[48]} it), ratio {ratio:.3f}", flush=True)

    # the reference's example run through the CLI
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, "-m", "cubez_tpu_torch.cli", "64", "64", "64",
             "pbicgstab", "4000", "1.1", "sor2sma"], cwd=tmp, env=env,
            capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0, f"CLI pbicgstab exited {proc.returncode}:\n"
              f"{proc.stderr}")
        check("Iterative Method = pbicgstab\nPreconditioner = sor2sma\n"
              in proc.stdout, "CLI pbicgstab: no 'Preconditioner = sor2sma'")
        rows = (Path(tmp) / "pbicgstab.txt").read_text().splitlines()[1:]
        ref = load_history("f32_pbicgstab_sor2sma_64_w1.1.txt")
        check(abs(len(rows) - len(ref)) <= 1,
              f"CLI pbicgstab 64^3: {len(rows)} iterations, oracle {len(ref)}")
        for ln in proc.stdout.splitlines():
            if ln.startswith(("Iter =", "wall =", "Error max", "Precond")):
                print(f"CLI 64^3 pbicgstab sor2sma: {ln.strip()}")

    # solve_dist over (2, 2, 2), eight blocks on the card: the
    # preconditioner on K8 ('color', with b)
    cm = make_mesh((128, 128, 128), devices=[dev] * 8, div=(2, 2, 2))
    zero_counts()
    t0 = time.perf_counter()
    rd = solve_dist(p, cm, "pbicgstab", omega=1.1, itr_max=4000,
                    precond="sor2sma")
    sync()
    wall = time.perf_counter() - t0
    cd = read_counts()
    ed = err_max(p, rd.x)
    check(cd["block_sweep_colour"] == 2 * 8 * 2 * rd.iters,
          f"dist pbicgstab: {cd['block_sweep_colour']} K8 colour launches for "
          f"{rd.iters} iterations")
    # the blocks' operator stays BlockOps' padded twin
    check(cd["ax_kernel"] == 0, f"dist pbicgstab: {cd['ax_kernel']} operator passes")
    check(abs(rd.iters - it128) <= 1,
          f"dist pbicgstab 128^3: {rd.iters} iterations, serial {it128}")
    krylov_launches["block_sweep_colour"] = cd["block_sweep_colour"]
    print(f"solve_dist pbicgstab sor2sma 128^3 f32 over (2, 2, 2): {rd.iters} "
          f"iterations, Error max {ed:e} (serial {e128:e}), wall {wall:.3f} s, "
          f"K8 colour launches {cd['block_sweep_colour']} {tag}", flush=True)
    # the field's error against the serial solve's in float64 (the mesh's
    # preconditioner then dist.py's plain step): in float32 it follows where
    # the last iteration lands under eps (about 950 times the final
    # residual at 128^3), which the dots' summation order alone moves 2-5
    # times either way, while in float64 the serial solve on the passes and
    # the mesh's block sums agree in count, residual and error
    p64 = Problem.poisson_cube(128, dtype=f64, device=dev)
    r64, c64, _ = krylov(p64, "pbicgstab", "sor2sma")
    check(c64["vector_pass"] == 5 * r64.iters,
          f"pbicgstab 128^3 f64: {c64['vector_pass']} vector passes")
    zero_counts()
    rd64 = solve_dist(p64, cm, "pbicgstab", omega=1.1, itr_max=4000,
                      precond="sor2sma")
    sync()
    cd64 = read_counts()
    e64s, e64d = err_max(p64, r64.x), err_max(p64, rd64.x)
    check(cd64["vector_pass"] == 0 and cd64["ax_kernel"] == 0,
          f"dist pbicgstab 128^3 f64: {cd64['vector_pass']} vector passes, "
          f"{cd64['ax_kernel']} operator passes")
    check(abs(rd64.iters - r64.iters) <= 1,
          f"dist pbicgstab 128^3 f64: {rd64.iters} iterations, serial "
          f"{r64.iters}")
    check(0.5 < e64d / e64s < 2.0,
          f"dist pbicgstab 128^3 f64: Error max {e64d} vs serial {e64s}")
    print(f"solve_dist pbicgstab sor2sma 128^3 f64 over (2, 2, 2): "
          f"{rd64.iters} iterations (serial {r64.iters}), Error max "
          f"{e64d:e} (serial {e64s:e}), res {rd64.res:e} (serial "
          f"{r64.res:e}) {tag}", flush=True)
    del cm, rd, p64, r64, rd64

    # K2's constant pair with a streamed b per call at 256^3 f32, the
    # shape the Krylov path gives it, against its twin on the same inputs
    sh256 = (256,) * 3
    pair_k = rb.make_packed_sweep2x(sh256, f32, omega=1.1, b_is_zero=False)
    pair_p = rb.make_packed_sweep2x(sh256, f32, omega=1.1, b_is_zero=False,
                                    plain=True)
    xs_ = rb.pack_rb(torch.rand(sh256, device=dev, generator=dgen) * 2 - 1)
    bs_ = rb.pack_rb(torch.rand(sh256, device=dev, generator=dgen) * 2 - 1)
    (xk, rk), (xp, rp) = pair_k(xs_, bs_), pair_p(xs_, bs_)
    sync()
    err["rb_sweeps_n_b"] = float((xk - xp).abs().max())
    check(err["rb_sweeps_n_b"] == 0.0, "K2 pair with b 256^3: field differs")
    check(float(((rk - rp).abs() / rp.abs()).max()) <= 1e-5,
          "K2 pair with b 256^3: residuals differ")
    p1 = events_ms(lambda: pair_p(xs_, bs_), 2)
    k1 = events_ms(lambda: pair_k(xs_, bs_), 20)
    k2 = events_ms(lambda: pair_k(xs_, bs_), 20)
    p2 = events_ms(lambda: pair_p(xs_, bs_), 2)
    per_call["rb_sweeps_n_b"] = (min(k1, k2), min(p1, p2))
    # x and b read, out written; 12 operations an update (K3's 11 and b)
    work["rb_sweeps_n_b"] = (3 * 4 * 256**3, 2 * 12 * 254**3)
    print(f"per call at 256^3 f32: K2 pair with b {per_call['rb_sweeps_n_b'][0]:.4f}"
          f" ms, plain twin {per_call['rb_sweeps_n_b'][1]:.4f} ms {tag}",
          flush=True)
    del pair_k, pair_p, xs_, bs_, xk, xp

    # the Krylov loop's operator pass (csrc/blas.cu) at 256^3, the shape the
    # Krylov path gives it: A x and b - A x bit for bit against the twin
    # (ops/blas.py) on the same card fields, float64 and float32, the
    # standard mask; then A x per call in float64, the Krylov cell's type
    for dtype in (f64, f32):
        msk_ = Problem.poisson_cube(256, dtype=dtype, device=dev).msk
        pa, ba = (torch.rand(sh256, device=dev, generator=dgen, dtype=dtype)
                  * 2 - 1 for _ in range(2))
        before = kax.operator_pass.launches
        for what, got, want in (
                ("A x", kax.calc_ax(pa, msk_), blas_ops.calc_ax(pa, msk_)),
                ("b - A x", kax.calc_rk(pa, ba, msk_),
                 blas_ops.calc_rk(pa, ba, msk_))):
            check(torch.equal(got, want),
                  f"operator pass 256^3 {dtype}: {what} differs from the twin's")
            err["ax_kernel"] = max(err.get("ax_kernel", 0.0),
                                   float((got - want).abs().max()))
        check(kax.operator_pass.launches == before + 2,
              f"operator pass 256^3 {dtype}: "
              f"{kax.operator_pass.launches - before} launches for 2 calls")
        if dtype == f64:
            p1 = events_ms(lambda: blas_ops.calc_ax(pa, msk_), 2)
            k1 = events_ms(lambda: kax.calc_ax(pa, msk_), 20)
            k2 = events_ms(lambda: kax.calc_ax(pa, msk_), 20)
            p2 = events_ms(lambda: blas_ops.calc_ax(pa, msk_), 2)
            per_call["ax_kernel"] = (min(k1, k2), min(p1, p2))
            # p and msk read, out written; 13 operations a point
            work["ax_kernel"] = (3 * 8 * 256**3, 13 * 256**3)
            print(f"per call at 256^3 f64: operator pass (A x) "
                  f"{per_call['ax_kernel'][0]:.4f} ms (bound "
                  f"{bound(*work['ax_kernel'])[0]:.4f}), plain twin "
                  f"{per_call['ax_kernel'][1]:.4f} ms; A x and b - A x bit "
                  f"for bit the twin's in f64 and f32 {tag}", flush=True)
        del msk_, pa, ba

    # the BiCGSTAB loop's vector passes (csrc/blas.cu: vec_kernel, and
    # fold_kernel after a pass with dots) at 256^3, the Krylov cell's shape,
    # in float64 and float32 on fields uniform in [-1, 1) boundary shell
    # included: each map bit for bit the twin's (ops/blas.py) on the same
    # card fields, each dot within VEC_DOT_RTOL of the twin's torch sum
    # relative to the sum of its terms' magnitudes, and the same bits in a
    # second call; then each pass per call in float64, the cell's type,
    # against its twin, beside its byte bound.  Pass: fields read (the mask
    # included) and written, operations a point (czbench's count of the
    # twin), its arguments from the fields f and the scalars a, b, o, its
    # maps (the rest are dots), and its dots' terms from f and the twin's
    # results w
    vec_passes = (
        ("bicg_1", 5, 4, lambda f, a, b, o: (f[0], f[1], f[2], b, o), 1,
         lambda f, w: ()),
        ("triad", 4, 2, lambda f, a, b, o: (f[0], f[1], a), 1,
         lambda f, w: ()),
        ("dot2", 3, 2, lambda f, a, b, o: (f[0], f[1]), 0,
         lambda f, w: (f[0] * f[1],)),
        ("dots_t", 3, 4, lambda f, a, b, o: (f[0], f[1]), 0,
         lambda f, w: (f[0] * f[1], f[0] * f[0])),
        ("update_xr", 9, 10, lambda f, a, b, o: (*f, a, o), 2,
         lambda f, w: (w[1] * w[1], w[1] * f[5])),
    )
    for dtype in (f64, f32):
        msk_ = Problem.poisson_cube(256, dtype=dtype, device=dev).msk
        f_ = [torch.rand(sh256, device=dev, generator=dgen, dtype=dtype) * 2 - 1
              for _ in range(6)]
        a_, b_, o_ = (torch.tensor(v, dtype=dtype, device=dev)
                      for v in (0.7310585786300049, -1.2599210498948732,
                                0.4142135623730951))
        gaps = {}
        for op, n_fields, n_ops, make, maps, terms in vec_passes:
            name = f"vec_kernel.{op}"
            args = (*make(f_, a_, b_, o_), msk_)
            kfn, pfn = getattr(kax, op), getattr(blas_ops, op)
            tup = lambda v: v if isinstance(v, tuple) else (v,)  # noqa: E731
            before = kax.vector_pass.launches
            got, again, want = tup(kfn(*args)), tup(kfn(*args)), tup(pfn(*args))
            sync()
            check(kax.vector_pass.launches == before + 2,
                  f"{name} 256^3 {dtype}: "
                  f"{kax.vector_pass.launches - before} launches for 2 calls")
            for g, w in zip(got[:maps], want[:maps]):
                check(torch.equal(g, w),
                      f"{name} 256^3 {dtype}: a map differs from the twin's")
            gap = 0.0
            for g, a2, w, tm in zip(got[maps:], again[maps:], want[maps:],
                                    terms(f_, want)):
                check(torch.equal(g, a2),
                      f"{name} 256^3 {dtype}: a dot differs run to run")
                scale = float((tm * msk_).abs().sum())
                gap = max(gap, abs(float(g) - float(w)) / scale)
            check(gap <= VEC_DOT_RTOL[str(dtype).removeprefix("torch.")],
                  f"{name} 256^3 {dtype}: a dot {gap:.3e} of its terms' "
                  "magnitudes from the twin's sum")
            gaps[op] = gap
            if dtype == f64:
                # maps bit for bit: the error is the dots' relative gap
                err[name] = gap
                p1 = events_ms(lambda: pfn(*args), 2)
                k1 = events_ms(lambda: kfn(*args), 20)
                k2 = events_ms(lambda: kfn(*args), 20)
                p2 = events_ms(lambda: pfn(*args), 2)
                per_call[name] = (min(k1, k2), min(p1, p2))
                work[name] = (n_fields * 8 * 256**3, n_ops * 256**3)
                print(f"per call at 256^3 f64: {op} pass "
                      f"{per_call[name][0]:.4f} ms (bound "
                      f"{bound(*work[name])[0]:.4f}), plain twin "
                      f"{per_call[name][1]:.4f} ms {tag}", flush=True)
            del got, again, want
        print(f"vector passes 256^3 {dtype}: maps bit for bit the twin's, "
              f"dots the same bits run to run, gap to the twin's sum over "
              f"the terms' magnitudes "
              f"{ {op: f'{g:.2e}' for op, g in gaps.items()} } {tag}",
              flush=True)
        del msk_, f_

    # timing of the three BASELINE-sized solves: wall per solve and per
    # iteration (CUDA events, after a warm-up, over distinct random starts),
    # then device time, device launches and busy share an iteration under
    # torch.profiler; beside the least time of an iteration: 60 fields moved
    # (K2's 8 pair calls read x and b and write out, 24; the 4 pads and
    # unpads, 8; the two zero starts, 2; the BLAS, 26: bicg_1 4, two ax 4,
    # three triads and bicg_2 10, five dots 8) over 3.35 TB/s
    for n, dtype, n_ref in ((256, f64, "f64"), (256, f32, "f32"),
                            (128, f32, "f32")):
        p = Problem.poisson_cube(n, dtype=dtype, device=dev)
        run = lambda q: solve(q, "pbicgstab", omega=1.1, itr_max=4000,  # noqa: E731
                              precond="sor2sma")
        run(p)  # warm-up
        sync()
        walls, per_it, its = [], [], []
        for _ in range(3):
            noise = torch.rand(p.x0.shape, device=dev, generator=dgen,
                               dtype=dtype) * p.msk
            q = dataclasses.replace(p, x0=p.x0 + 1e-3 * noise)
            ms = events_ms(lambda: its.append(run(q).iters), 1)
            walls.append(ms)
            per_it.append(ms / its[-1])
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            r = run(q)
            sync()
            wall = time.perf_counter() - t0
        us, n_ev = device_time(prof)
        check(us > 0, "the profiler recorded no device time in a Krylov solve")
        bound_ms = 60 * p.x0.element_size() * n**3 / HBM_BYTES_S * 1e3
        print(f"timing pbicgstab sor2sma {n}^3 {n_ref}: wall "
              f"{statistics.median(walls):.3f} ms a solve ({min(walls):.3f}-"
              f"{max(walls):.3f}; iterations {its}), "
              f"{statistics.median(per_it) * 1e3:.1f} us an iteration; under "
              f"the profiler {r.iters} iterations in {wall * 1e3:.3f} ms, device "
              f"{us / r.iters:.1f} us, {n_ev / r.iters:.1f} device launches and "
              f"busy share {us / 1e6 / wall:.3f} an iteration; bound "
              f"{bound_ms * 1e3:.1f} us an iteration (bytes) {tag}", flush=True)
        del p, q, r, prof

    # ---- 20. the exact serial orders (slice 6): P1 and P2 -------------------
    stamp(20)
    t20 = time.perf_counter()
    # each kernel against its plain twin on the same inputs (skewed seeded
    # fields), bit for bit: 128^3 float32 (the path's shape, timed) and 64^3
    # float64, constant and MAF; one sweep in a one-sweep launch, then the
    # step's launch of n lagged sweeps against n twin calls; the
    # residuals, float64 sums in another order on the two sides, to rtol
    # 1e-10 (one sweep) and 1e-12 (each of the n)
    diag_extra = {}  # P1/P2 row keys of the kernels line
    # the least work of a sweep at 128^3 f32, as ``ms`` is a sweep's share
    # of a launch of n: the launch reads S and B and writes S once, 3
    # fields, whatever its n sweeps read again inside it, so a sweep's
    # share is 3 / n fields; operations an inner point a sweep: psor 12
    # (five adds, the subtraction of b, the division, the update's three,
    # dp^2 and its sum), MAF 21; pcr K10's count of a line row (4 + 5 (pn
    # - 1) + 8 with tables, 15 + 16 (pn - 1) + 11 under MAF)
    pn128 = num_stage(126)
    diag_ops = {"psor_diag": 12, "psor_diag_maf": 21,
                "pcr_gs_diag": 4 + 5 * (pn128 - 1) + 8,
                "pcr_gs_diag_maf": 15 + 16 * (pn128 - 1) + 11}
    for n, dtype in ((128, f32), (64, f64)):
        skew, _, _ = psor_scan.make_skew((n,) * 3)
        S, B = (skew(torch.rand((n,) * 3, device=dev, generator=dgen,
                                dtype=dtype) * 2 - 1) for _ in range(2))
        for maf in (False, True):
            mc = (Problem.poisson_cube(n, dtype=dtype, device=dev, maf=True).mc
                  if maf else None)
            for kname, omega in (("psor_diag", 1.1), ("pcr_gs_diag", OMEGA)):
                if kname == "psor_diag":
                    sweeps = kp1.sweeps_for((n,) * 3, dev)
                    launch1 = kp1.PsorSweep(omega, mc)
                    launchn = kp1.PsorSweep(omega, mc, sweeps)

                    def kfn(S_, launch):
                        return kp1.psor_diag(S_, B, omega, mc, launcher=launch)

                    def pfn(S_):
                        return psor_scan.psor_diag_plain(S_, B, omega, mc)
                else:
                    sweeps = kp2.sweeps_for((n,) * 3, dtype, maf, dev)
                    launch1 = kp2.PcrGsSweep(omega, mc)
                    launchn = kp2.PcrGsSweep(omega, mc, sweeps=sweeps)
                    tabs = launch1.tables(S)

                    def kfn(S_, launch):
                        return kp2.pcr_gs_diag(S_, B, omega, mc, launcher=launch)

                    def pfn(S_):
                        return gs_ops.pcr_gs_diag_plain(S_, B, omega, tabs)
                var = kname + ("_maf" if maf else "")
                label = f"{var} {n}^3 {str(dtype)[6:]}"
                Sk, rk = kfn(S.clone(), launch1)
                Sp, rp = pfn(S)
                sync()
                e = float((Sk - Sp).abs().max())
                check(torch.equal(Sk, Sp), f"{label}: the sweep differs from its "
                      f"twin's by {e}")
                r_rel = abs(float(rk) / float(rp) - 1)  # rk: the launcher's buffer
                check(r_rel <= 1e-10, f"{label}: residual {float(rk)} against "
                      f"the twin's {float(rp)}")
                # the launch of n sweeps against n twin calls
                Sn, rn = kfn(S.clone(), launchn)
                rn = rn.tolist()
                Sp, rps = S, []
                for _ in range(sweeps):
                    Sp, r_ = pfn(Sp)
                    rps.append(float(r_))
                sync()
                en = float((Sn - Sp).abs().max())
                check(torch.equal(Sn, Sp), f"{label}: {sweeps} sweeps in one "
                      f"launch differ from {sweeps} twin calls by {en}")
                rn_rel = max(abs(x / y - 1) for x, y in zip(rn, rps))
                check(rn_rel <= 1e-12, f"{label}: the {sweeps}-sweep launch's "
                      f"residuals {rn} against the twin's {rps}")
                # ms a sweep: back-to-back launches on one field (in place)
                Sw = Sk.clone()
                kfn(Sw, launch1)
                k1_ms = min(events_ms(lambda: kfn(Sw, launch1), 10),
                            events_ms(lambda: kfn(Sw, launch1), 10))
                kfn(Sw, launchn)
                kn_ms = min(events_ms(lambda: kfn(Sw, launchn), 5),
                            events_ms(lambda: kfn(Sw, launchn), 5)) / sweeps
                p_ms = events_ms(lambda: pfn(S), 1)
                # the chain: dependent steps of a launch (the lagged
                # wavefront's, I + J - 5 (+ chunks - 1 for P1) + 2 (n - 1)),
                # a sweep's share of them and the time of a step
                steps = (launchn.plan.steps((n,) * 3) if kname == "psor_diag"
                         else 2 * n - 5 + 2 * (sweeps - 1))
                if n == 128:
                    err[var] = max(e, en)
                    per_call[var] = (kn_ms, p_ms)
                    work[var] = (3 * fb / sweeps, diag_ops[var] * inner)
                    diag_extra[var] = {
                        "sweeps_per_launch": sweeps, "ms_one_sweep_launch": k1_ms,
                        "steps_per_sweep": steps / sweeps,
                        "us_per_step": kn_ms * 1e3 * sweeps / steps}
                plan = (f"{launchn.plan.form} form, {launchn.grid} CTAs"
                        if kname == "pcr_gs_diag" else
                        f"{launchn.plan.rows} rows a chunk, {launchn.grid} CTAs")
                print(f"{label}: one sweep bitwise its twin, residual rtol "
                      f"{r_rel:.1e}; {sweeps} sweeps in one launch bitwise "
                      f"{sweeps} twin calls, residuals rtol {rn_rel:.1e}; "
                      f"{kn_ms:.4f} ms a sweep in launches of {sweeps} "
                      f"({plan}), {k1_ms:.4f} in "
                      f"one-sweep launches (twin {p_ms:.4f} ms) {tag}", flush=True)
                del Sk, Sp, Sw, Sn
        del S, B

    def diag_solve(p, name, omega, **kw):
        zero_counts()
        t0 = time.perf_counter()
        r = solve(p, name, omega=omega, itr_max=20000, **kw)
        sync()
        return r, read_counts(), time.perf_counter() - t0

    def diag_var(name):
        return (("psor_diag" if name.startswith("psor") else "pcr_gs_diag")
                + ("_maf" if name.endswith("_maf") else ""))

    def diag_launches(p, name, omega, iters):
        """(launches of a solve of ``iters`` sweeps, sweeps a call): whole
        calls of the step's n lagged sweeps to the chunk that stops, then
        the stopping chunk replayed on the one-sweep launch."""
        kind = "psor" if name.startswith("psor") else "pcr_gs"
        n = get_fused_step(kind, p.grid, omega, mc=p.mc).iters_per_call
        calls = -(-iters // n)
        return calls + (iters - n * (calls - 1) if iters % n else 0), n

    # the oracle's runs: 128^3 float32 (count +-2%; curve rtol 1e-3 but for
    # the last entry, against the oracle with float64 sums of dp^2, HIST64:
    # the reference sums these sweeps' dp^2 in one float, the kernels in
    # float64) and 64^3 float64 (+-1%, rtol 1e-6); each solve with the
    # counts zeroed just before and read just after: launches of n sweeps
    # and the stop's one-sweep launches (diag_launches), no other kernel of
    # this slice
    diag_solves = {}
    for name, omega, n, dtype in (
            ("psor", 1.1, 128, f32), ("psor_maf", 1.1, DIAG_MAF_N, f32),
            ("pcr", OMEGA, 128, f32), ("pcr_maf", OMEGA, DIAG_MAF_N, f32),
            ("psor", 1.1, 64, f64), ("psor_maf", 1.1, 64, f64),
            ("pcr", OMEGA, 64, f64), ("pcr_maf", OMEGA, 64, f64)):
        is32 = dtype == f32
        label = f"{name} {n}^3 {'f32' if is32 else 'f64'}"
        stem = (f"{'f32' if is32 else 'f64'}_{name}_{n}_w"
                f"{'1.1' if name.startswith('psor') else '1.5'}")
        ref = load_history(stem + ".txt")
        curve = (load_history(stem + "_f64sum.txt", HIST64)
                 if is32 and n == 128 else ref)
        p = Problem.poisson_cube(n, dtype=dtype, device=dev,
                                 maf=name.endswith("_maf"))
        r, c, wall = diag_solve(p, name, omega)
        var = diag_var(name)
        check(r.x.shape == (n,) * 3 and bool(torch.isfinite(r.x).all()),
              f"{label}: field of the wrong shape or not finite")
        check(abs(r.iters - len(ref)) <= max(1, len(ref) * (2 if is32 else 1) // 100),
              f"{label}: {r.iters} iterations, oracle {len(ref)}")
        m = min(r.iters, len(curve)) - (1 if is32 else 0)
        worst = max(abs(h / q - 1) for h, q in zip(r.history[:m].tolist(),
                                                   curve[:m]))
        check(worst <= (1e-3 if is32 else 1e-6), f"{label}: history rtol {worst}")
        others = [v for v in ("psor_diag", "psor_diag_maf", "pcr_gs_diag",
                              "pcr_gs_diag_maf") if v != var]
        want, n_call = diag_launches(p, name, omega, r.iters)
        check(c[var] == want and not any(c[v] for v in others),
              f"{label}: {c[var]} {var} launches for {r.iters} sweeps, not "
              f"{want} (calls of {n_call} and the stop's one-sweep launches)")
        if is32:
            path_launches[var] = c[var]
        diag_solves[(name, n)] = (r.iters, wall)
        print(f"{label}: {r.iters} iterations (oracle {len(ref)}), history rtol "
              f"{worst:.2e}, res {r.res:e}, Error max {err_max(p, r.x):e}, wall "
              f"{wall:.3f} s ({wall / r.iters * 1e3:.4f} ms a sweep), {var} "
              f"launches {c[var]} ({n_call} sweeps a call) {tag}", flush=True)
        del p, r

    # pcr_eda and pcr_esa: pcr's step (three layouts of one serial line
    # Gauss-Seidel), at 32^3 float32 the f32 oracle's 142 +-2%
    p32 = Problem.poisson_cube(32, device=dev)
    r_pcr, _, _ = diag_solve(p32, "pcr", OMEGA)
    for name in ("pcr_eda", "pcr_esa"):
        r, c, _ = diag_solve(p32, name, OMEGA)
        check(r.iters == r_pcr.iters and abs(r.iters - 142) <= 2
              and torch.equal(r.x, r_pcr.x)
              and c["pcr_gs_diag"] == diag_launches(p32, name, OMEGA, r.iters)[0],
              f"{name} 32^3: {r.iters} iterations ({c['pcr_gs_diag']} P2 "
              f"launches), pcr {r_pcr.iters}")
        print(f"{name} 32^3 f32: {r.iters} iterations, pcr's field bit for "
              f"bit, P2 launches {c['pcr_gs_diag']} {tag}", flush=True)

    # solve_dist over (2, 2, 2) at 64^3 (the serial step on the gathered
    # field): the serial count, history and field bit for bit
    p64 = Problem.poisson_cube(64, device=dev)
    cm64 = make_mesh((64,) * 3, devices=[dev] * 8, div=(2, 2, 2))
    for name, omega in (("psor", 1.1), ("pcr", OMEGA)):
        rs, _, _ = diag_solve(p64, name, omega)
        zero_counts()
        t0 = time.perf_counter()
        rd = solve_dist(p64, cm64, name, omega=omega, itr_max=20000)
        sync()
        wall = time.perf_counter() - t0
        c = read_counts()
        var = diag_var(name)
        check(rd.iters == rs.iters and torch.equal(rd.x, rs.x)
              and torch.equal(rd.history, rs.history)
              and c[var] == diag_launches(p64, name, omega, rd.iters)[0],
              f"solve_dist {name} 64^3: {rd.iters} iterations, serial "
              f"{rs.iters}, or the field differs")
        print(f"solve_dist {name} 64^3 f32 over (2, 2, 2): {rd.iters} "
              f"iterations, the serial field bit for bit, wall {wall:.3f} s "
              f"{tag}", flush=True)

    # pbicgstab with psor as its preconditioner: 8 sweeps an application in
    # the step's own layout, one launch of 8 lagged sweeps, two
    # applications an iteration
    r, c, wall = krylov(p64, "pbicgstab", "psor", omega=1.1)
    check(r.res < 1e-5 and c["psor_diag"] == 2 * r.iters,
          f"pbicgstab psor 64^3: res {r.res}, {c['psor_diag']} P1 launches for "
          f"{r.iters} iterations")
    print(f"pbicgstab psor 64^3 f32: {r.iters} iterations, res {r.res:e}, "
          f"Error max {err_max(p64, r.x):e}, wall {wall:.3f} s, P1 launches "
          f"{c['psor_diag']} {tag}", flush=True)
    del p32, p64, cm64, r, rs, rd, r_pcr

    # the reference's documented run, ./cz 124 124 124 pcr 10000 1.5
    # (Readme.md:390), through the CLI: the in-process solve's count
    p124 = Problem.poisson_cube(124, device=dev)
    r124, _, _ = diag_solve(p124, "pcr", OMEGA)
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, "-m", "cubez_tpu_torch.cli", "124", "124", "124",
             "pcr", "10000", "1.5"], cwd=tmp, env=env, capture_output=True,
            text=True, timeout=300)
        check(proc.returncode == 0, f"CLI pcr exited {proc.returncode}:\n"
              f"{proc.stderr}")
        check(f"Iter = {r124.iters}  Res = " in proc.stdout
              and "Error max = " in proc.stdout,
              f"CLI 124^3 pcr: not the in-process count {r124.iters}")
        for ln in proc.stdout.splitlines():
            if ln.startswith(("Iter =", "wall =", "Error max")):
                print(f"CLI 124^3 pcr: {ln.strip()}")
    del p124, r124

    # busy share of the 128^3 float32 paths: whole calls of a solve to at
    # least 200 sweeps (eps 1e-30: no stop), one launch of n sweeps and one
    # host check a call, under torch.profiler
    diag_busy = {}
    for name, omega in (("psor", 1.1), ("pcr", OMEGA)):
        p = Problem.poisson_cube(128, device=dev)
        n_call = diag_launches(p, name, omega, 1)[1]
        window = -(-200 // n_call) * n_call
        solve(p, name, omega=omega, itr_max=n_call, eps=1e-30)  # warm-up
        sync()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            solve(p, name, omega=omega, itr_max=window, eps=1e-30)
            sync()
            wall = time.perf_counter() - t0
        us, n_ev = device_time(prof)
        check(us > 0, f"{name}: the profiler recorded no device time")
        diag_busy[name] = (us / window, n_ev / window, us / 1e6 / wall)
        print(f"timing {name} 128^3 f32 solve window of {window} sweeps: wall "
              f"{wall / window * 1e3:.4f} ms a sweep, device {us / window:.1f} us "
              f"and {n_ev / window:.2f} device launches a sweep, busy share "
              f"{us / 1e6 / wall:.3f} {tag}", flush=True)
        del p, prof
    print(f"phase 20: {time.perf_counter() - t20:.1f} s", flush=True)

    # ---- 21. the extensions (slice 7): mg, fmg and fd ------------------------
    stamp(21)
    t21 = time.perf_counter()
    from cubez_tpu_torch.solvers import direct as fd_mod
    from cubez_tpu_torch.utils.sph import read_sph

    def k4_rb(c):
        return c["k4_rb_color"] + c["k4_rb_color_maf"]

    def fine_sweeps(r, name, precond=False):
        """K4's launches in a solve: nu1 + nu2 = 2 a V-cycle; the driver
        runs chunks of 2 cycles and replays an odd stop from its chunk's
        start; fmg's F-cycle adds one fine V-cycle."""
        if precond:  # two applications an iteration, one V-cycle each
            return 4 * r.iters
        cycles = r.iters + 2 * (r.iters % 2)
        return 2 * cycles + (2 if name.startswith("fmg") else 0)

    def ext_solve(p, name, **kw):
        zero_counts()
        t0 = time.perf_counter()
        r = solve(p, name, omega=1.0, itr_max=100, **kw)
        sync()
        return r, read_counts(), time.perf_counter() - t0

    # each name at 128^3 f32 with the counts zeroed just before and read
    # just after: JAX's count (tools/jax_ext_counts.py), Error max at
    # ERR_RTOL of JAX's, K4 launched for each fine sweep and no other
    # kernel of the port, and the field at the stop bitwise a plain-twin
    # solve's on the card
    mg_launches = {}
    ext_runs = {}
    for name in ("mg", "mg_maf", "fmg", "fmg_maf", "fd", "fd_maf"):
        p = Problem.poisson_cube(128, device=dev, maf=name.endswith("_maf"))
        r, c, wall = ext_solve(p, name)
        rp, _, _ = ext_solve(p, name, impl="plain")
        j_iters, _, j_err = JAX_EXT_128[name]
        e = err_max(p, r.x)
        check(r.x.shape == (128,) * 3 and bool(torch.isfinite(r.x).all()),
              f"{name} 128^3: field of the wrong shape or not finite")
        check(r.iters == j_iters and r.res < 1e-5,
              f"{name} 128^3: {r.iters} iterations (res {r.res}), JAX {j_iters}")
        check(abs(e / j_err - 1) <= ERR_RTOL,
              f"{name} 128^3: Error max {e}, JAX {j_err}")
        want = 0 if name.startswith("fd") else fine_sweeps(r, name)
        others = sum(v for k, v in c.items() if k not in ("k4_rb_color",
                                                         "k4_rb_color_maf"))
        check(k4_rb(c) == want and others == 0,
              f"{name} 128^3: {k4_rb(c)} K4 launches (want {want}), "
              f"{others} other launches")
        check(rp.iters == r.iters and torch.equal(rp.x, r.x)
              and torch.equal(rp.history, r.history),
              f"{name} 128^3: not the plain-twin solve's field")
        if want:
            var = "k4_rb_color" + ("_maf" if name.endswith("_maf") else "")
            mg_launches.setdefault(var, k4_rb(c))
        ext_runs[name] = (r.iters, e, wall)
        print(f"{name} 128^3 f32: {r.iters} iterations (JAX {j_iters}), res "
              f"{r.res:e}, Error max {e:e} (JAX {j_err:e}), K4 launches "
              f"{k4_rb(c)}, the plain-twin field bit for bit, wall "
              f"{wall:.3f} s {tag}", flush=True)
        del p, r, rp

    # the Krylov solvers with the extensions as preconditioners at 128^3:
    # JAX's counts; one V-cycle an application (4 K4 launches an iteration)
    p = Problem.poisson_cube(128, device=dev)
    for solver, precond in (("pbicgstab", "mg"), ("cg", "fd")):
        r, c, wall = krylov(p, solver, precond, omega=1.0)
        j_iters = JAX_EXT_128[f"{solver}+{precond}"][0]
        want = fine_sweeps(r, precond, precond=True) if precond == "mg" else 0
        check(r.iters == j_iters and r.res < 1e-5 and k4_rb(c) == want,
              f"{solver} {precond} 128^3: {r.iters} iterations (JAX "
              f"{j_iters}), res {r.res}, {k4_rb(c)} K4 launches")
        print(f"{solver} {precond} 128^3 f32: {r.iters} iterations (JAX "
              f"{j_iters}), res {r.res:e}, Error max {err_max(p, r.x):e}, K4 "
              f"launches {k4_rb(c)}, wall {wall:.3f} s {tag}", flush=True)

    # solve_dist over eight blocks on the card: the serial step on the
    # gathered field, so the serial count and field bit for bit
    cm128 = make_mesh((128,) * 3, devices=[dev] * 8, div=(2, 2, 2))
    for name in ("mg", "fd"):
        rs, _, _ = ext_solve(p, name)
        zero_counts()
        rd = solve_dist(p, cm128, name, omega=1.0, itr_max=100)
        sync()
        c = read_counts()
        check(rd.iters == rs.iters and torch.equal(rd.x, rs.x)
              and torch.equal(rd.history, rs.history),
              f"solve_dist {name} 128^3: {rd.iters} iterations, serial "
              f"{rs.iters}, or the field differs")
        print(f"solve_dist {name} 128^3 f32 over (2, 2, 2): {rd.iters} "
              f"iterations, the serial field bit for bit, K4 launches "
              f"{k4_rb(c)} {tag}", flush=True)
    del cm128, rs, rd

    # the CLI: fmg with --dump, read back equal to the in-process field
    r_fmg, _, _ = ext_solve(p, "fmg")
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, "-m", "cubez_tpu_torch.cli", "128", "128", "128",
             "fmg", "100", "1.0", "--dump", f"{tmp}/p.sph"], cwd=tmp, env=env,
            capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0, f"CLI fmg exited {proc.returncode}:\n"
              f"{proc.stderr}")
        check(f"Iter = {r_fmg.iters}  Res = " in proc.stdout,
              f"CLI 128^3 fmg: not the in-process count {r_fmg.iters}")
        field, _, _, step_, _ = read_sph(f"{tmp}/p.sph")
        check(step_ == r_fmg.iters
              and torch.equal(torch.from_numpy(field.copy()), r_fmg.x.cpu()),
              "CLI 128^3 fmg --dump: the SPH field is not the solve's")
        for ln in proc.stdout.splitlines():
            if ln.startswith(("Iter =", "wall =", "Error max")):
                print(f"CLI 128^3 fmg --dump: {ln.strip()}")
    print(f"CLI 128^3 fmg --dump p.sph: read back equal to the field, step "
          f"{step_} {tag}", flush=True)
    del r_fmg

    # mg's host cost: wall and device time a V-cycle at 128^3 (CUDA events,
    # 20 cycles minus 4 after a warm-up, eps 1e-30: no stop), K4's share of
    # the device time, device launches and busy share a cycle under
    # torch.profiler
    solve(p, "mg", omega=1.0, itr_max=4, eps=1e-30)  # warm-up
    sync()
    walls = {n_: min(events_ms(lambda: solve(p, "mg", omega=1.0, itr_max=n_,
                                             eps=1e-30), 1) for _ in range(3))
             for n_ in (4, 20)}
    mg_wall_us = (walls[20] - walls[4]) / 16 * 1e3
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        solve(p, "mg", omega=1.0, itr_max=20, eps=1e-30)
        sync()
        wall = time.perf_counter() - t0
    us, n_ev = device_time(prof)
    k4_us = device_time(prof, "rb_tile_kernel")[0]
    check(us > 0 and k4_us > 0, "mg: the profiler recorded no device time")
    mg_cycle = (mg_wall_us, us / 20, k4_us / us, n_ev / 20, us / 1e6 / wall)
    print(f"timing mg 128^3 f32: wall {mg_wall_us:.1f} us a V-cycle (events, "
          f"20 minus 4 cycles); under the profiler {us / 20:.1f} device us a "
          f"cycle, K4 {k4_us / us:.3f} of it, {n_ev / 20:.1f} device launches "
          f"and busy share {us / 1e6 / wall:.3f} a cycle {tag}", flush=True)
    del p, prof

    # fd: one solve (the step: residual, six matmuls, residual) and the
    # contraction alone, at 128^3 and 512^3, against the contraction's
    # bound: 6 products of 2 n^4 operations over the card's float32 peak,
    # 12 passes over an inner field over its memory rate
    fd_times = {}
    for n in (128, 512):
        p = Problem.poisson_cube(n, device=dev)
        r, c, wall = ext_solve(p, "fd")
        check(r.iters == 1 and r.res < 1e-5 and not any(c.values()),
              f"fd {n}^3: {r.iters} iterations, res {r.res}")
        prev = torch.backends.cuda.matmul.fp32_precision
        try:
            torch.set_float32_matmul_precision("high")
            r_hi, _, _ = ext_solve(p, "fd")
            check(torch.backends.cuda.matmul.fp32_precision == "tf32",
                  "fd did not restore the caller's TF32 setting")
        finally:
            torch.backends.cuda.matmul.fp32_precision = prev
        check(torch.equal(r_hi.x, r.x) and torch.equal(r_hi.history, r.history),
              f"fd {n}^3: the result moved under TF32 matmul precision 'high'")
        step = fd_mod.make_fd_step(p)
        m = n - 2
        tabs = [tuple(torch.tensor(a, dtype=f32, device=dev) for a in t)
                for t in fd_mod._axis_tables(p.grid, None)]
        rr = torch.rand((m,) * 3, device=dev, generator=dgen)
        step(p.x0, p.rhs)  # warm-up
        with fd_mod.ieee_fp32():
            fd_mod.minv(rr, tabs)
            c_ms = min(events_ms(lambda: fd_mod.minv(rr, tabs), 5)
                       for _ in range(3))
        s_ms = min(events_ms(lambda: step(p.x0, p.rhs), 3) for _ in range(3))
        bms, by = bound(12 * 4 * m**3, 6 * 2 * m**4)
        fd_times[n] = (s_ms, c_ms, bms, by)
        print(f"fd {n}^3 f32: {r.iters} iteration, res {r.res:e}, Error max "
              f"{err_max(p, r.x):e}, the same result bit for bit under "
              f"set_float32_matmul_precision('high'); {s_ms:.3f} ms a solve, "
              f"the contraction (six torch.matmul, IEEE FP32) {c_ms:.3f} ms "
              f"against a bound of {bms:.3f} ms ({by}) {tag}", flush=True)
        del p, r, r_hi, step, tabs, rr

    # mg at 512^3 for its count: the plain-twin solve's count and field
    p = Problem.poisson_cube(512, device=dev)
    r, c, wall = ext_solve(p, "mg")
    rp, _, _ = ext_solve(p, "mg", impl="plain")
    check(r.iters == rp.iters and r.res < 1e-5 and torch.equal(r.x, rp.x)
          and k4_rb(c) == fine_sweeps(r, "mg"),
          f"mg 512^3: {r.iters} iterations (plain twin {rp.iters}), res "
          f"{r.res}, {k4_rb(c)} K4 launches")
    print(f"mg 512^3 f32: {r.iters} iterations (128^3: "
          f"{ext_runs['mg'][0]}), res {r.res:e}, Error max "
          f"{err_max(p, r.x):e}, the plain-twin field bit for bit, K4 launches "
          f"{k4_rb(c)}, wall {wall:.3f} s {tag}", flush=True)
    del p, r, rp
    print(f"phase 21: {time.perf_counter() - t21:.1f} s", flush=True)

    # ---- 22. the perf layer (slice 8) ------------------------------------------
    stamp(22)
    t22 = time.perf_counter()
    perf_phase(timing[("sor2sma", "kernel", 512)], tag, env)
    print(f"phase 22: {time.perf_counter() - t22:.1f} s", flush=True)

    rbpack_cu = "cubez_tpu_torch/csrc/rbpack.cu"
    sweeps_cu = "cubez_tpu_torch/csrc/sweeps.cu"
    rblines_cu = "cubez_tpu_torch/csrc/rblines.cu"
    lines_cu = "cubez_tpu_torch/csrc/lines.cu"
    dist_rbpack_cu = "cubez_tpu_torch/csrc/dist_rbpack.cu"
    dist_sweeps_cu = "cubez_tpu_torch/csrc/dist_sweeps.cu"
    k4_site = "cubez_tpu/pallas_kernels/sweeps.py:416"
    k5_site = "cubez_tpu/pallas_kernels/rblines.py:407"
    k6_site = "cubez_tpu/pallas_kernels/lines.py:441"
    k7_site = ("cubez_tpu/pallas_kernels/sweeps2x.py:480 via "
               "cubez_tpu/pallas_kernels/dist_rbpack.py:299")
    k8_site = "cubez_tpu/pallas_kernels/dist_sweeps.py:269"
    dist_pcr_cu = "cubez_tpu_torch/csrc/dist_pcr.cu"
    pcr_cu = "cubez_tpu_torch/csrc/pcr.cu"
    k9_site = "cubez_tpu/pallas_kernels/dist_pcr.py:379"
    k10_site = "cubez_tpu/pallas_kernels/pcr.py:414"
    dist_halo_cu = "cubez_tpu_torch/csrc/dist_halo.cu"
    psor_cu = "cubez_tpu_torch/csrc/psor.cu"
    pcr_gs_cu = "cubez_tpu_torch/csrc/pcr_gs.cu"
    psor_site = "cubez_tpu/ops/psor_scan.py:82"
    pcr_gs_site = "cubez_tpu/ops/pcr_gs.py:33"
    meta = {
        # K1: rb_sweeps_n's launch at n = 1, the row form at 128^3 and the
        # one-pass tile form beyond the L2 (the 512^3 replays, phase 6)
        "rb_single": (rbpack_cu, "cubez_tpu/pallas_kernels/rbpack.py:732"),
        "rb_single_maf": (rbpack_cu, "cubez_tpu/pallas_kernels/rbpack.py:732"),
        "rb_single_tile": (rbpack_cu, "cubez_tpu/pallas_kernels/rbpack.py:732"),
        "rb_sweeps_n": (rbpack_cu, "cubez_tpu/pallas_kernels/sweeps2x.py:480"),
        "rb_sweeps_n_maf": (rbpack_cu,
                            "cubez_tpu/pallas_kernels/sweeps2x.py:552"),
        # K2's constant pair with a streamed b: the Krylov preconditioner's
        # sor2sma (256^3, phase 19)
        "rb_sweeps_n_b": (rbpack_cu, "cubez_tpu/pallas_kernels/sweeps2x.py:552"),
        "rb_sweeps_n_maf_chain": (rbpack_cu,
                                  "cubez_tpu/pallas_kernels/sweeps2x.py:480"),
        # the one-pass tile form of K3 (and of K2's zero-b pair), the
        # dispatch's chain beyond the L2 (512^3, phase 6)
        "rb_sweeps_n_tile": (rbpack_cu, "cubez_tpu/pallas_kernels/sweeps2x.py:480"),
        "rb_sweeps_n_maf_tile": (rbpack_cu,
                                 "cubez_tpu/pallas_kernels/sweeps2x.py:480"),
        "k4_jacobi": (sweeps_cu, k4_site),
        "k4_jacobi_maf": (sweeps_cu, k4_site),
        "k4_rb_color": (sweeps_cu, k4_site),
        "k4_rb_color_maf": (sweeps_cu, k4_site),
        "rbl": (rblines_cu, k5_site),
        "rbl_maf": (rblines_cu, k5_site),
        "line_j": (lines_cu, k6_site),
        "line_j_maf": (lines_cu, k6_site),
        "line_rb": (lines_cu, k6_site),
        "line_rb_maf": (lines_cu, k6_site),
        "dist_rb_sweeps": (dist_rbpack_cu, k7_site),
        "dist_rb_sweeps_maf": (dist_rbpack_cu, k7_site),
        # the ring refresh has no pallas_call: the JAX package's
        # exchange_ghosts_packed moves the ring by lax.ppermute
        "pack_exchange": (dist_rbpack_cu, "cubez_tpu/parallel/dist_pack.py:50"),
        "block_sweep_jacobi": (dist_sweeps_cu, k8_site),
        "block_sweep_colour": (dist_sweeps_cu, k8_site),
        "block_sweep_both": (dist_sweeps_cu, k8_site),
        "block_sweep_interior": (dist_sweeps_cu, k8_site),
        "block_sweep_shell": (dist_sweeps_cu, k8_site),
        "block_pcr": (dist_pcr_cu, k9_site),
        "block_pcr_maf": (dist_pcr_cu, k9_site),
        "block_pcr_fastdiag": (dist_pcr_cu, k9_site),
        "block_pcr_fastdiag_maf": (dist_pcr_cu, k9_site),
        "fused_pcr": (pcr_cu, k10_site),
        "fused_pcr_maf": (pcr_cu, k10_site),
        # no pallas_call: the JAX package exchanges by lax.ppermute and folds
        # by lax.psum; these launches take their place on one card
        "halo_exchange": (dist_halo_cu, "cubez_tpu/parallel/halo.py:36"),
        "fold_partials": (dist_halo_cu, "cubez_tpu/parallel/halo.py:60"),
        # no pallas_call: the JAX package's diagonal steps are XLA loops
        # (P1 and P2 take their place)
        "psor_diag": (psor_cu, psor_site),
        "psor_diag_maf": (psor_cu, psor_site),
        "pcr_gs_diag": (pcr_gs_cu, pcr_gs_site),
        "pcr_gs_diag_maf": (pcr_gs_cu, pcr_gs_site),
        # no pallas_call: the JAX package leaves calc_ax and calc_rk to XLA;
        # the Krylov loop's A x and b - A x (256^3 float64, phase 19)
        "ax_kernel": ("cubez_tpu_torch/csrc/blas.cu", "cubez_tpu/ops/blas.py:45"),
        # no pallas_call: XLA fuses the JAX package's vector ops; the
        # BiCGSTAB loop's vector passes (256^3 float64, phase 19)
        **{f"vec_kernel.{op}": ("cubez_tpu_torch/csrc/blas.cu",
                                f"cubez_tpu/ops/blas.py:{line}")
           for op, line in VEC_SITES.items()},
    }
    for name in meta:
        check(path_launches.get(name, 0) > 0, f"{name}: no path launched it")
    kernels = []
    for name, (src, site) in meta.items():
        bms, by = bound(*work[name])
        # no single PyTorch call computes a red-black colour, a Jacobi sweep,
        # a line relaxation (none solves a batch of tridiagonal systems;
        # torch.linalg.solve on dense (n, n) systems is another algorithm
        # with n times the work) or the face exchange: library_ms is null
        # for those; the fold's is one float64 ``sum``
        kernels.append(
            {"name": name, "route": "cuda", "source": src, "replaces": site,
             "launches": path_launches[name], "max_abs_err": err[name],
             "ms": per_call[name][0], "plain_ms": per_call[name][1],
             "bound_ms": bms, "bound_by": by, "library_ms": per_call[name][2] if len(per_call[name]) > 2 else None})
        kernels[-1].update(k10_extra.get(name, {}))
        kernels[-1].update(diag_extra.get(name, {}))
        if name in krylov_launches:
            # the launches of the 128^3 Krylov solves that precondition on it
            kernels[-1]["krylov_launches"] = krylov_launches[name]
        if name in mg_launches:
            # the launches of the 128^3 mg (mg_maf) solve's finest level
            kernels[-1]["mg_launches"] = mg_launches[name]
        if name == "rb_sweeps_n_b":
            kernels[-1]["shape"] = [256] * 3
        if name == "ax_kernel":
            kernels[-1].update({"shape": [256] * 3, "dtype": "float64"})
        if name.startswith("vec_kernel."):
            # a pass with dots is the pass and fold_kernel's fold of its
            # partials; the error is its dots' gap to the twin's sum over
            # the terms' magnitudes (its maps are bit for bit)
            dots = name.split(".")[1] in ("dot2", "dots_t", "update_xr")
            kernels[-1].update({
                "shape": [256] * 3, "dtype": "float64",
                "kernels": ["vec_kernel"] + ["fold_kernel"] * dots})
        if name in work512:
            kernels[-1]["shape"] = [512] * 3 if name.endswith("_tile") else [128] * 3
        if name in per_call_512:
            # the same least work at 512^3: 2 fields (K2: 3), the row's
            # operations
            w5 = work512.get(name, (2 * fb5, work[name][1] / inner * inner5))
            kernels[-1].update({"ms_512": per_call_512[name][0],
                                "plain_ms_512": per_call_512[name][1],
                                "bound_ms_512": bound(*w5)[0]})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
