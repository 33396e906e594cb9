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
     (37, 22, 45) (K, I, J): the single sweep with zero and seeded b, the
     pair with b, n = 3, 4, 6, offsets 0 and 1;
   - the MAF packed steps (single with and without b, pair with and
     without b, n = 3 and 6) on stretched-grid coefficients, and K4
     (jacobi and sor2sma, constant and MAF, with and without b) at 128^3,
     125^3 (odd I: K4 only) and the ragged shape, offsets 0 and 1;
   - the line steps, constant and MAF, with and without b: K5 (rbl) at
     128^3 and the ragged shape, K6's line-Jacobi (line_j) at all three,
     K6's red-black form (line_rb) at 125^3 and the ragged shape, and all
     three at the shared-memory tile's edges (LINE_EDGES: 2 and 3 inner
     rows, K - 2 not a multiple of a tile's thread rows, line counts not a
     multiple of its 32 lines, odd I and J);
4. the main path, ``solve(Problem.poisson_cube(128, device="cuda"),
   "sor2sma", omega=1.5, itr_max=10000)``, with the kernels' launch counts
   zeroed just before: 1777-1849 iterations (the f32 oracle's 1813 +-2%),
   history to rtol 1e-3, every kernel launched, and the same Error max as a
   plain-twin solve on the card (1e-5);
5. float64 at 128^3: the f64 oracle's count +-1%, history to rtol 1e-6;
6. float32 at 512^3: within 2% of the f64 oracle's 5781 iterations;
7. the slice-2 paths at 128^3 f32, each with the counts zeroed just before
   and read just after: sor2sma_maf (the packed MAF pair, its stopping
   chunk replayed on the MAF single sweep; 1813 +-2%), jacobi and
   jacobi_maf at omega 0.8 (K4; 5378 and 5377 +-2%), histories to rtol 1e-3
   (the jacobi pair's against the oracle with float64 sums of dp^2,
   tests/torch_ref_histories), Error max equal to a plain-twin solve's
   (1e-5); then 60 fixed sweeps of the MAF window chain at n = 6 (K3-MAF),
   which no solve dispatches;
8. odd I: sor2sma and sor2sma_maf at 125^3 on K4's red-black form, the
   plain twin's iteration count and field;
9. the line solvers (slice 5), each with the counts zeroed just before
   and read just after: at 128^3 f32 pcr_rb (K5; the f32 oracle's 1356
   +-2%), pcr_rb_maf (K5-MAF; 1355) and pcr_j_esa at omega 1.0 (K6
   line_j; 4230), histories to rtol 1e-3 (pcr_rb_maf's and pcr_j_esa's
   against the oracle with float64 sums of dp^2, tests/torch_ref_histories)
   and Error max to the float64 oracle's (rtol 1e-2); 60 fixed sweeps of K6's MAF
   line-Jacobi, which no solver name dispatches; f64 pcr_rb at 64^3 (459
   +-1%, rtol 1e-6); odd I at 125^3, pcr_rb on K6's red-black form (the
   plain twin's count and field) and pcr_rb_maf (its MAF form);
10. float64 stretched grids (Problem.manufactured_stretched) at 24^3 and
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
12. times each step and its plain twin at 128^3 and 512^3 (sor2sma on the
    n = 6 chain, jacobi on K4, sor2sma_maf on the MAF pair, the MAF chain
    at n = 6, pcr_rb on K5, pcr_rb_maf on K5-MAF, pcr_j_esa on K6; CUDA
    events, distinct random starts, long-minus-short differencing), and
    every kernel per call against its twin at 128^3, and K5's and K6's
    also at 512^3 (the ``_512`` keys of their rows);
13. the distributed kernels against their twins: one block at a time at
    nonzero offsets, K7 (dist_rb_sweeps) on the (2, 2, 2) blocks of 128^3
    at n = 2, 6 and the one-iteration form n = 1 on the depth-12 ring,
    K7-MAF at n = 2 and 3, K8 (block_sweep: its launch over one block) in
    every variant with and without b, and a (2, 1, 1) mesh ragged in J;
    then K8 over all eight blocks of 128^3 in one launch (sweep_blocks),
    every variant, the face exchange (one launch, and gather then scatter)
    and the residual fold (dist_halo.py); float32 bitwise, float64 within
    1e-14, residuals to rtol 1e-5, the fold to 1e-15;
14. solve_dist with eight blocks on the card (``make_mesh(..., devices=
    ["cuda:0"] * 8)``), each path with the counts zeroed just before and
    read just after: at 128^3 f32 sor2sma pack (the serial count exactly,
    history to rtol 1e-5, the field at the stop bit for bit), sor2sma_maf
    pack (the same), sor2sma 'color' (the serial count), jacobi at omega
    0.8 (the serial count), 'overlap' (the 'color' field bit for bit), each
    with its K8/K9 step launches an iteration, 60 fixed sweeps of 'iter'
    against its twin (bitwise; 60 launches each of K8, exchange and fold);
    512^3 f32 sor2sma pack (the serial 512^3 count and field);
15. times the distributed steps per iteration at 128^3 (pack, 'color',
    'overlap', jacobi, with the device time, device launches and busy
    share an iteration under torch.profiler) and 512^3 (pack, 'color')
    over (2, 2, 2) beside the serial n = 6 chain, K7 per call on a 64^3
    block, and K8, the exchange and the fold per launch over the eight
    blocks, against their twins;
16. K9 (block_pcr, its launch over one block) against its twin in every
    variant, 'pcr' and 'fastdiag', constant and MAF, colours 0, 1 and the
    line-Jacobi pass, zero and streamed b, on the 64^3 blocks of 128^3 over
    (2, 2, 2) and a (128, 64, 64) block over (1, 2, 2); K9 over all the
    blocks of each mesh in one launch (pcr_blocks: 'pcr' on the eight,
    'fastdiag' on the four), every variant; K10 (fused_pcr) at 128^3 in
    every variant; float32 bitwise, float64 within 1e-14;
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
    fixed sweeps, within 1e-4 of K5/K6's;
18. times the dist line steps per iteration at 128^3 over (2, 2, 2) and
    (1, 2, 2) (with the device time, device launches and busy share an
    iteration) and at 512^3 over (2, 2, 2), K9 per launch over all the
    blocks of the path's meshes and K10 per call at 128^3, against their
    twins.

The line before the last is a JSON object with one entry per kernel
variant (its bound: the larger of the bytes it must move over 3.35 TB/s
and its operations over 67 TFLOP/s, float32 outside the tensor cores); the
last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
ERR_RTOL = 1e-2
OMEGA = 1.5
OMEGA_J = 0.8
OMEGA_L = 1.0  # pcr_j_esa: line-Jacobi diverges above about 1.0
SEED = 20261016
RAGGED = (37, 22, 45)  # (K, I, J)
# the line tile's edges (csrc/line_tile.cuh; 32 lines and 4 thread rows a
# tile at these K): 2 and 3 inner rows, odd I (K6's red-black form), line
# counts that are no multiple of 32, K - 2 no multiple of 4
LINE_EDGES = ((4, 22, 45), (5, 21, 37), (39, 9, 70), (130, 14, 97))
# the card's published peaks (NVIDIA H100 SXM data sheet), for the bounds
HBM_BYTES_S = 3.35e12
F32_FLOPS_S = 67e12


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
    from cubez_tpu_torch.cuda_kernels import dist_pcr as k9
    from cubez_tpu_torch.cuda_kernels import dist_rbpack as k7
    from cubez_tpu_torch.cuda_kernels import dist_sweeps as k8
    from cubez_tpu_torch.cuda_kernels import pcr as k10
    from cubez_tpu_torch.cuda_kernels import lines as k6
    from cubez_tpu_torch.cuda_kernels import rblines as k5
    from cubez_tpu_torch.cuda_kernels import rbpack as rb
    from cubez_tpu_torch.cuda_kernels import sweeps as k4
    from cubez_tpu_torch.ops.pcr import num_stage
    from cubez_tpu_torch.parallel import dist_fused, dist_pack
    from cubez_tpu_torch.solvers.driver import fixed_sweeps
    from cubez_tpu_torch.solvers.fused_cache import get_fused_step

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    f32, f64 = torch.float32, torch.float64
    t_start = time.perf_counter()

    # each wrapper counts its launches, and separately its MAF launches; a
    # kernel variant is a wrapper's constant or MAF form
    wrappers = {"rb_color": rb.rb_color, "rb_sweeps_n": rb.rb_sweeps_n,
                "k4_jacobi": k4.jacobi_k4, "k4_rb_color": k4.sor2sma_k4,
                "rbl": k5.rbl, "line_j": k6.line_j, "line_rb": k6.line_rb,
                "dist_rb_sweeps": k7.dist_rb_sweeps, "fused_pcr": k10.fused_pcr}
    k9_variants = ("block_pcr", "block_pcr_maf", "block_pcr_fastdiag",
                   "block_pcr_fastdiag_maf")

    def zero_counts():
        for w in wrappers.values():
            w.launches = w.maf_launches = 0
        # K8 and K9 count their launches by variant too
        for w in (k8.block_sweep, k9.block_pcr):
            w.launches = 0
            w.variant_launches = {}
        dist_halo.halo_exchange.launches = dist_halo.fold_partials.launches = 0

    def read_counts():
        out = {}
        for name, w in wrappers.items():
            out[name] = w.launches - w.maf_launches
            out[name + "_maf"] = w.maf_launches
        for v in ("jacobi", "colour", "both", "interior", "shell"):
            out["block_sweep_" + v] = k8.block_sweep.variant_launches.get(v, 0)
        for v in k9_variants:
            out[v] = k9.block_pcr.variant_launches.get(v, 0)
        out["halo_exchange"] = dist_halo.halo_exchange.launches
        out["fold_partials"] = dist_halo.fold_partials.launches
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

    def unpacked(kind, bz):
        return lambda sh, dt, off, mc, pl: k4.make_fused_sweep(
            kind, sh, dt, omega=OMEGA if kind == "sor2sma" else OMEGA_J,
            offset=off, b_is_zero=bz, mc=mc, plain=pl)

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
        ("single b=0", "rb_color", const_shapes, False,
         packed(rb.make_packed_sweep, b_is_zero=True)),
        ("single b", "rb_color", const_shapes, False,
         packed(rb.make_packed_sweep, b_is_zero=False)),
        ("pair b", "rb_sweeps_n", const_shapes, False,
         packed(rb.make_packed_sweep2x, b_is_zero=False)),
    ] + [
        (f"n={n}", "rb_sweeps_n", const_shapes, False,
         packed(rb.make_packed_sweepnx, n=n))
        for n in (3, 4, 6)
    ] + [
        ("MAF single b=0", "rb_color_maf", new_shapes, True,
         packed(rb.make_packed_sweep, b_is_zero=True)),
        ("MAF single b", "rb_color_maf", new_shapes, True,
         packed(rb.make_packed_sweep, b_is_zero=False)),
        ("MAF pair b=0", "rb_sweeps_n_maf", new_shapes, True,
         packed(rb.make_packed_sweep2x, b_is_zero=True)),
        ("MAF pair b", "rb_sweeps_n_maf", new_shapes, True,
         packed(rb.make_packed_sweep2x, b_is_zero=False)),
    ] + [
        (f"MAF n={n}", "rb_sweeps_n_maf_chain", new_shapes, True,
         packed(rb.make_packed_sweepnx, n=n))
        for n in (3, 6)
    ] + [
        (f"K4 {kind}{' MAF' if maf else ''} b={'0' if bz else 'b'}",
         f"k4_{'jacobi' if kind == 'jacobi' else 'rb_color'}"
         f"{'_maf' if maf else ''}", new_shapes, maf, unpacked(kind, bz))
        for kind in k4.KINDS for maf in (False, True) for bz in (True, False)
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
    launches = {k: counts[k] for k in ("rb_color", "rb_sweeps_n")}
    path_launches.update(launches)
    ref = load_history("f32_sor2sma_128_w1.5.txt")
    check(res.x.shape == (128, 128, 128) and bool(torch.isfinite(res.x).all()),
          "main path: field of the wrong shape or not finite")
    check(1777 <= res.iters <= 1849, f"main path: {res.iters} iterations")
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
    print(f"main path 128^3 f32: {res.iters} iterations (f32 oracle "
          f"{len(ref)}), res {res.res:e}, history rtol {worst:.2e}, "
          f"wall {wall:.3f} s, launches {launches}, Error max {err_k:e} at "
          f"{loc_k} (plain twin: {err_p:e} at {loc_p}) {tag}", flush=True)

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
    t0 = time.perf_counter()
    res512 = solve(prob512, "sor2sma", omega=OMEGA, itr_max=20000)
    sync()
    wall512 = time.perf_counter() - t0
    check(bool(torch.isfinite(res512.x).all()), "512^3: field not finite")
    check(abs(res512.iters - 5781) <= 5781 * 2 // 100,
          f"512^3: {res512.iters} iterations vs the f64 oracle's 5781")
    print(f"512^3 f32: {res512.iters} iterations (f64 oracle 5781), "
          f"res {res512.res:e}, wall {wall512:.3f} s {tag}", flush=True)
    # phase 14 holds the distributed 512^3 solve to this count and field
    iters512, x512 = res512.iters, res512.x
    del prob512, res512

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
         ("rb_sweeps_n_maf", "rb_color_maf"), None),
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
        print(f"{name} 128^3 f32 omega {omega}: {r.iters} iterations (f32 "
              f"oracle {len(load_history(oracle))}), res {r.res:e}, history "
              f"rtol {worst:.2e} (vs {curve or oracle}), "
              f"wall {wall:.3f} s, launches {cnt}, Error max {ek:e} at {lk} "
              f"(plain twin: {ep:e} at {lp}) {tag}", flush=True)

    # The MAF window chain (K3-MAF) is not on the dispatch, as in the JAX
    # package: drive its builder through fixed sweeps, counts zeroed first.
    p = Problem.poisson_cube(128, dtype=torch.float32, device="cuda", maf=True)
    chain = rb.make_packed_sweepnx(p.grid.shape_kij, f32, omega=OMEGA, n=6,
                                   mc=p.mc)
    sync()
    zero_counts()
    xc = chain.unpad(fixed_sweeps(chain, chain.pad(p.x0), None, 60))
    sync()
    path_launches["rb_sweeps_n_maf_chain"] = read_counts()["rb_sweeps_n_maf"]
    check(path_launches["rb_sweeps_n_maf_chain"] == 10,
          f"MAF chain: {path_launches['rb_sweeps_n_maf_chain']} launches")
    check(bool(torch.isfinite(xc).all()), "MAF chain: field not finite")
    print(f"MAF chain n=6 128^3 f32: 60 fixed sweeps in "
          f"{path_launches['rb_sweeps_n_maf_chain']} launches {tag}", flush=True)
    del p, chain, xc

    # ---- 8. odd I on K4 ----------------------------------------------------------
    stamp(8)
    for name, variant in (("sor2sma", "k4_rb_color"),
                          ("sor2sma_maf", "k4_rb_color_maf")):
        p, r, rp, wall, cnt = drive(name, OMEGA, 125, (variant,))
        check(torch.equal(r.x, rp.x), f"{name} 125^3: field != plain twin's")
        print(f"{name} 125^3 f32 (odd I, K4): {r.iters} iterations, res "
              f"{r.res:e}, wall {wall:.3f} s, launches {cnt}, field bitwise "
              f"equal to the plain twin's {tag}", flush=True)

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
        ("sor2sma_maf (MAF pair)", "sor2sma", True, None,
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
    calls = {
        "rb_color": (lambda: rb.rb_color(xs, None, 0, OMEGA),
                     lambda: rb.rb_color_plain(xs, None, 0, OMEGA)),
        "rb_color_maf": (lambda: rb.rb_color(xs, None, 0, OMEGA, tab=tab),
                         lambda: rb.rb_color_plain(xs, None, 0, OMEGA, tab=tab)),
        "rb_sweeps_n": (lambda: rb.rb_sweeps_n(xs, None, 6, OMEGA),
                        lambda: rb.packed_sweeps_plain(xs, None, 6, OMEGA)),
        "rb_sweeps_n_maf": (
            lambda: rb.rb_sweeps_n(xs, bs, 2, OMEGA, tab=tab),
            lambda: rb.packed_sweeps_plain(xs, bs, 2, OMEGA, tab=tab)),
        "rb_sweeps_n_maf_chain": (
            lambda: rb.rb_sweeps_n(xs, None, 6, OMEGA, tab=tab),
            lambda: rb.packed_sweeps_plain(xs, None, 6, OMEGA, tab=tab)),
        "k4_jacobi": (lambda: k4.jacobi_k4(xu, None, OMEGA_J),
                      lambda: k4.jacobi_plain(xu, None, OMEGA_J)),
        "k4_jacobi_maf": (lambda: k4.jacobi_k4(xu, None, OMEGA_J, tab),
                          lambda: k4.jacobi_plain(xu, None, OMEGA_J, tab)),
        "k4_rb_color": (lambda: k4.sor2sma_k4(xu, None, OMEGA),
                        lambda: k4.sor2sma_plain(xu, None, OMEGA)),
        "k4_rb_color_maf": (lambda: k4.sor2sma_k4(xu, None, OMEGA, tab=tab),
                            lambda: k4.sor2sma_plain(xu, None, OMEGA, tab=tab)),
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
    # K5 and K6 at 512^3 too, where the bytes bound them: the same calls,
    # kernel against twin in turns (the twins loop over k in Python: one
    # call each side)
    sh5 = (512, 512, 512)
    xl5 = k5.pack_rb_lines(torch.rand(sh5, device=dev, generator=dgen) * 2 - 1)
    xu5 = torch.rand(sh5, device=dev, generator=dgen) * 2 - 1
    out5 = torch.empty_like(xu5)
    tab5 = rb.maf_tables(Problem.poisson_cube(512, device=dev, maf=True).mc,
                         sh5, f32)
    calls512 = {
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
    del xl5, xu5, out5, tab5, calls512

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
        "rb_color": (1.5 * fb, 11 * inner / 2),
        "rb_color_maf": (1.5 * fb, 20 * inner / 2),
        "rb_sweeps_n": (2 * fb, 6 * 11 * inner),
        "rb_sweeps_n_maf": (3 * fb, 2 * 21 * inner),
        "rb_sweeps_n_maf_chain": (2 * fb, 6 * 20 * inner),
        "k4_jacobi": (2 * fb, 11 * inner),
        "k4_jacobi_maf": (2 * fb, 20 * inner),
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
    print(f"distributed kernels vs plain twins: {n_cmp} comparisons passed "
          f"(f32 bitwise, f64 <= 1e-14); max |field diff| "
          + ", ".join(f"{k} {v:.3e}" for k, v in sorted(err.items())
                      if k.startswith(("dist", "block", "halo", "fold"))),
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
    for name, variant in (("sor2sma", "dist_rb_sweeps"),
                          ("sor2sma_maf", "dist_rb_sweeps_maf")):
        p = Problem.poisson_cube(128, device=dev, maf=name.endswith("_maf"))
        s_ = solve(p, name, omega=OMEGA, itr_max=10000)
        r, wall, cnt = drive_dist(name, OMEGA, p, cm128, "pack", (variant,))
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
                              ("dist_rb_sweeps",))
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
        us = n_ev = 0
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            t = getattr(ev, "self_device_time_total", None)
            t = ev.self_cuda_time_total if t is None else t
            if t > 0:
                us += t
                n_ev += ev.count
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

    # K7 per call on a 64^3 block of 128^3 over (2, 2, 2) (origin (64, 64,
    # 64)); K8, the exchange and the fold per launch over all eight blocks;
    # each against its twin in turns
    bsz, gsz, origin = (64, 64, 64), (128, 128, 128), (64, 64, 64)
    mc = Problem.poisson_cube(128, device=dev, maf=True).mc
    k7c = k7.make_dist_packed_sweepnx(bsz, gsz, omega=OMEGA, n=6)
    k7p = k7.make_dist_packed_sweepnx(bsz, gsz, omega=OMEGA, n=6, plain=True)
    k7m = k7.make_dist_packed_sweepnx(bsz, gsz, omega=OMEGA, n=2, mc=mc)
    k7mp = k7.make_dist_packed_sweepnx(bsz, gsz, omega=OMEGA, n=2, mc=mc,
                                       plain=True)
    tab7 = k7m.block_tables(origin, dev)
    e7, e7m = k7.ext_dims(bsz, k7c.hs), k7.ext_dims(bsz, k7m.hs)
    x7 = rand((2, e7[0], e7[3], e7[2]), f32).to(dev)
    x7m = rand((2, e7m[0], e7m[3], e7m[2]), f32).to(dev)
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
        "dist_rb_sweeps": (lambda: k7c(x7, origin), lambda: k7p(x7, origin)),
        "dist_rb_sweeps_maf": (lambda: k7m(x7m, origin, tab7),
                               lambda: k7mp(x7m, origin, tab7)),
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
        what = ("a 64^3 block of 128^3 (2, 2, 2)" if name.startswith("dist_rb")
                else "the eight 64^3 blocks of 128^3 (2, 2, 2) in one launch")
        print(f"per call on {what}, f32: {name} {per_call[name][0]:.4f} ms, plain "
              f"twin {per_call[name][1]:.4f} ms"
              + ("" if lib_ms is None else f", library {lib_ms:.4f} ms") + f" {tag}")
    check(all(bool(torch.isfinite(t).all()) for t in [x7, x7m] + x8),
          "dist timing fields not finite")
    # their least work: K7 reads and writes the extended block once, n
    # iterations over its interior; K8 reads the eight ghosted blocks and
    # writes what it updates (the shell pass: the shell, the ghost planes
    # and the layer inside); the exchange reads and writes the 24 faces that
    # have a neighbour; the fold reads its partials
    gb = 8 * 4 * 66**3
    shell = 64**3 - 62**3
    work.update({
        "dist_rb_sweeps": (2 * 4 * e7[0] * e7[1] * e7[2],
                           6 * 11 * (e7[0] - 2) * (e7[1] - 2) * (e7[2] - 2)),
        "dist_rb_sweeps_maf": (2 * 4 * e7m[0] * e7m[1] * e7m[2],
                               2 * 20 * (e7m[0] - 2) * (e7m[1] - 2) * (e7m[2] - 2)),
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
    # twin: the 'pcr' form on the eight blocks of (2, 2, 2), the 'fastdiag'
    # form on the four of (1, 2, 2)
    for div, form in (((2, 2, 2), "pcr"), ((1, 2, 2), "fastdiag")):
        gsz = (128, 128, 128)
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
                        where = (f"K9 {len(orgs)} blocks {form} maf={maf} "
                                 f"colour={colour} b={bb is not None} {dtype}")
                        check(all(bool(torch.isfinite(g).all()) for g in got),
                              f"non-finite field: {where}")
                        check(e <= tol, f"field differs by {e}: {where}")
                        check(rel <= 1e-5, f"residual differs by rtol {rel}: {where}")
                        n_cmp += 1
        del cmk, xs, bbs, got, want
    sh = (128, 128, 128)
    for dtype in (f32, f64):
        tol = 0.0 if dtype == f32 else 1e-14
        mc = stretched_mc(sh, dtype)
        x, b = rand(sh, dtype).to(dev), rand(sh, dtype).to(dev)
        for maf in (False, True):
            tab = rb.maf_tables(mc, sh, dtype) if maf else None
            for colour in (0, 1, None):
                for bb in (None, b):
                    xk, rk = k10.fused_pcr(x.clone(), bb, OMEGA, colour, 1, tab)
                    xp, rp = k10.fused_pcr_plain(x.clone(), bb, OMEGA, colour, 1,
                                                 tab)
                    sync()
                    name = "fused_pcr" + ("_maf" if maf else "")
                    e = float((xk - xp).abs().max())
                    err[name] = max(err.get(name, 0.0), e)
                    rel = float((rk - rp).abs() / rp.abs())
                    where = (f"K10 maf={maf} colour={colour} b={bb is not None} "
                             f"{dtype}")
                    check(torch.isfinite(xk).all(), f"non-finite field: {where}")
                    check(e <= tol, f"field differs by {e}: {where}")
                    check(rel <= 1e-5, f"residual differs by rtol {rel}: {where}")
                    n_cmp += 1
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
            check(got == (120 if kind == "pcr_rb" else 60),
                  f"K10 {kind} maf={maf}: {got} launches")
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
            scr = [k9.make_scratch(x.shape, f32, dev, form, 0, maf) for x in xb]

            def call(plain, xb=xb, tabs=tabs, scr=scr, orgs=orgs, form=form):
                # one launcher, as a step keeps it: its arguments built once
                launch = k9.BlockPcr(form, 0, OMEGA, orgs, gsz, 0, tabs, scr)

                def run():
                    res9.start()
                    launch(xb, None, None, res9, plain)
                    return res9.total()
                return run

            k9calls[k9.variant(form, maf)] = (call(False), call(True))
    x10 = rand(sh, f32).to(dev)
    tab10 = rb.maf_tables(mc, sh, f32)
    k9calls["fused_pcr"] = (lambda: k10.fused_pcr(x10, None, OMEGA, 0),
                            lambda: k10.fused_pcr_plain(x10, None, OMEGA, 0))
    k9calls["fused_pcr_maf"] = (
        lambda: k10.fused_pcr(x10, None, OMEGA, 0, tab=tab10),
        lambda: k10.fused_pcr_plain(x10, None, OMEGA, 0, tab=tab10))
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
    # their least work, colour 0 (half the lines) with b zero, over the rows
    # a pass updates (every inner point of 128^3 sits in one block's line,
    # so half of 126^3 rows on either mesh):
    # bytes, the blocks read once and the updated cells written once;
    # operations, those of the CUDA bodies per updated row: the system (4
    # constant, 15 MAF), each PCR stage (16 variable, pcr.cuh's
    # pcr_solve_var; 5 on K10's tables, pcr_solve_tab), the final pair (6
    # variable, 3 tables) and the relaxation with its dp^2 (5); K10's end
    # folds add 4 a line; a Thomas line relaxation 14 (24 under MAF) a row,
    # as K5/K6
    pn9, pn10 = num_stage(64 + 2), num_stage(126)
    blk, rows9 = 8 * 66**3, 126**3 / 2
    fd_blk, fd_rows = 4 * 130 * 66 * 66, 126**3 / 2
    lines10 = 126 * 126 / 2
    var9 = 16 * (pn9 - 1) + 6 + 5
    var10, tab10_ops = 16 * (pn10 - 1) + 6 + 5, 5 * (pn10 - 1) + 3 + 5
    work.update({
        "block_pcr": (4 * (blk + rows9), (4 + var9) * rows9),
        "block_pcr_maf": (4 * (blk + rows9), (15 + var9) * rows9),
        "block_pcr_fastdiag": (4 * (fd_blk + fd_rows), 14 * fd_rows),
        "block_pcr_fastdiag_maf": (4 * (fd_blk + fd_rows), 24 * fd_rows),
        "fused_pcr": (4 * (128**3 + inner / 2),
                      (4 + tab10_ops) * inner / 2 + 4 * lines10),
        "fused_pcr_maf": (4 * (128**3 + inner / 2),
                          (15 + var10) * inner / 2 + 4 * lines10),
    })

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
    meta = {
        "rb_color": (rbpack_cu, "cubez_tpu/pallas_kernels/rbpack.py:732"),
        "rb_color_maf": (rbpack_cu, "cubez_tpu/pallas_kernels/rbpack.py:732"),
        "rb_sweeps_n": (rbpack_cu, "cubez_tpu/pallas_kernels/sweeps2x.py:480"),
        "rb_sweeps_n_maf": (rbpack_cu,
                            "cubez_tpu/pallas_kernels/sweeps2x.py:552"),
        "rb_sweeps_n_maf_chain": (rbpack_cu,
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
    }
    for name in meta:
        check(path_launches.get(name, 0) > 0, f"{name}: no path launched it")
    kernels = []
    fb5, inner5 = 4 * 512**3, 510**3
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
        if name in per_call_512:
            # the same least work at 512^3: 2 fields, the row's operations
            flops = work[name][1] / inner * inner5
            kernels[-1].update({"ms_512": per_call_512[name][0],
                                "plain_ms_512": per_call_512[name][1],
                                "bound_ms_512": bound(2 * fb5, flops)[0]})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
