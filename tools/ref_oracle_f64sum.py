#!/usr/bin/env python3
"""Variant of ``tools/ref_oracle.cpp`` whose jacobi, jacobi_maf, pcr_j_esa,
pcr_rb_maf, psor, psor_maf, pcr and pcr_maf sweeps sum dp^2 in float64
(each float32 product rounded once, then added in double), and the float32
histories it writes.

The reference keeps the sum of dp^2 of these sweeps in one REAL
(cz_solver.f90:207-387 and 1473-1676, cz_maf.f90:23-282 and 442-668), so
at 128^3 the float32 oracle adds two million terms into one float.  The
PyTorch port's kernels sum a row or a line in float32 and fold those
partials in float64, so its histories follow the float64 sum, not the
float one.  This script derives the variant from the oracle's source
(two line edits in each of the four places, each checked to apply
exactly once), builds it with g++ and writes:

    python3 tools/ref_oracle_f64sum.py [--out tests/torch_ref_histories] [solver ...]

    f32_jacobi_128_w0.8_f64sum.txt
    f32_jacobi_maf_128_w0.8_f64sum.txt
    f32_pcr_j_esa_128_w1.0_f64sum.txt
    f32_pcr_rb_maf_128_w1.5_f64sum.txt
    f32_psor_128_w1.1_f64sum.txt
    f32_psor_maf_128_w1.1_f64sum.txt
    f32_pcr_128_w1.5_f64sum.txt
    f32_pcr_maf_128_w1.5_f64sum.txt

(the named solvers' runs only, when solvers are given).  The edits:

* ``jacobi_sweep``, ``jacobi_maf_sweep``, ``psor_sweep`` and
  ``psor_maf_sweep``: the whole sweep;
* ``line_sweep``: its JACOBI (pcr_j_esa) and GS (pcr) branches; the RB
  branch (pcr_rb) already sums in double;
* ``line_sweep_maf``: its accumulator is declared once for both branches,
  RB (pcr_rb_maf) and GS (pcr_maf), so the declaration becomes double for
  both (the GS branch then adds its float product to a double) and the RB
  branch's addition is made explicit.

The runs are independent serial processes, started together; the longest
(pcr_j_esa, 4230 line-Jacobi iterations at 128^3) takes a few minutes on
one CPU core.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "tools" / "ref_oracle.cpp"
RUNS = (("jacobi", 128, "0.8"), ("jacobi_maf", 128, "0.8"),
        ("pcr_j_esa", 128, "1.0"), ("pcr_rb_maf", 128, "1.5"),
        ("psor", 128, "1.1"), ("psor_maf", 128, "1.1"),
        ("pcr", 128, "1.5"), ("pcr_maf", 128, "1.5"))
DECL, DECL64 = "Real res1 = 0;", "double res1 = 0;"
ADD, ADD64 = "res1 += dp * dp;", "res1 += static_cast<double>(dp * dp);"


def _function(src: str, name: str) -> str:
    m = re.search(r"\ndouble " + name + r"\(.*?\n}\n", src, re.S)
    if m is None:
        raise RuntimeError(f"{name} not found in {SOURCE}")
    return m.group(0)


def _between(text: str, start: str, end: str | None) -> str:
    """The part of ``text`` from ``start`` up to ``end`` (or its end)."""
    if text.count(start) != 1 or (end is not None and text.count(end) != 1):
        raise RuntimeError(f"markers {start!r} / {end!r} are not unique")
    i = text.index(start)
    return text[i:] if end is None else text[i:text.index(end)]


def _edit(text: str, part: str, edits) -> str:
    """``text`` with ``part`` rewritten by ``edits`` (old, new) pairs, each
    required to apply exactly once."""
    new = part
    for old, rep in edits:
        if new.count(old) != 1:
            raise RuntimeError(f"{old!r} occurs {new.count(old)} times in:\n{part}")
        new = new.replace(old, rep)
    if text.count(part) != 1:
        raise RuntimeError("the part to edit is not unique")
    return text.replace(part, new)


def variant_source(src: str) -> str:
    """The oracle's source with the float64 sums described above."""
    for name in ("jacobi_sweep", "jacobi_maf_sweep", "psor_sweep",
                 "psor_maf_sweep"):
        body = _function(src, name)
        src = _edit(src, body, ((DECL, DECL64), (ADD, ADD64)))
    body = _function(src, "line_sweep")
    jac = _between(body, "if (mode == LineMode::JACOBI) {",
                   "if (mode == LineMode::GS) {")
    src = _edit(src, jac, ((DECL, DECL64), (ADD, ADD64)))
    body = _function(src, "line_sweep")
    gs = _between(body, "if (mode == LineMode::GS) {", "// RB: two colors")
    src = _edit(src, gs, ((DECL, DECL64), (ADD, ADD64)))
    body = _function(src, "line_sweep_maf")
    src = _edit(src, body, ((DECL, DECL64),))
    body = _function(src, "line_sweep_maf")
    rb = _between(body, "for (int color = 0; color < 2; ++color)", None)
    return _edit(src, rb, ((ADD, ADD64),))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=ROOT / "tests" / "torch_ref_histories")
    ap.add_argument("solvers", nargs="*", help="the runs to make (default: all)")
    args = ap.parse_args()
    unknown = set(args.solvers) - {r[0] for r in RUNS}
    if unknown:
        ap.error(f"no run for {sorted(unknown)}")
    args.out.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        cpp, exe = Path(tmp) / "ref_oracle_f64sum.cpp", Path(tmp) / "ref_oracle_f64sum"
        cpp.write_text(variant_source(SOURCE.read_text()))
        # the flags of tests/ref_histories/README.md
        subprocess.run(["g++", "-O2", "-std=c++17", "-o", str(exe), str(cpp)], check=True)
        procs = []
        for solver, n, omega in RUNS:
            if args.solvers and solver not in args.solvers:
                continue
            out = args.out / f"f32_{solver}_{n}_w{omega}_f64sum.txt"
            procs.append((out, subprocess.Popen(
                [str(exe), str(n), solver, "10000", omega, "--out", str(out)])))
        for out, proc in procs:
            if proc.wait() != 0:
                raise SystemExit(f"the oracle failed writing {out}")
            print(f"wrote {out}")


if __name__ == "__main__":
    main()
