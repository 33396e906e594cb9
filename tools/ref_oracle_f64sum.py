#!/usr/bin/env python3
"""Variant of ``tools/ref_oracle.cpp`` whose jacobi and jacobi_maf sweeps
sum dp^2 in float64 (each float32 product rounded once, then added in
double), and the float32 histories it writes.

The reference's Jacobi sweeps keep their sum of dp^2 in one REAL
(cz_solver.f90:284-387, cz_maf.f90:131-282), so at 128^3 the float32
oracle adds two million terms into one float.  The PyTorch port's K4
kernel sums each (k, i) row in float32 and folds the rows in float64, so
its history follows the float64 sum, not the float one.  This script
derives the variant from the oracle's source (two line edits in each of
the two sweeps, checked to apply exactly), builds it with g++ and writes:

    python3 tools/ref_oracle_f64sum.py [--out tests/torch_ref_histories]

    f32_jacobi_128_w0.8_f64sum.txt
    f32_jacobi_maf_128_w0.8_f64sum.txt

Each run is serial and takes about two minutes on one CPU core.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "tools" / "ref_oracle.cpp"
SWEEPS = ("jacobi_sweep", "jacobi_maf_sweep")
RUNS = (("jacobi", 128, "0.8"), ("jacobi_maf", 128, "0.8"))


def variant_source(src: str) -> str:
    """The oracle's source with the float64 sum in the two Jacobi sweeps."""
    for name in SWEEPS:
        m = re.search(r"\ndouble " + name + r"\(.*?\n}\n", src, re.S)
        if m is None:
            raise RuntimeError(f"{name} not found in {SOURCE}")
        body = m.group(0)
        new = body.replace("  Real res1 = 0;", "  double res1 = 0;")
        new = new.replace("res1 += dp * dp;",
                          "res1 += static_cast<double>(dp * dp);")
        if new.count("double res1") != 1 or new.count("static_cast<double>(dp") != 1:
            raise RuntimeError(f"{name}: the accumulator edits did not apply")
        src = src.replace(body, new)
    return src


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=ROOT / "tests" / "torch_ref_histories")
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        cpp, exe = Path(tmp) / "ref_oracle_f64sum.cpp", Path(tmp) / "ref_oracle_f64sum"
        cpp.write_text(variant_source(SOURCE.read_text()))
        # the flags of tests/ref_histories/README.md
        subprocess.run(["g++", "-O2", "-std=c++17", "-o", str(exe), str(cpp)], check=True)
        for solver, n, omega in RUNS:
            out = args.out / f"f32_{solver}_{n}_w{omega}_f64sum.txt"
            subprocess.run([str(exe), str(n), solver, "10000", omega, "--out", str(out)],
                           check=True)
            print(f"wrote {out}")


if __name__ == "__main__":
    main()
