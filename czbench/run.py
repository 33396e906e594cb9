"""One run of one cell of the benchmark of cubez_tpu_torch.

    python3 czbench/run.py --workload sor2sma-124 --seed 7 --seconds 50 --trace 0

Set-up (timed as ``setup_s`` from the first line of this file): import
torch and the program, load the program's kernels (built into
cubez_tpu_torch/_build/ inside the checkout by the first run there), make
the cell's ``Problem`` on the card and warm its shapes with the
configuration's short warm-up solves.  Then the window: converged solves back to back from seeded
starts (czb/window.py).  Once it has closed, the sampled solves are held
against the plain reference (czb/check.py), the metrics of the cell are
read by their files under metrics/, and the last line of standard output
is the result, a JSON object; the numbers compared, each beside its limit,
are the last lines of standard error.

Exits 3 without a result where torch sees no CUDA device or fewer than the
cell's chips, and 4 where a module of JAX or of the JAX package has been
loaded into this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))  # the checkout: the program's package
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import torch  # noqa: E402

T_TORCH = time.perf_counter()

from czb import cell as cell_mod, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load(args.workload)
    import cubez_tpu_torch  # noqa: F401  the program: a checkout without it fails here
    marks = [("torch", T_TORCH), ("program", time.perf_counter())]
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < cell.chips:
        print(f"czbench: {args.workload} needs {cell.chips} CUDA device(s), "
              f"torch sees {seen}", file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    out = cell_mod.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            t_start=T_START, marks=marks)
    found = cell_mod.forbidden_modules()
    if found:
        print(f"czbench: modules loaded that a run may not load: {found}",
              file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
