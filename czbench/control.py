"""The control of a cell's check: the plain reference in the next lower
precision than the configuration states (float32 for float64, bfloat16 for
float32), put in the program's place, on as many starts of each seed as
a run checks (solves 0 .. sample).  The check has to find it not correct.

    python3 czbench/control.py --workload sor2sma-124 --seeds 11 12 13

Prints one JSON line a seed: the control's worst numbers beside the cell's
limits, and whether the check passes it (it must not).
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

from czb import check, spec  # noqa: E402
from czb.inputs import DTYPES, Inputs  # noqa: E402

LOWER = {"float64": "float32", "float32": "bfloat16"}


def control_readings(cell, seed: int, device, n=None) -> list:
    """The gaps of the control against the reference on the starts of
    ``seed``'s solves 0 .. sample."""
    cfg = cell.config
    inputs = Inputs(n or cell.traffic["n"], DTYPES[cfg["dtype"]], device, seed)
    out = []
    for index in range(cell.check["sample"] + 1):
        x0 = inputs.start(index)
        ref = check.reference_solve(cfg, x0, inputs.rhs)
        c_iters, c_hist, c_x = check.reference_solve(
            cfg, x0, inputs.rhs, dtype=LOWER[cfg["dtype"]])
        out.append(check.readings(cfg, c_iters, c_hist, c_x, inputs.rhs, ref))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("czbench control: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.load(args.workload)
    for seed in args.seeds:
        worst = check.worst(control_readings(cell, seed, "cuda"))
        ok, checks = check.judge(worst, cell.check["limits"])
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control_passes": ok, "checks": checks}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
