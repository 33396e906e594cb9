"""What a run reads: the cell's entry in BENCHMARK.json and the files it
names.  Everything that belongs to one configuration, traffic mix, cell or
metric is a file of its own, found by its name:

    configs/<config>.json     the solver's settings as run, and its work
    traffic/<traffic>.json    the grid and the starts of the solves
    workloads/<cell>.json     the cell's check: its sample and its limits
    metrics/<metric>.py       ``read(facts)``: the metric, or None
    reference/<solver>.py     the plain reference of a solver name
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # the benchmark's folder
ROOT = HERE.parent  # the checkout


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list
    per_layer: list
    here: Path = HERE

    def metrics(self, trace: bool) -> list:
        """The metric entries a run reports: the end-to-end ones, or with
        ``trace`` the per-layer ones."""
        return self.per_layer if trace else self.end_to_end


def load(workload: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    """The cell named ``workload`` in ``root``/BENCHMARK.json (KeyError if
    it has none), its files under ``here``."""
    spec = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    shown = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if workload in m.get("workloads", [])
             or ("workloads" not in m and m["moves"] in shown)]
    return Cell(
        name=workload, chips=int(w["chips"]), config=config,
        traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
        check=_json(here / "workloads" / f"{workload}.json"),
        end_to_end=e2e, per_layer=layer, here=here,
    )


def reader(metric: str, here: Path = HERE):
    """``read(facts)`` of metrics/<metric>.py."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "czbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference(solver: str):
    """The plain reference module of ``solver`` (reference/<solver>.py)."""
    return importlib.import_module(f"reference.{solver}")
