"""The harness on the CPU: a cell, configuration, traffic and metric added as
new files are found by name; the result line's keys; the whole-name import
check; the sample; and the exits without a card or without the program.

    JAX_PLATFORMS=cpu python -m pytest czbench/tests -q
"""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from czb import cell as cell_mod
from czb import spec, window

SEED = 2 ** 31 + 12345  # larger than 32 signed bits hold


def _copy(tmp_path):
    here = tmp_path / "czbench"
    shutil.copytree(spec.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return here


def test_new_cell_config_traffic_and_metric_are_files(tmp_path):
    here = _copy(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cfg = json.loads((here / "configs" / "sor2sma.json").read_text())
    cfg.update(name="sor2sma_w17", omega=1.7)
    (here / "configs" / "sor2sma_w17.json").write_text(json.dumps(cfg))
    (here / "traffic" / "cube14.json").write_text(json.dumps({"n": 14}))
    (here / "workloads" / "sor2sma_w17-14.json").write_text(json.dumps(
        {"sample": 1, "limits": {"iters_gap": 0, "hist_gap": 1e-3,
                                 "field_gap": 1e-4}}))
    (here / "metrics" / "solves_seen.py").write_text(
        "def read(facts):\n    return float(len(facts['solves']))\n")
    bench["configs"].append(dict(bench["configs"][0], name="sor2sma_w17",
                                 file="czbench/configs/sor2sma_w17.json"))
    bench["workloads"].append({"name": "sor2sma_w17-14", "config": "sor2sma_w17",
                               "traffic": "cube14", "chips": 1, "why": "test"})
    bench["per_layer"].append({
        "name": "solves_seen", "unit": "solve", "better": "higher",
        "source": "program_counter", "layer": "driver loop",
        "moves": "solve_ms", "workloads": ["sor2sma_w17-14"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load("sor2sma_w17-14", root=tmp_path, here=here)
    assert cell.config["omega"] == 1.7 and cell.traffic["n"] == 14
    names = [m["name"] for m in cell.per_layer]
    assert "solves_seen" in names and "kernels_roofline" not in names
    assert [m["name"] for m in cell.end_to_end] == ["solve_ms", "setup_s"]
    out = cell_mod.run_cell(cell, SEED, 0.2, True, device="cpu")
    assert out["correct"] is True
    assert out["metrics"]["solves_seen"]["value"] == out["attempted"]
    assert out["metrics"]["solves_seen"]["unit"] == "solve"


@pytest.mark.parametrize("trace", (False, True))
def test_result_line_keys(trace):
    cell = spec.load("sor2sma-124")
    out = cell_mod.run_cell(cell, SEED, 0.3, trace, device="cpu", n=16)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        # no device records on the CPU: the device metrics read nothing
        assert set(out["metrics"]) == {"iters_per_solve"}
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == {"solve_ms", "solve_p95_ms", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["checks"]) == {"iters_gap", "hist_gap", "field_gap"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert "cubez_tpu_torch" in sys.modules
    for name in ("cubez_tpu_torchx", "jaxfoo", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert cell_mod.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    monkeypatch.setitem(sys.modules, "cubez_tpu.ops.stencil", object())
    assert cell_mod.forbidden_modules() == ["cubez_tpu", "jaxlib"]


class _R:
    def __init__(self, iters, x=None):
        self.iters, self.x, self.res = iters, x, 0.5 ** iters
        self.history = torch.arange(iters, dtype=torch.float64)


def test_sample_is_seeded_and_holds_a_longest():
    def draw(seed):
        s = window.Sampler(2, seed)
        for i, it in enumerate([5, 7, 6, 7, 5, 6, 4, 6, 5, 5]):
            s.offer(i, _R(it))
        return [i for i, _ in s.sample()]

    a = draw(SEED)
    assert a == draw(SEED)
    assert len(a) in (2, 3) and ({1, 3} & set(a))
    assert len({tuple(draw(s)) for s in range(20)}) > 1


def test_sample_keeps_copies_in_fields_made_before():
    like = torch.zeros(3, 3, 3)
    s = window.Sampler(2, SEED, like=like)
    slots = [id(t) for t in s.slots]
    results = [_R(it, torch.full_like(like, float(i)))
               for i, it in enumerate([5, 7, 6, 7, 5, 6, 4, 6, 5, 5])]
    for i, r in enumerate(results):
        s.offer(i, r)
        r.x.fill_(-1.0)  # the program's field is reused after the offer
    got = s.sample()
    assert [i for i, _ in got] == [i for i, _ in draw_plain(SEED)]
    for i, h in got:
        assert id(h.x) in slots
        assert torch.equal(h.x, torch.full_like(like, float(i)))
        assert h.iters == results[i].iters and h.res == results[i].res
        assert torch.equal(h.history, results[i].history)


def draw_plain(seed):
    s = window.Sampler(2, seed)
    for i, it in enumerate([5, 7, 6, 7, 5, 6, 4, 6, 5, 5]):
        s.offer(i, _R(it))
    return s.sample()


def test_p95_reads_the_untraced_solves():
    read = spec.reader("solve_p95_ms")
    solves = [window.Solve(i, 10, 0.0, s)
              for i, s in enumerate([9.0] * 5 + [0.001 * k for k in range(1, 101)])]
    p95 = read({"solves": solves, "traced": solves[:5]})
    assert p95 == pytest.approx(95.05)
    assert read({"solves": solves[:5], "traced": solves[:5]}) is None


def _run(cwd, *args):
    return subprocess.run(
        [sys.executable, "czbench/run.py", "--workload", "sor2sma-124",
         "--seed", str(SEED), "--seconds", "1", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_exits_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(spec.ROOT)
    assert p.returncode == 3 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_exits_without_the_program(tmp_path):
    _copy(tmp_path)
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "cubez_tpu_torch" in p.stderr
