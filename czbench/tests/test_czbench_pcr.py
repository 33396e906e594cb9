"""The cell ``pcr-124`` on the CPU: its files found by name, the program held
against the plain reference (reference/pcr.py) at 16^3 and faults made
false, the control failing the cell's limits, and the two metrics it adds,
``p2_roofline`` and ``replay_pct``, on hand-worked facts.

    JAX_PLATFORMS=cpu python -m pytest czbench/tests -q
"""

import dataclasses
import types

import pytest
import torch

import control
from czb import cell as cell_mod
from czb import check, lines, spec
from czb import spans as czb_spans
from czb.work import card_peaks
from cubez_tpu_torch.perf import spans
from cubez_tpu_torch.solvers import api

CELL = "pcr-124"
N = 16
SEED = 2 ** 33 + 23  # larger than 32 signed bits hold


def _read(name, facts):
    return spec.reader(name)(facts)


def test_the_cell_finds_its_files():
    cell = spec.load(CELL)
    cfg = cell.config
    assert (cfg["solver"], cfg["omega"], cfg["eps"], cfg["itr_max"],
            cfg["dtype"], cfg["precond"]) == ("pcr", 1.5, 1e-5, 10000,
                                              "float32", None)
    assert spec.reference(cfg["reference"]).solve is not None
    assert cell.traffic["n"] == 124 and cell.chips == 1
    assert set(cell.check["limits"]) == {"iters_gap", "hist_gap", "field_gap"}
    assert [m["name"] for m in cell.end_to_end] == ["solve_ms", "setup_s"]
    names = [m["name"] for m in cell.per_layer]
    assert names == ["iters_per_solve", "launches_per_iter", "device_idle_pct",
                     "syncs_per_solve", "sync_idle_pct", "host_us_per_launch",
                     "p2_roofline", "replay_pct"]
    for name in names:
        assert callable(spec.reader(name))
    # the warm-up reaches the stop's replay: 40 is no multiple of 16
    assert cfg["warmup"][-1] == {"eps": 0, "itr_max": 40}
    assert "replay_pct" in {m["name"] for m in spec.load("sor2sma-124").per_layer}
    assert "p2_roofline" not in {m["name"] for m in
                                 spec.load("sor2sma-512").per_layer}


def _broken_route(kind):
    route = api.relaxation_route

    def broken_route(*a, **k):
        step, pre, post = route(*a, **k)

        def broken(x, b):
            keep = x.clone()
            y, r2 = step(x, b)
            if kind == "unchanged":
                return keep, r2
            flat = y.view(-1)
            flat[: flat.numel() // 2] = keep.view(-1)[: flat.numel() // 2]
            return y, r2

        for attr in ("iters_per_call", "check_every_default"):
            setattr(broken, attr, getattr(step, attr))
        broken.single = broken
        return broken, pre, post

    return broken_route


@pytest.mark.parametrize("fault", (None, "unchanged", "half", "altered"))
def test_program_against_the_reference(fault, monkeypatch):
    """The program's pcr at 16^3 passes the cell's check against the plain
    reference; a step that leaves its field unchanged or half of it out,
    or an answer altered where it is produced, fails it."""
    torch.set_num_threads(1)
    cell = spec.load(CELL)
    cell.config = dict(cell.config, itr_max=400)  # a fault runs to itr_max
    if fault in ("unchanged", "half"):
        monkeypatch.setattr(api, "relaxation_route", _broken_route(fault))
    elif fault == "altered":
        solve = api.solve

        def altered(*a, **k):
            r = solve(*a, **k)
            x = r.x.clone()
            x[N // 2, N // 2, N // 2] += 0.01
            return dataclasses.replace(r, x=x)

        monkeypatch.setattr(api, "solve", altered)
    out = cell_mod.run_cell(cell, SEED, 0.2, False, device="cpu", n=N)
    assert out["correct"] is (fault is None), out["checks"]


def test_control_fails_the_limits():
    torch.set_num_threads(1)
    cell = spec.load(CELL)
    for seed in (1, 2, 3):
        ok, checks = check.judge(
            check.worst(control.control_readings(cell, seed, "cpu", n=N)),
            cell.check["limits"])
        assert not ok, checks
        assert all(c["value"] > c["limit"] for c in checks.values()), checks


def test_the_traced_cpu_run_reads_no_device_metric():
    out = cell_mod.run_cell(spec.load(CELL), SEED, 0.3, True, device="cpu",
                            n=N)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"iters_per_solve"}


def _facts(recs, seconds, device_ops):
    """Facts of a traced window of the solves ``recs`` at 124^3 f32 on an
    H100 80GB HBM3."""
    traced = [types.SimpleNamespace(index=i, iters=r.iters, res=0.0,
                                    seconds=s)
              for i, (r, s) in enumerate(zip(recs, seconds))]
    return {"config": spec.load(CELL).config, "n": 124, "traced": traced,
            "solves": traced, "peaks": card_peaks("NVIDIA H100 80GB HBM3"),
            "trace": {"records": 100, "busy_s": 1.0, "window_s": 2.0,
                      "breakdown": {"device_ops": device_ops,
                                    "idle_gaps": []}}}


def _rec(iters, sweeps, replay_s):
    return types.SimpleNamespace(iters=iters, sweeps=sweeps,
                                 replayed=sweeps - iters, replay_s=replay_s)


P2 = "void (anonymous namespace)::pcr_gs_lines_kernel<float, false, 4>(int const*"


def test_p2_roofline_by_hand(monkeypatch):
    """A sweep at 124^3 f32 is bound by its bytes: 3 * 124^3 * 4 bytes over
    3350 GB/s is 6.8297 us, against 107.41 operations a point on 122^3
    points over 67 TFLOP/s, 2.911 us.  Two solves of 1000 and 1200 sweeps
    over 0.150 s of P2 (its lagged and one-sweep launches) read 10.02%."""
    assert lines.pcr_flops_per_pt(122) == pytest.approx(107.40984, rel=1e-6)
    peaks = card_peaks("NVIDIA H100 80GB HBM3")
    assert lines.sweep_least_seconds(124, "float32", peaks) == pytest.approx(
        3 * 124 ** 3 * 4 / 3350e9)
    assert lines.sweep_flops(124) / 67e12 == pytest.approx(2.9110e-6, rel=1e-4)
    recs = [_rec(990, 1000, 0.001), _rec(1190, 1200, 0.002)]
    monkeypatch.setattr(spans, "solves", lambda: recs)
    ops = [[P2, 0.120], ["Memcpy DtoD (Device -> Device)", 0.5],
           ["void pcr_gs_lines_kernel<float, false, 4>(one sweep)", 0.030]]
    facts = _facts(recs, (0.1, 0.1), ops)
    assert czb_spans.traced(facts) == recs
    want = 100 * 2200 * (3 * 124 ** 3 * 4 / 3350e9) / 0.150
    assert _read("p2_roofline", facts) == pytest.approx(want)
    assert _read("p2_roofline", facts) == pytest.approx(10.017, rel=1e-4)
    # no P2 kernel in the trace, no trace, no records, an unknown card
    assert _read("p2_roofline", _facts(recs, (0.1, 0.1), ops[1:2])) is None
    assert _read("p2_roofline", {**facts, "trace": None}) is None
    assert _read("p2_roofline", {**facts, "peaks": None}) is None
    monkeypatch.setattr(spans, "solves", lambda: [])
    assert _read("p2_roofline", facts) is None


def test_replay_pct_by_hand(monkeypatch):
    """2 ms and 4 ms of replay over two solves of 0.1 s: 3%; 0 where
    nothing was replayed; nothing off the card (replay_s None), from a
    program whose records have no replay_s, or without a trace."""
    recs = [_rec(990, 1000, 0.002), _rec(1190, 1200, 0.004)]
    monkeypatch.setattr(spans, "solves", lambda: recs)
    facts = _facts(recs, (0.1, 0.1), [[P2, 0.1]])
    assert _read("replay_pct", facts) == pytest.approx(3.0)
    zero = [_rec(16, 16, 0.0), _rec(32, 32, 0.0)]
    monkeypatch.setattr(spans, "solves", lambda: zero)
    assert _read("replay_pct", _facts(zero, (0.1, 0.1), [[P2, 0.1]])) == 0.0
    off = [_rec(990, 1000, None), _rec(1190, 1200, 0.004)]
    monkeypatch.setattr(spans, "solves", lambda: off)
    assert _read("replay_pct", _facts(off, (0.1, 0.1), [[P2, 0.1]])) is None
    older = [types.SimpleNamespace(iters=990, sweeps=1000)]
    monkeypatch.setattr(spans, "solves", lambda: older)
    assert _read("replay_pct", _facts(older, (0.1,), [[P2, 0.1]])) is None
    monkeypatch.setattr(spans, "solves", lambda: recs)
    assert _read("replay_pct", {**facts, "trace": None}) is None
