"""The benchmark's frozen arithmetic: operation counts and card peaks equal
the program's perf layer today, the least time of a solve, and the trace
reader's busy-share union on synthetic intervals."""

import json

import pytest

from czb import spec, trace, work
from cubez_tpu_torch.perf import pmlib, roofline


def test_ops_equal_roofline_constants():
    # the zero-RHS variants (_b0) differ in bytes only
    assert set(work.OPS) == {k.removesuffix("_b0") for k in roofline.COSTS}
    for name, cost in roofline.COSTS.items():
        assert work.OPS[name.removesuffix("_b0")] == cost.flops_per_pt, name


def test_cards_equal_pmlib():
    assert [k for k, _ in work.CARDS] == [k for k, _ in pmlib.CARDS]
    for (_, ours), (_, theirs) in zip(work.CARDS, pmlib.CARDS):
        assert ours["hbm_gbps"] == theirs.hbm_gbps
        assert ours["float32"] == theirs.f32_gflops
        assert ours["float64"] == theirs.f64_gflops
    assert work.card_peaks("NVIDIA H100 80GB HBM3")["hbm_gbps"] == 3350.0
    assert work.card_peaks("NVIDIA A100-SXM4-40GB") is None


def test_pbicgstab_work_counts_the_reference_loop():
    cfg = json.loads((spec.HERE / "configs" / "pbicgstab_sor2sma.json")
                     .read_text())
    per_iter = sum(work.OPS[k] * c for k, c in cfg["work"]["per_iter"].items())
    # 2 x 8 sweeps, 2 A p, 5 dots, 2 triads, bicg_1, bicg_2
    assert per_iter == 16 * 18 + 2 * 13 + 5 * 2 + 2 * 2 + 4 + 4
    n = 18
    assert work.solve_flops(cfg["work"], n, 3) == (n - 2) ** 3 * (
        per_iter * 3 + 14 + 2 - 4)


def test_least_seconds_takes_the_larger_bound():
    peaks = work.card_peaks("h100 80gb hbm3")
    w = {"per_iter": {"sor2sma": 1}}
    n = 130
    flops = (n - 2) ** 3 * 18 * 1000 / 67e12
    assert work.least_seconds(w, n, "float32", 1000, peaks) == pytest.approx(flops)
    byts = 3 * n ** 3 * 4 / 3350e9
    assert work.least_seconds(w, n, "float32", 0, peaks) == pytest.approx(byts)


def test_union_and_gaps():
    iv = [(5, 7), (0, 2), (1, 3), (6, 6.5), (10, 12)]
    assert trace.union(iv) == [(0, 3), (5, 7), (10, 12)]
    busy, gaps = trace.busy_and_gaps(iv, 1, 11)
    assert busy == pytest.approx(2 + 2 + 1)
    assert gaps == [(3, 5), (7, 10)]
    busy, gaps = trace.busy_and_gaps([], 0, 4)
    assert busy == 0 and gaps == [(0, 4)]


def test_gaps_named_by_innermost_host_event():
    host = [(0, 100, "czbench.window"), (10, 40, "sor2sma"),
            (12, 20, "cudaLaunchKernel"), (50, 60, "aten::copy_")]
    named = trace.label_gaps([(13, 15), (30, 34), (44, 46), (55, 57)], host)
    assert named == [("cudaLaunchKernel", 2), ("sor2sma", 4),
                     ("czbench.window", 2), ("aten::copy_", 2)]


def test_read_chrome_trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "czbench.window",
         "ts": 100.0, "dur": 100.0, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 150.0,
         "dur": 30.0, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 110.0, "dur": 20.0,
         "pid": 0, "tid": 7},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 120.0,
         "dur": 20.0, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "sor2sma",
         "ts": 100.0, "dur": 100.0, "pid": 0, "tid": 8},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 190.0, "dur": 30.0,
         "pid": 0, "tid": 7},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    f = trace.read(p)
    assert f["window_s"] == pytest.approx(100e-6)
    assert f["busy_s"] == pytest.approx(40e-6)  # 110-140 and 190-200
    assert f["records"] == 3
    ops = dict(f["breakdown"]["device_ops"])
    assert ops["k1"] == pytest.approx(50e-6)
    gaps = dict(f["breakdown"]["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(50e-6)  # 140-190
    assert gaps["czbench.window"] == pytest.approx(10e-6)  # 100-110
