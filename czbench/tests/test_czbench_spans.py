"""The metrics read from the program's own spans and counters (czb/spans.py
and metrics/syncs_per_solve.py, sync_idle_pct.py, host_us_per_launch.py,
sweeps_per_iter.py) on the CPU.

    JAX_PLATFORMS=cpu python -m pytest czbench/tests -q
"""

import dataclasses

import pytest

from czb import cell as cell_mod
from czb import spans as czb_spans
from czb import spec, window
from czb.inputs import DTYPES, Inputs
from czb.program import Program

SEED = 2 ** 31 + 4242
NEW = ("syncs_per_solve", "sync_idle_pct", "host_us_per_launch",
       "sweeps_per_iter")


def _read(name, facts):
    return spec.reader(name)(facts)


def test_the_new_metrics_read_nothing_on_the_cpu_harness_run():
    """A traced run on the CPU has no device record: the program's waits
    there are no device syncs, and the four metrics leave the line."""
    cell = spec.load("sor2sma-124")
    assert set(NEW) <= {m["name"] for m in cell.per_layer}
    out = cell_mod.run_cell(cell, SEED, 0.3, True, device="cpu", n=16)
    assert out["correct"] is True
    assert not set(NEW) & set(out["metrics"])


def _solves(monkeypatch, count=2):
    """``count`` sor2sma solves of the cell's configuration at 16^3 on the
    CPU, recorded by the program, each wrapper call counted as a launch;
    (their records, the facts of a traced window of them with one device
    record)."""
    from cubez_tpu_torch.cuda_kernels import rbpack
    from cubez_tpu_torch.perf import spans

    plain = rbpack.packed_sweeps_plain

    def launching(*args):
        rbpack.rb_sweeps_n.launches += 1
        return plain(*args)

    monkeypatch.setattr(rbpack, "packed_sweeps_plain", launching)
    cfg = spec.load("sor2sma-124").config
    inputs = Inputs(16, DTYPES[cfg["dtype"]], "cpu", SEED)
    program = Program(cfg, 16, "cpu")
    solves = []
    with spans.recording():
        for i in range(count):
            r = program.solve(inputs.start(i), inputs.rhs)
            solves.append(window.Solve(i, r.iters, r.res, 0.05))
    recs = spans.solves()[-count:]
    facts = {"trace": {"records": 1, "busy_s": 0.05, "window_s": 0.1},
             "traced": solves, "solves": solves}
    return recs, facts


def test_numbers_from_solves_recorded_on_the_cpu(monkeypatch):
    from cubez_tpu_torch.perf import spans

    recs, facts = _solves(monkeypatch)
    assert czb_spans.traced(facts) == recs
    n = len(recs)
    assert _read("syncs_per_solve", facts) == sum(r.syncs for r in recs) / n
    iters = sum(r.iters for r in recs)
    assert _read("sweeps_per_iter", facts) == pytest.approx(
        sum(r.sweeps for r in recs) / iters)
    assert 1.0 < _read("sweeps_per_iter", facts) < 1.5
    launches = sum(r.launches for r in recs)
    assert launches > 0
    us = _read("host_us_per_launch", facts)
    assert us == pytest.approx(1e-3 * sum(
        r.spans["sor2sma"].self_ns for r in recs) / launches)
    # no device idle is measured off the card: the record holds None
    assert _read("sync_idle_pct", facts) is None
    idle = [dataclasses.replace(r, sync_idle_s=0.01) for r in recs]
    monkeypatch.setattr(spans, "solves", lambda: idle)
    assert _read("sync_idle_pct", facts) == pytest.approx(100 * 0.02 / 0.1)


def test_nothing_where_the_records_do_not_match(monkeypatch):
    from cubez_tpu_torch.perf import spans

    recs, facts = _solves(monkeypatch)
    monkeypatch.setattr(spans, "solves", lambda: recs)  # these alone
    assert czb_spans.traced(facts) == recs
    wrong = [dataclasses.replace(s, iters=s.iters + 1) for s in facts["traced"]]
    more = facts["traced"] + facts["traced"]
    for bad in ({**facts, "traced": wrong}, {**facts, "traced": more},
                {**facts, "trace": None},
                {**facts, "trace": {**facts["trace"], "records": 0}}):
        assert czb_spans.traced(bad) is None
        for name in NEW:
            assert _read(name, bad) is None, name
