"""The benchmark's plain reference of ``pcr`` (czbench/reference/pcr.py, the
lexicographic line Gauss-Seidel written from the reference's description)
against the port's ``pcr`` on its plain twin, on the CPU, from the
benchmark's own seeded starts (czbench/czb/inputs.py); and one sweep of
the reference against a literal serial loop over the lines.

Both files are loaded by path, as the benchmark's own folder is not a
package of the repository.  This file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_pcr_reference.py
"""

import dataclasses
import importlib.util
import re
from pathlib import Path

import pytest
import torch

import cubez_tpu_torch as czt

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parent.parent / "czbench"
OMEGA = 1.5
SEEDS = (2 ** 31 + 7, 12345678901)


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, BENCH / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load("reference/pcr.py", "czbench_reference_pcr")
inputs = _load("czb/inputs.py", "czbench_czb_inputs")

# The histories part where a sweep's dp, about eps at the stop, nears the
# rounding of the field: the reference solves a line by a product with
# T^-1, the port by PCR, so each node's dp differs by the field's rounding,
# about 1e-7 of it in float32 (1e-16 in float64), and at 16^3 only 2744
# inner nodes average that.  Measured at the last sweeps: up to 1.04e-3 in
# float32, 1.0e-12 in float64.  The fields differ by the same rounding,
# carried over the sweeps: 1.1e-6 and 1.4e-15 of the largest value.
HIST_RTOL = {torch.float32: 2e-3, torch.float64: 1e-9}
FIELD_GAP = {torch.float32: 1e-5, torch.float64: 1e-13}


@pytest.mark.parametrize("n", (16, 17))
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("seed", SEEDS)
def test_reference_against_the_port(n, dtype, seed):
    """The same stopping sweep, the histories within HIST_RTOL, the fields
    within FIELD_GAP of their largest value."""
    inp = inputs.Inputs(n, dtype, "cpu", seed)
    x0 = inp.start(0)
    p = dataclasses.replace(czt.Problem.poisson_cube(n, dtype, device="cpu"),
                            x0=x0, rhs=inp.rhs)
    r = czt.solve(p, "pcr", omega=OMEGA, itr_max=10000, impl="plain")
    iters, hist, x = ref.solve(x0, inp.rhs, omega=OMEGA, itr_max=10000,
                               eps=1e-5)
    assert iters == r.iters > ref.LAG  # the stop inside a later group
    assert hist.dtype == torch.float64 and len(hist) == iters
    torch.testing.assert_close(hist, r.history.double(),
                               rtol=HIST_RTOL[dtype], atol=0)
    gap = float((x - r.x).abs().max()) / float(x.abs().max())
    assert gap < FIELD_GAP[dtype]
    assert torch.equal(x[0], x0[0]) and torch.equal(x[:, :, -1], x0[:, :, -1])


def _literal_sweep(x, b, omega, tinv):
    """One sweep over the lines, j outer and i inner, each line's
    right-hand side from the field as the loop has left it; the float64
    sum of dp^2."""
    K, I, J = x.shape
    r2 = torch.zeros((), dtype=torch.float64)
    for j in range(1, J - 1):
        for i in range(1, I - 1):
            t = ((x[1:-1, i - 1, j] + x[1:-1, i, j - 1])
                 + x[1:-1, i + 1, j]) + x[1:-1, i, j + 1]
            r = (t - b[1:-1, i, j]) / 6.0
            r[0] += x[0, i, j] / 6.0
            r[-1] += x[K - 1, i, j] / 6.0
            sol = torch.matmul(r[None, :], tinv.mT)[0]
            dp = (sol - x[1:-1, i, j]) * omega
            x[1:-1, i, j] += dp
            r2 += dp.double().square().sum()
    return r2


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_one_sweep_is_the_serial_loop(dtype):
    """At 8^3 a sweep of the reference's diagonal walk is the literal (j, i)
    loop bit for bit, and its r2 equals the loop's sum to rounding (the sums
    run in another order); so are 5 lagged sweeps and 5 single ones."""
    gen = torch.Generator().manual_seed(3)
    x = torch.rand((8, 8, 8), generator=gen, dtype=dtype)
    b = torch.zeros_like(x)
    b[1:-1, 1:-1, 1:-1] = torch.rand((6, 6, 6), generator=gen, dtype=dtype)
    sweeps = ref.Sweeps(x.shape, OMEGA, dtype, "cpu")
    want = x.clone()
    r2 = _literal_sweep(want, b, OMEGA, sweeps.tinv)
    S, B = ref.skew(x), ref.skew(b)
    got = sweeps.run(S, B, 1)
    assert torch.equal(ref.unskew(S, 8), want)
    torch.testing.assert_close(got[0], r2, rtol=1e-12, atol=0)
    lagged, single = ref.skew(x), ref.skew(x)
    r_lag = sweeps.run(lagged, B, 5)
    r_one = torch.cat([sweeps.run(single, B, 1) for _ in range(5)])
    assert torch.equal(lagged, single) and torch.equal(r_lag, r_one)


def test_skew_round_trip_and_zero_pads():
    x = torch.rand((5, 6, 7), dtype=torch.float64)
    S = ref.skew(x)
    assert S.shape == (6 + 7 - 1, 6, 5)
    assert torch.equal(ref.unskew(S, 7), x)
    assert S[0, 1:].abs().sum() == 0  # line (i, -i) is off the grid, i > 0
    assert torch.equal(S[3, 2], x[:, 2, 1])


def test_reference_imports_torch_alone():
    """The reference is independent of the code under test: it imports
    neither JAX nor either package of this repository."""
    text = (BENCH / "reference" / "pcr.py").read_text()
    imported = set(re.findall(r"^\s*(?:from|import)\s+([\w.]+)", text, re.M))
    top = {m.split(".")[0] for m in imported}
    assert top <= {"__future__", "contextlib", "math", "torch"}, top
    assert not top & {"jax", "jaxlib", "cubez_tpu", "cubez_tpu_torch"}


def test_tf32_off_inside_and_the_callers_setting_back():
    """The reference's products run with cuBLAS's and cuDNN's fp32
    precision "ieee", also in a process that set the flag through the new
    API (where torch refuses to read ``allow_tf32``); the caller's setting
    comes back."""
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = mm.fp32_precision, dnn.fp32_precision
    try:
        mm.fp32_precision = "tf32"
        with ref.ieee_matmul():
            assert (mm.fp32_precision, dnn.fp32_precision) == ("ieee", "ieee")
        assert (mm.fp32_precision, dnn.fp32_precision) == ("tf32", saved[1])
    finally:
        mm.fp32_precision, dnn.fp32_precision = saved
