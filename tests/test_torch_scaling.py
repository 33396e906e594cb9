"""perf/scaling.py of the port on CPU blocks, against the JAX package's
analytic pieces (efficiency, report).

Times on CPU blocks measure the host, not a device: these tests pin that
the harness drives the routes solve_dist takes, records which one ran and
how many devices its blocks share, and that the report machinery is the
JAX package's (as tests/test_scaling.py pins the JAX harness).
"""

import pytest
import torch

from cubez_tpu.perf import scaling as jscaling
from cubez_tpu_torch.perf import scaling

torch.set_num_threads(1)


@pytest.mark.parametrize("impl,solver", [
    ("fused", "sor2sma"),   # the pack route (K7's twin on CPU blocks)
    ("fused", "pcr_rb"),    # K9's twin on ghosted blocks
    ("plain", "sor2sma"),   # parallel/dist.py
])
def test_weak_scaling_runs_the_routes(impl, solver):
    pts = scaling.weak_scaling(
        block=8, solver=solver, omega=1.5, iters=2, device_counts=[1, 2],
        impl=impl, devices=["cpu"] * 2,
    )
    assert [p.n_devices for p in pts] == [1, 2]
    for p in pts:
        assert p.seconds > 0 and p.cells_per_s > 0 and p.iters == 2
        # the point records the route that ran: no silent fallback
        assert p.step_impl == impl
    # the 2-block point doubles the global grid along one axis
    assert sorted(pts[1].global_shape) != sorted(pts[0].global_shape)
    assert [p.cards for p in pts] == [1, 1]
    eff = scaling.efficiency(pts)
    assert len(eff) == 2 and eff[0] == 1.0
    rep = scaling.report(pts).splitlines()
    assert "Mcells/s" in rep[0] and len(rep) == 4
    # two blocks on one host: the report says the efficiency is no scaling
    assert rep[3].startswith("blocks share devices (2 on 1)")


def test_fused_requires_a_kernel_route():
    """'fused' raises where solve_dist runs no kernel route (the MAF Jacobi
    sweep runs parallel/dist.py); 'auto' records that route."""
    with pytest.raises(ValueError, match="no kernel block route"):
        scaling.weak_scaling(block=8, solver="jacobi_maf", omega=0.8, iters=1,
                             device_counts=[1], impl="fused", devices=["cpu"])
    (p,) = scaling.weak_scaling(block=8, solver="jacobi_maf", omega=0.8,
                                iters=1, device_counts=[1], devices=["cpu"])
    assert p.step_impl == "plain"
    with pytest.raises(ValueError, match="impl must be"):
        scaling.weak_scaling(block=8, impl="jnp", devices=["cpu"])


def test_weak_scaling_needs_devices_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scaling.weak_scaling(block=8, iters=1)


def test_efficiency_and_report_equal_jax():
    """The same points give the JAX package's efficiencies and report
    (blocks each on a device of their own: no note)."""
    rows = [(1, (1, 1, 1), (16, 16, 16), 0.5), (2, (1, 1, 2), (16, 16, 32), 0.75),
            (4, (1, 2, 2), (16, 32, 32), 0.8), (8, (2, 2, 2), (32, 32, 32), 1.25)]
    pts = [scaling.ScalePoint(n, d, g, 10, s, "fused", cards=n)
           for n, d, g, s in rows]
    jpts = [jscaling.ScalePoint(n, d, g, 10, s, "fused") for n, d, g, s in rows]
    assert scaling.efficiency(pts) == jscaling.efficiency(jpts)
    assert scaling.report(pts) == jscaling.report(jpts)
    assert scaling.efficiency([]) == jscaling.efficiency([]) == []
