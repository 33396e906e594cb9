"""Checkpoint/restart (cubez_tpu_torch/utils/checkpoint.py) and the SPH
dump (cubez_tpu_torch/utils/sph.py) on the CPU, against the JAX package's
(cubez_tpu/utils/checkpoint.py, cubez_tpu/utils/native.py).

A split solve equals the straight one bit for bit (the port's driver
replays to the exact stopping iteration, so a checkpoint holds the field
of its count); checkpoints cross between the packages both ways; the SPH
bytes equal the JAX package's writer's."""

import numpy as np
import pytest
import torch

import cubez_tpu_torch as czt
from cubez_tpu.utils import checkpoint as jck
from cubez_tpu.utils import native as jnative
from cubez_tpu_torch.utils import checkpoint as ck
from cubez_tpu_torch.utils import sph

torch.set_num_threads(1)


def _save(mod, path, r, solver, omega):
    mod.save(path, r.x, solver=solver, iters=r.iters, res=r.res, omega=omega,
             eps=1e-5, history=r.history)


@pytest.mark.parametrize("solver,omega,split", [
    ("sor2sma", 1.5, 50), ("mg", 1.0, 3), ("jacobi_maf", 0.8, 100)])
def test_resume_matches_straight_solve(solver, omega, split, tmp_path):
    p = czt.Problem.poisson_cube(20, device="cpu", maf=solver.endswith("_maf"))
    straight = czt.solve(p, solver, omega=omega, itr_max=2000)
    assert straight.res < 1e-5 and straight.iters > split
    part1 = czt.solve(p, solver, omega=omega, itr_max=split)
    assert part1.iters == split
    _save(ck, tmp_path / "ck.npz", part1, solver, omega)
    got = ck.load(tmp_path / "ck.npz")
    assert (got.solver, got.iters, got.omega) == (solver, split, omega)
    part2 = ck.resume(p, got, itr_max=2000)
    assert part1.iters + part2.iters == straight.iters
    assert torch.equal(part2.x, straight.x)
    np.testing.assert_array_equal(
        np.concatenate([got.history, part2.history.numpy()]),
        straight.history.numpy())


def test_resume_dist_matches_straight_solve(tmp_path):
    p = czt.Problem.poisson_cube(16, device="cpu")
    cm = czt.make_mesh((16,) * 3, devices=["cpu"] * 8, div=(2, 2, 2))
    straight = czt.solve(p, "sor2sma", omega=1.5, itr_max=2000)
    part1 = czt.solve(p, "sor2sma", omega=1.5, itr_max=40)
    _save(ck, tmp_path / "ck.npz", part1, "sor2sma", 1.5)
    part2 = ck.resume_dist(p, cm, ck.load(tmp_path / "ck.npz"), itr_max=2000)
    assert part1.iters + part2.iters == straight.iters
    assert torch.equal(part2.x, straight.x)


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A JAX checkpoint loads in the port and resumes there as the port's
    own does; a port checkpoint loads in the JAX package, same keys and
    values."""
    p = czt.Problem.poisson_cube(16, device="cpu")
    part1 = czt.solve(p, "sor2sma", omega=1.5, itr_max=30)
    jck.save(tmp_path / "j.npz", part1.x.numpy(), solver="sor2sma",
             iters=part1.iters, res=part1.res, omega=1.5, eps=1e-5,
             history=part1.history.numpy())
    _save(ck, tmp_path / "t.npz", part1, "sor2sma", 1.5)
    from_jax, from_port = ck.load(tmp_path / "j.npz"), jck.load(tmp_path / "t.npz")
    for a, b in ((from_jax, jck.load(tmp_path / "j.npz")),
                 (ck.load(tmp_path / "t.npz"), from_port)):
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.history, b.history)
        assert (a.solver, a.iters, a.res, a.omega, a.eps) == (
            b.solver, b.iters, b.res, b.omega, b.eps)
    np.testing.assert_array_equal(from_port.x, part1.x.numpy())
    assert ck.FORMAT_VERSION == jck.FORMAT_VERSION
    ra = ck.resume(p, from_jax, itr_max=500)
    rb = ck.resume(p, ck.load(tmp_path / "t.npz"), itr_max=500)
    assert ra.iters == rb.iters and torch.equal(ra.x, rb.x)


def test_shape_version_and_fmg_refusals(tmp_path):
    p = czt.Problem.poisson_cube(12, device="cpu")
    _save(ck, tmp_path / "ck.npz", czt.solve(p, "mg", omega=1.0, itr_max=2),
          "fmg", 1.0)
    got = ck.load(tmp_path / "ck.npz")
    with pytest.raises(ValueError, match="checkpoint shape"):
        ck.resume(czt.Problem.poisson_cube(10, device="cpu"), got, itr_max=5)
    cm = czt.make_mesh((10,) * 3, devices=["cpu"] * 8, div=(2, 2, 2))
    with pytest.raises(ValueError, match="checkpoint shape"):
        ck.resume_dist(czt.Problem.poisson_cube(10, device="cpu"), cm, got,
                       itr_max=5)
    # fmg would throw the restarted interior away; mg resumes from it
    with pytest.raises(ValueError, match="'mg'"):
        ck.resume(p, got, itr_max=5)
    assert ck.resume(p, got, itr_max=5, solver="mg").res < 1e-5
    np.savez(tmp_path / "v2.npz", version=2, x=got.x)
    with pytest.raises(ValueError, match="version"):
        ck.load(tmp_path / "v2.npz")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sph_bytes_equal_jax_and_round_trip(dtype, tmp_path):
    rng = np.random.default_rng(7)
    f = torch.tensor(rng.standard_normal((9, 13, 11)), dtype=dtype)
    kw = dict(org=(0.5, -1.0, 2.0), pitch=(0.1, 0.2, 0.3), step=17, time=1.5)
    sph.write_sph(tmp_path / "t.sph", f, **kw)
    jnative.write_sph(tmp_path / "j.sph", f.numpy(), **kw)
    assert (tmp_path / "t.sph").read_bytes() == (tmp_path / "j.sph").read_bytes()
    data, org, pitch, step, time = sph.read_sph(tmp_path / "t.sph")
    np.testing.assert_array_equal(data, f.numpy().astype(np.float32))
    assert step == 17 and time == 1.5
    np.testing.assert_allclose(org, kw["org"], rtol=1e-7)
    np.testing.assert_allclose(pitch, kw["pitch"], rtol=1e-7)
    jdata = jnative.read_sph(tmp_path / "t.sph")[0]
    np.testing.assert_array_equal(jdata, data)
