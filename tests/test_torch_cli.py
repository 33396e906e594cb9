"""The port's CLI (reference argv) on the CPU."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from cubez_tpu_torch.cli import main

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_cli_32_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert main(["32", "32", "32", "sor2sma", "10000", "1.5",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Iterative Method = sor2sma" in out
    assert "Iter = 199  Res = " in out  # the oracle's count at 32^3
    assert "Mcell-updates/s" in out
    assert "Error max = 2.2" in out and "at (" in out
    rows = (tmp_path / "sor2sma.txt").read_text().splitlines()
    assert rows[0] == "Itration      Residual" and len(rows) == 200
    assert rows[1].startswith("     1, ")


def test_cli_module_entry_point(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "cubez_tpu_torch", "12", "12", "12", "sor2sma",
         "3", "1.5", "--device", "cpu", "--fp64", "--warmup"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert r.returncode == 0, r.stderr
    assert "Iter = 3  Res = " in r.stdout
    assert len((tmp_path / "sor2sma.txt").read_text().splitlines()) == 4


def test_cli_cuda_requested_without_cuda_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["8", "8", "8", "sor2sma", "10", "1.5"])
    assert not (tmp_path / "sor2sma.txt").exists()


@pytest.mark.parametrize("extra,where", [
    (["--profile"], "slice 8"), (["--dump", "f.sph"], "slice 7"),
])
def test_cli_later_slices_raise(extra, where, tmp_path, monkeypatch):
    """Options of later slices raise naming their slice."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=where):
        main(["8", "8", "8", "pcr_rb", "10", "1.5", "--device", "cpu"] + extra)


@pytest.mark.parametrize("extra,div", [
    (["--dist"], "(1, 1, 1)"), (["2", "1", "1"], "(1, 2, 1)"),
])
def test_cli_dist_line_solver_runs(extra, div, tmp_path, monkeypatch, capsys):
    """A distributed line solve (``--dist``, or a division that leaves K
    unsplit, so K9's 'fastdiag' form) stops at the serial CLI's count."""
    for name, more in (("serial", []), ("dist", extra)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        assert main(["16", "16", "16", "pcr_rb", "10000", "1.5", *more,
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"mesh division (z,x,y) = {div} on 1 device(s)" in out
    iters = [ln for ln in out.splitlines() if ln.startswith("Iter = ")]
    assert len(iters) == 2 and iters[0].split()[2] == iters[1].split()[2]


def test_cli_division_runs_solve_dist(tmp_path, monkeypatch, capsys):
    """``32 32 32 sor2sma 10000 1.5 2 2 2``: the mesh (z, x, y) from the
    argv's x, y, z, the serial CLI's count, and its history within rtol
    1e-5."""
    for name, extra in (("serial", []), ("dist", ["2", "2", "2"])):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        assert main(["32", "32", "32", "sor2sma", "10000", "1.5", *extra,
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "mesh division (z,x,y) = (2, 2, 2) on 1 device(s)" in out
    assert out.count("Iter = 199  Res = ") == 2

    def hist(name):
        rows = (tmp_path / name / "sor2sma.txt").read_text().splitlines()
        return [float(r.split(",")[1]) for r in rows[1:]]

    np.testing.assert_allclose(hist("dist"), hist("serial"), rtol=1e-5)
    monkeypatch.chdir(tmp_path)
    main(["16", "32", "8", "jacobi", "3", "0.8", "4", "2", "1", "--device",
          "cpu"])
    assert "mesh division (z,x,y) = (1, 4, 2)" in capsys.readouterr().out


def test_cli_unported_solver_raises(tmp_path, monkeypatch, capsys):
    """psor raised here until slice 6 was ported; now it runs through the
    CLI as the reference's other names do, its history written."""
    monkeypatch.chdir(tmp_path)
    assert main(["8", "8", "8", "psor", "10", "1.5", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Iterative Method = psor" in out and "Error max = " in out
    assert len((tmp_path / "psor.txt").read_text().splitlines()) >= 2


@pytest.mark.parametrize("solver,omega,iters", [
    ("jacobi_maf", "0.8", 1015), ("sor2sma_maf", "1.5", 199),
])
def test_cli_maf_32_on_cpu(solver, omega, iters, tmp_path, monkeypatch, capsys):
    """A _maf name gets the MAF problem, as the JAX package's CLI does; the
    oracle's counts at 32^3."""
    monkeypatch.chdir(tmp_path)
    assert main(["32", "32", "32", solver, "10000", omega,
                 "--device", "cpu"]) == 0
    assert f"Iter = {iters}  Res = " in capsys.readouterr().out
    assert len((tmp_path / f"{solver}.txt").read_text().splitlines()) == iters + 1


def test_cli_pcr_rb_history_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """pcr_rb through both CLIs at 16^3 on the CPU: the same count, the
    same history format (header, one ``%6d, %13.6e`` row per iteration)
    and residual curves within the f32 band, rtol 1e-3 (the JAX package
    sums dp^2 in float32 and solves by PCR, the port folds in float64
    and solves by Thomas)."""
    from cubez_tpu.cli import main as j_main

    argv = ["16", "16", "16", "pcr_rb", "10000", "1.5"]
    files = {}
    for name, run in (("torch", lambda: main(argv + ["--device", "cpu"])),
                      ("jax", lambda: j_main(argv))):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        assert run() in (0, None)
        out = capsys.readouterr().out
        assert "Iterative Method = pcr_rb" in out and "Error max = " in out
        files[name] = (d / "pcr_rb.txt").read_text().splitlines()
    t, j = files["torch"], files["jax"]
    assert t[0] == j[0] == "Itration      Residual"
    assert len(t) == len(j) > 10
    for rows in (t, j):
        for i, row in enumerate(rows[1:], start=1):
            assert row == "%6d, %13.6e" % (i, float(row.split(",")[1]))
    tv = [float(r.split(",")[1]) for r in t[1:]]
    jv = [float(r.split(",")[1]) for r in j[1:]]
    assert max(abs(a / b - 1) for a, b in zip(tv, jv)) < 1e-3


def test_cli_pbicgstab_defaults_to_no_preconditioner(tmp_path, monkeypatch,
                                                     capsys):
    """pbicgstab with no preconditioner argument runs with "none" and says
    so after the method line (the JAX package's CLI); a named one is
    printed as given."""
    monkeypatch.chdir(tmp_path)
    assert main(["16", "16", "16", "pbicgstab", "4000", "1.1",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Iterative Method = pbicgstab\nPreconditioner = none\n" in out
    rows = (tmp_path / "pbicgstab.txt").read_text().splitlines()
    assert rows[0] == "Itration      Residual" and len(rows) > 2
    assert main(["16", "16", "16", "pbicgstab", "4000", "1.1", "sor2sma",
                 "2", "2", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Preconditioner = sor2sma" in out and "Error max" in out
    assert main(["16", "16", "16", "cg", "4000", "0.8", "jacobi",
                 "--device", "cpu"]) == 0
    assert "Preconditioner" not in capsys.readouterr().out
