"""The port's CLI (reference argv) on the CPU."""

import os
import pathlib
import subprocess
import sys

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
    (["--dist"], "slice 9"), (["--profile"], "slice 8"),
    (["--dump", "f.sph"], "slice 7"), (["2", "1", "1"], "slice 9"),
])
def test_cli_later_slices_raise(extra, where, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=where):
        main(["8", "8", "8", "sor2sma", "10", "1.5", "--device", "cpu"] + extra)


def test_cli_unported_solver_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="slice 3"):
        main(["8", "8", "8", "jacobi", "10", "0.8", "--device", "cpu"])
