"""Residual history file in the reference's exact format (the writer of
``cubez_tpu/utils/native.py``; cz_Evaluate.cpp:210-218, cz_Poisson.cpp:71)."""

from __future__ import annotations

import torch


def write_history(path, residuals) -> None:
    """Header ``Itration      Residual``, then one ``%6d, %13.6e`` row per
    iteration."""
    res = torch.as_tensor(residuals, dtype=torch.float64).cpu().tolist()
    with open(str(path), "w") as f:
        f.write("Itration      Residual\n")
        for i, r in enumerate(res, start=1):
            f.write("%6d, %13.6e\n" % (i, r))
