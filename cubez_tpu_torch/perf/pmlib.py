"""Performance monitor — the PMlib replacement (PyTorch port of
``cubez_tpu/perf/pmlib.py``).

The reference weaves PMlib through every solver: a label registry with
CALC/COMM types and exclusive flags (set_timing_label, cz_miscel.cpp:150-262),
TIMING_start/stop macros accumulating analytic flop counts (cz.h:506-539),
and a gathered report to stdout + profiling.txt (cz_Evaluate.cpp:506-544).

The same accounting model and report text as the JAX package's.  A
section on a CUDA device is timed with CUDA events around the work queued
inside it (the end event is waited for), elsewhere with
``time.perf_counter``; flops and bytes are attached analytically, as the
reference's in-kernel flop accumulators do (cz_solver.f90:238-241 etc.),
and the report adds %SoL: the share of the device's HBM bandwidth (or,
for a section with flops and no bytes, of its peak rate) from
``device_hbm_gbps``/``device_peak_gflops``, the data-sheet figures of the
card's table entry, blank for a card the table does not know.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Optional

import torch

CALC = "CALC"
COMM = "COMM"


@dataclasses.dataclass
class Section:
    label: str
    kind: str = CALC
    exclusive: bool = True
    calls: int = 0
    seconds: float = 0.0
    flops: float = 0.0
    bytes: float = 0.0

    @property
    def gflops(self) -> float:
        return self.flops / self.seconds / 1e9 if self.seconds > 0 else 0.0

    @property
    def gbps(self) -> float:
        return self.bytes / self.seconds / 1e9 if self.seconds > 0 else 0.0


class PerfMonitor:
    """Label registry + section timers + report (PMlib's initialize /
    setProperties / start / stop / print pipeline, cz_miscel.cpp:142-263).
    ``device``: where ``section`` times (CUDA events on a CUDA device)."""

    def __init__(self, hbm_gbps: Optional[float] = None,
                 peak_gflops: Optional[float] = None, device=None):
        self.sections: dict[str, Section] = {}
        self.order: list[str] = []
        self.hbm_gbps = hbm_gbps
        self.peak_gflops = peak_gflops
        self.device = None if device is None else torch.device(device)

    def set_label(self, label: str, kind: str = CALC, exclusive: bool = True):
        if label not in self.sections:
            self.sections[label] = Section(label=label, kind=kind, exclusive=exclusive)
            self.order.append(label)
        return self.sections[label]

    @contextmanager
    def section(self, label: str, kind: str = CALC, flops: float = 0.0,
                bytes: float = 0.0):
        """Time a block; attach analytic flop/byte counts for the work done
        inside (the TIMING_start/stop pair, cz.h:506-539).  On the
        monitor's CUDA device the time is that of CUDA events recorded on
        its current stream around the block, so it covers the work the
        block queued; otherwise the host clock's."""
        s = self.set_label(label, kind)
        with Timer(self.device) as t:
            yield s
        s.calls += 1
        s.seconds += t.seconds
        s.flops += flops
        s.bytes += bytes

    def add(self, label: str, seconds: float, kind: str = CALC, flops: float = 0.0,
            bytes: float = 0.0, calls: int = 1):
        """Record an externally-timed interval."""
        s = self.set_label(label, kind)
        s.calls += calls
        s.seconds += seconds
        s.flops += flops
        s.bytes += bytes

    # --- report ------------------------------------------------------------

    def report(self) -> str:
        """profiling.txt-style table (PM.print, cz_Evaluate.cpp:506-544)."""
        lines = []
        hdr = (
            f"{'Label':<28} {'type':<4} {'calls':>7} {'time[s]':>10} "
            f"{'GFLOPS':>9} {'GB/s':>8} {'%SoL':>6}"
        )
        lines.append(hdr)
        lines.append("-" * len(hdr))
        total = 0.0
        for label in self.order:
            s = self.sections[label]
            if s.calls == 0:
                continue
            sol = ""
            if self.hbm_gbps and s.bytes > 0 and s.seconds > 0:
                sol = f"{100.0 * s.gbps / self.hbm_gbps:6.1f}"
            elif self.peak_gflops and s.flops > 0 and s.seconds > 0:
                sol = f"{100.0 * s.gflops / self.peak_gflops:6.1f}"
            lines.append(
                f"{s.label:<28} {s.kind:<4} {s.calls:>7d} {s.seconds:>10.4f} "
                f"{s.gflops:>9.2f} {s.gbps:>8.1f} {sol:>6}"
            )
            if s.exclusive:
                total += s.seconds
        lines.append("-" * len(hdr))
        lines.append(f"{'total (exclusive)':<28} {'':<4} {'':>7} {total:>10.4f}")
        return "\n".join(lines)

    def write(self, path: str = "profiling.txt"):
        with open(path, "w") as f:
            f.write(self.report() + "\n")


class Timer:
    """Seconds a ``with`` block takes on ``device``: CUDA events on its
    current stream for a CUDA device (the end event waited for, so the
    time covers the work the block queued), ``time.perf_counter``
    elsewhere (the host runs CPU tensors' work as it is called)."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.cuda = self.device is not None and self.device.type == "cuda"
        self.seconds = 0.0

    def __enter__(self):
        if self.cuda:
            self._e0 = torch.cuda.Event(enable_timing=True)
            self._e1 = torch.cuda.Event(enable_timing=True)
            self._e0.record(torch.cuda.current_stream(self.device))
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self._e1.record(torch.cuda.current_stream(self.device))
            self._e1.synchronize()
            self.seconds = self._e0.elapsed_time(self._e1) / 1e3
        else:
            self.seconds = time.perf_counter() - self._t0
        return False


@dataclasses.dataclass(frozen=True)
class CardPeaks:
    """Data-sheet figures of a card: HBM GB/s, FP32 and FP64 GFLOP/s
    outside the tensor cores (at the card's full power limit)."""
    hbm_gbps: float
    f32_gflops: float
    f64_gflops: float


# NVIDIA's data sheets, keyed by a lower-case substring of
# torch.cuda.get_device_name, the more specific first: H100 SXM5 (its name
# is "NVIDIA H100 80GB HBM3"), H100 NVL and H100 PCIe.
CARDS = (
    ("h100 nvl", CardPeaks(3900.0, 60e3, 30e3)),
    ("h100 pcie", CardPeaks(2000.0, 51e3, 26e3)),
    ("h100 80gb hbm3", CardPeaks(3350.0, 67e3, 34e3)),
    ("h100 sxm", CardPeaks(3350.0, 67e3, 34e3)),
)
CPU_HBM_GBPS = 50.0  # the JAX package's figure for a CPU host


def card_peaks(device="cuda") -> Optional[CardPeaks]:
    """The table entry of ``device``'s card; None for a card the table does
    not know, or a device that is no CUDA device."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for key, peaks in CARDS:
        if key in name:
            return peaks
    return None


def device_hbm_gbps(device="cuda") -> Optional[float]:
    """HBM bandwidth (GB/s) of ``device``: its card's data-sheet figure
    (``CARDS``), None for an unknown card (the report then leaves %SoL
    blank), ``CPU_HBM_GBPS`` for the CPU."""
    if torch.device(device).type == "cpu":
        return CPU_HBM_GBPS
    peaks = card_peaks(device)
    return None if peaks is None else peaks.hbm_gbps


def device_peak_gflops(device="cuda", dtype=torch.float32) -> Optional[float]:
    """Peak GFLOP/s of ``device`` in ``dtype`` outside the tensor cores
    (float32, float64); None for another dtype, an unknown card or the
    CPU."""
    peaks = card_peaks(device)
    if peaks is None:
        return None
    return {torch.float32: peaks.f32_gflops,
            torch.float64: peaks.f64_gflops}.get(dtype)
