"""Facts of a traced window, read from torch.profiler's chrome trace.

The device's records are its kernels, copies and sets (``DEVICE_CATS``);
labels that the profiler mirrors onto the device's timeline
(``gpu_user_annotation``) are no device work and are left out.  The device
is busy for the union of its records' intervals inside the window, the
host annotation ``WINDOW`` that the harness opens around the traced
solves.  Each idle gap is named by what the host was doing at its middle:
the innermost host event on the window's thread (an aten op, a step's
label, a runtime call) that spans it.
"""

from __future__ import annotations

import json
from collections import defaultdict

WINDOW = "czbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10
NAME_CHARS = 96


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def busy_and_gaps(intervals, w0, w1):
    """(busy length, idle gaps) of ``intervals`` clipped to [w0, w1]."""
    busy, gaps, at = 0.0, [], w0
    for s, e in union(intervals):
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if s > at:
            gaps.append((at, s))
        busy += e - s
        at = max(at, e)
    if w1 > at:
        gaps.append((at, w1))
    return busy, gaps


def label_gaps(gaps, host):
    """(name, length) of each gap: the innermost host event spanning its
    middle.  ``host``: (start, end, name) of nested events of one thread."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out, stack, nxt = [], [], 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (g0 + g1)
        while nxt < len(host) and host[nxt][0] <= mid:
            h = host[nxt]
            nxt += 1
            while stack and stack[-1][1] < h[0]:
                stack.pop()
            stack.append(h)
        while stack and stack[-1][1] < mid:
            stack.pop()
        out.append((stack[-1][2] if stack else "untraced host", g1 - g0))
    return out


def _top(pairs):
    total = defaultdict(float)
    for name, sec in pairs:
        total[name[:NAME_CHARS]] += sec
    return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:TOP]


def read(path) -> dict:
    """The traced window's facts: ``window_s``, ``busy_s``, ``records``
    (device records in the window) and ``breakdown``; seconds."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    win = [e for e in events
           if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise ValueError(f"{len(win)} window annotations in {path}")
    w = win[0]
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    dev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
           for e in events if e.get("cat") in DEVICE_CATS]
    dev = [d for d in dev if d[1] > w0 and d[0] < w1]
    busy, gaps = busy_and_gaps([(s, e) for s, e, _ in dev], w0, w1)
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
            for e in events if e.get("cat") in HOST_CATS
            and e.get("tid") == w.get("tid") and e.get("pid") == w.get("pid")]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy * 1e-6,
        "records": len(dev),
        "breakdown": {
            "device_ops": _top((n, (e - s) * 1e-6) for s, e, n in dev),
            "idle_gaps": _top((n, d * 1e-6) for n, d in label_gaps(gaps, host)),
        },
    }
