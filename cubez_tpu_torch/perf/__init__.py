"""The perf layer (PyTorch port of ``cubez_tpu/perf``): the PMlib-style
monitor and report (pmlib.py), the analytic cost model (roofline.py), the
memory estimate (memory.py), measured per-phase profiles of a solve
(profile.py, behind the CLI's ``--profile``), the weak-scaling harness
(scaling.py), and the spans and counters of the port's own solves
(spans.py)."""
