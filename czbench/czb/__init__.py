"""The benchmark harness of cubez_tpu_torch (see czbench/README.md)."""
