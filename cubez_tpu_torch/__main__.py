"""``python -m cubez_tpu_torch`` — the reference's ``./cz`` CLI (main.cpp:19-30)."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
