"""The benchmark's own CPU tests: the harness's folder and the checkout on
sys.path, as czbench/run.py puts them."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)
