"""Puts the checkout's root (for ``bench``) and ``src`` (for the program)
on the path of the benchmark's own tests, which the repository's test run
does not collect: ``python -m pytest -q bench/tests`` from the root."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
