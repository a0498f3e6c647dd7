"""The benchmark's own tests (CPU; ``-m cuda`` ones on the card). Run from
the checkout's root: ``python -m pytest -q fedbench/tests``."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
