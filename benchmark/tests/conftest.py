"""Shared set-up of the benchmark's own tests (run with
``python -m pytest benchmark/tests``; the card's cases with ``-m cuda``)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
