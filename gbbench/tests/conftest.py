"""The benchmark's own tests: ``python -m pytest gbbench/tests -q`` (the
``gpu`` tests skip without a card; on one they run the cells at a small
scale)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
