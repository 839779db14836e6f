"""portbench's tests: run from the repo root with
``python -m pytest portbench/tests -q`` (the repo's ``pytest tests/``
does not collect them)."""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (HERE, os.path.dirname(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)
