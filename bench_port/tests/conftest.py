"""The harness's tests run on the CPU at tiny sizes; those that need the
card carry the ``gpu`` marker and skip without one."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (os.path.dirname(BENCH), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)
