"""`python -m portbench ...` runs one cell once (portbench/run.py)."""

import sys
import time

_START = time.monotonic()

if __name__ == "__main__":
    from portbench import harness
    sys.exit(harness.main(sys.argv[1:], start=_START))
