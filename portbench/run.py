"""Run one cell of the port's benchmark once: see portbench/harness.py.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Importing this file only defines `main`: a worker process of the program
imports a script's main module again, and must find nothing to run.
"""

import os
import sys
import time

_START = time.monotonic()
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def main() -> int:
    from portbench import harness
    return harness.main(sys.argv[1:], start=_START)


if __name__ == "__main__":
    sys.exit(main())
