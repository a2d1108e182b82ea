"""What a worker process imports before its first block, timed.

Imported first by a worker process (pipeline/worker_start.boot), or once
by the server that worker processes are forked from, which then carries
the imports and `MARKS` into every process it forks. `MARKS` holds the
monotonic clock (shared by every process of the machine) when the
import began, when torch was imported and when the block step's modules
were.
"""

import time

MARKS = {"up": time.monotonic()}

import torch  # noqa: E402,F401

MARKS["torch"] = time.monotonic()

from mlsgpu_tpu_torch.ops import block  # noqa: E402,F401
from mlsgpu_tpu_torch.pipeline import workers  # noqa: E402,F401

MARKS["modules"] = time.monotonic()
