"""Build/run provenance embedded in outputs (reference src/provenance.*,
waf-tools/provenance.py: version + variant + full command line recorded in
both the statistics dump and PLY comments)."""

from __future__ import annotations

import subprocess
import sys
from typing import List


def version() -> str:
    from mlsgpu_tpu_torch import __version__
    git = ""
    try:
        git = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=__file__.rsplit("/", 3)[0]).stdout.strip()
    except Exception:
        pass
    return f"mlsgpu_tpu {__version__}" + (f" ({git})" if git else "")


def comments(argv: List[str] = None) -> List[str]:
    argv = argv if argv is not None else sys.argv
    return [
        f"generated by {version()}",
        "command: " + " ".join(argv),
    ]
