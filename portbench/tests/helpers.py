"""Helpers of the benchmark's tests: run a piece of the benchmark in a
fresh interpreter from the checkout's root, as the driver runs it."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_python(code: str, cwd: str = ROOT, timeout: int = 600, env=None):
    """Run `code` in a new interpreter at `cwd`; (returncode, stdout,
    stderr)."""
    e = dict(os.environ, OMP_NUM_THREADS="2", **(env or {}))
    proc = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=timeout)
    return proc.returncode, proc.stdout, proc.stderr


def last_json(stdout: str):
    return json.loads(stdout.strip().splitlines()[-1])


