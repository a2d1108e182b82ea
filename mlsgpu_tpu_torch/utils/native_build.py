"""Race-free builds of the port's shared libraries (the native host library
and the CUDA kernel library).

Several processes may ask for the same library at once (pytest workers, the
threads and processes of one run). Each build therefore runs under an
exclusive `fcntl.flock` on a lock file beside the target, compiles into a
file of its own (named after the process and thread) and moves it into place
with `os.replace`, so no process ever opens a half-written library; once the
lock is held, freshness is checked again, so a library another process just
built is not built twice.

Libraries go to `mlsgpu_tpu_torch/_build/`, or to the directory named by the
environment variable MLSGPU_TORCH_BUILD_DIR.
"""

from __future__ import annotations

import fcntl
import os
import threading
from typing import Callable, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_BUILD_DIR = os.path.join(_PKG, "_build")
BUILD_DIR_ENV = "MLSGPU_TORCH_BUILD_DIR"


def build_dir() -> str:
    """The directory libraries are built into: the environment's
    MLSGPU_TORCH_BUILD_DIR, else the package's `_build/`."""
    return os.environ.get(BUILD_DIR_ENV) or DEFAULT_BUILD_DIR


def is_fresh(target: str, sources: Sequence[str]) -> bool:
    """True when `target` exists and is not older than any source."""
    if not os.path.exists(target):
        return False
    t = os.path.getmtime(target)
    return all(os.path.getmtime(s) <= t for s in sources)


def build_locked(target: str, sources: Sequence[str],
                 compile_into: Callable[[str], None],
                 force: bool = False) -> bool:
    """Make `target` from `sources` unless it is fresh (always when
    `force`). `compile_into(path)` writes the library to `path` and raises
    on failure. Returns True when this call built it."""
    if not force and is_fresh(target, sources):
        return False
    os.makedirs(os.path.dirname(target), exist_ok=True)
    with open(target + ".lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not force and is_fresh(target, sources):
                return False  # another process built it while we waited
            tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
            try:
                compile_into(tmp)
                os.replace(tmp, target)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            return True
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
