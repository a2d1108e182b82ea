"""Page-cache eviction for cold-cache benchmarking (reference
src/decache.{h,cpp}: posix_fadvise(DONTNEED) on input files, --decache)."""

from __future__ import annotations

import os

from mlsgpu_tpu_torch.utils import logging as log


def decache(path: str) -> bool:
    """Drop the OS page cache for a file. Returns False when unsupported."""
    if not hasattr(os, "posix_fadvise"):
        return False
    fd = os.open(path, os.O_RDONLY)
    try:
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        return True
    except OSError as e:
        log.debug(f"decache({path}) failed: {e}")
        return False
    finally:
        os.close(fd)


def decache_all(paths) -> int:
    """Evict a list of files; returns how many succeeded."""
    return sum(1 for p in paths if decache(p))
