"""Small arithmetic and filesystem helpers.

Covers the roles of the reference's src/misc.h:45-150 (divUp/roundUp/divDown,
tmp-file handling). The magic-number division tricks (DownDivider) are
unnecessary in Python/JAX and intentionally omitted.
"""

from __future__ import annotations

import glob
import os
import tempfile

_tmp_dir: str | None = None


def div_up(a: int, b: int) -> int:
    """Ceiling division for non-negative a, positive b."""
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    """Round a up to the next multiple of b."""
    return div_up(a, b) * b


def div_down(a: int, b: int) -> int:
    """Floor division that is correct for negative a (like src/misc.h:136)."""
    return a // b


_LIBC = None


def malloc_trim() -> bool:
    """Return glibc-freed heap spans to the OS (malloc_trim(0)).

    The streaming pipeline churns tens of MB of short-lived host buffers
    per block (h2d staging, readback decode, mesher scratch); glibc's brk
    heap retains the freed spans, and at 1B-splat scale the retained-free
    high water grew ~28 MB per block (~70 GB projected; measured round 4).
    A periodic trim caps RSS at the true live set for ~ms of work. No-op
    (returns False) on non-glibc platforms."""
    global _LIBC
    try:
        if _LIBC is None:
            import ctypes
            _LIBC = ctypes.CDLL("libc.so.6")
        return bool(_LIBC.malloc_trim(0))
    except Exception:
        return False


def bound_mmap_threshold(limit: int = 128 * 1024) -> bool:
    """Pin glibc's M_MMAP_THRESHOLD so multi-MB buffers stay mmap-backed.

    glibc adapts the mmap threshold upward (to 32 MB) whenever an mmap'd
    chunk is freed, after which the pipeline's cycling per-block buffers
    (~13 MB splat loads, readback scratch) are served from the brk heap.
    Freed mid-heap chunks can never be returned to the OS (malloc_trim only
    releases the top span), so at 1B-splat scale the heap ballooned to
    ~31 GB of dead space (measured round 4, /proc/smaps: 31.4 GB [heap]
    against a ~5 GB live set). Pinning the threshold via mallopt also
    disables the dynamic adjustment, so every large buffer is munmap'd
    straight back to the OS on free. Costs page-fault zeroing per alloc —
    noise against ~1 s/block. No-op (False) on non-glibc platforms."""
    global _LIBC
    try:
        if _LIBC is None:
            import ctypes
            _LIBC = ctypes.CDLL("libc.so.6")
        M_MMAP_THRESHOLD = -3
        M_MMAP_MAX = -4
        ok = bool(_LIBC.mallopt(M_MMAP_THRESHOLD, int(limit)))
        # glibc's default M_MMAP_MAX is 65536 concurrent mmap'd chunks;
        # past it malloc silently falls back to brk and the dead-heap
        # pathology returns. The budgets keep live chunks far below that,
        # but the failure would be silent, so raise the cap outright.
        _LIBC.mallopt(M_MMAP_MAX, 1 << 20)
        return ok
    except Exception:
        return False


def child_pids() -> set:
    """The ids of this process's child processes that have not been waited
    for (Linux /proc; an empty set elsewhere)."""
    out = set()
    for path in glob.glob(f"/proc/{os.getpid()}/task/*/children"):
        try:
            with open(path) as f:
                out.update(int(p) for p in f.read().split())
        except OSError:
            pass
    return out


def next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def eighth_pow2_ceil(n: int) -> int:
    """Smallest eighth-pow2 step (k * 2^(p-3), k in 8..15) >= max(n, 1):
    at most 12.5% slop vs up to 100% for plain pow2, while keeping the
    set of distinct values (and hence compiled program shapes) small."""
    n = max(int(n), 1)
    p = next_pow2(n)
    step = max(p // 8, 1)
    return ((n + step - 1) // step) * step


def set_tmp_dir(path: str) -> None:
    """Set the directory used for temporary spill files (--tmp-dir)."""
    global _tmp_dir
    _tmp_dir = path


def get_tmp_dir() -> str:
    return _tmp_dir if _tmp_dir is not None else tempfile.gettempdir()


def create_tmp_file(prefix: str = "mlsgpu_tpu.") -> str:
    """Create a named temporary file in the configured tmp dir, return its path.

    Mirrors createTmpFile (src/misc.cpp): the file persists until explicitly
    removed so it can back out-of-core spill data.
    """
    fd, path = tempfile.mkstemp(prefix=prefix, dir=get_tmp_dir())
    os.close(fd)
    return path
