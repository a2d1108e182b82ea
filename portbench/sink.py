"""Where a job's mesh goes instead of the disk: a byte buffer the benchmark
owns, written through the program's own PLY writer.

`MemorySink` has the interface of the program's binary writers (open,
resize, write at an offset, close), so `PlyWriter(writer=sink)` writes into
it exactly the bytes it would write to a file. The buffer is made once and
touched in set-up, and every job writes over it, so the window pays no page
faults for it; its bytes are taken off the run's peak RSS.
"""

from __future__ import annotations

import numpy as np


class MemorySink:
    """One reusable buffer standing in for the output file."""

    def __init__(self, capacity: int = 0):
        self._buf = np.zeros(0, dtype=np.uint8)
        self.size = 0
        self.reserve(capacity)

    @property
    def nbytes(self) -> int:
        """The bytes the buffer holds resident."""
        return int(self._buf.nbytes)

    def reserve(self, capacity: int) -> None:
        """Grow the buffer to `capacity` bytes and touch every page."""
        if capacity > len(self._buf):
            buf = np.ones(int(capacity), dtype=np.uint8)
            buf[:self.size] = self._buf[:self.size]
            self._buf = buf

    # the program's BinaryWriter interface
    def open(self, path: str) -> None:
        self.size = 0

    def resize(self, size: int) -> None:
        self.reserve(size)
        self.size = int(size)

    def write(self, offset: int, data) -> None:
        view = np.frombuffer(data, dtype=np.uint8)
        end = offset + len(view)
        if end > self.size:
            raise ValueError(f"write past the file's end ({end} > "
                             f"{self.size})")
        self._buf[offset:end] = view

    def close(self) -> None:
        pass

    def contents(self) -> np.ndarray:
        """The file as written (a view of the buffer)."""
        return self._buf[:self.size]
