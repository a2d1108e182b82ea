"""Append-only spill store with an in-memory window and async disk flush.

The TPU build's analogue of the reference's mesher reorder buffer plus
TmpWriterWorkerGroup (src/mesher.h:514-620, --mem-reorder): producers append
record batches and get back stable byte offsets; data stays in RAM up to a
byte budget, beyond which a background thread streams the oldest buffers to
an unlinked temp file. Reads (the final write pass) see a consistent view
across the disk/memory boundary. Appends block when the in-memory window is
full and the flusher is behind (CircularBuffer-style backpressure).
"""

from __future__ import annotations

import bisect
import os
import queue
import threading
from typing import List, Optional

from mlsgpu_tpu_torch.utils.misc import create_tmp_file
from mlsgpu_tpu_torch.utils.statistics import get_registry


class SpillStore:
    def __init__(self, prefix: str, mem_budget: int = 1 << 30):
        self._path = create_tmp_file(prefix)
        self._file = open(self._path, "r+b")
        self._budget = int(mem_budget)
        self._lock = threading.Condition()
        self._mem: List[bytes] = []        # pending buffers, append order
        self._mem_offsets: List[int] = []  # start offset of each buffer
        self._mem_bytes = 0
        self._disk_end = 0                 # all bytes < this are on disk
        self._end = 0                      # total bytes appended
        self._allocated = 0                # fallocated file bytes
        self._error: Optional[BaseException] = None
        self._closed = False
        self._flusher: Optional[threading.Thread] = None
        self._stats = get_registry()
        # reorder-window memory accounting (reference Statistics::Peak via
        # the allocator, src/allocator.h:58-250)
        self._peak = self._stats.peak("mem.spill")

    @property
    def path(self) -> str:
        return self._path

    def size(self) -> int:
        return self._end

    def _pwrite(self, data: bytes, off: int) -> None:
        """Positional write on the fd — no shared file position and no
        userspace buffer, so concurrent read()s (which use pread) always
        see every flushed byte."""
        fd = self._file.fileno()
        view = memoryview(data)
        while len(view):
            n = os.pwrite(fd, view, off)
            view = view[n:]
            off += n

    # ------------------------------------------------------------- producer
    def append(self, data) -> int:
        """Append bytes (or a numpy array's raw bytes); returns the offset."""
        data = data.tobytes() if hasattr(data, "tobytes") else bytes(data)
        with self._lock:
            if self._error:
                raise self._error
            off = self._end
            self._mem.append(data)
            self._mem_offsets.append(off)
            self._mem_bytes += len(data)
            self._end += len(data)
            self._peak.add(len(data))
            if self._mem_bytes > self._budget and self._flusher is None:
                self._flusher = threading.Thread(
                    target=self._flush_loop, name="spill-flusher", daemon=True)
                self._flusher.start()
            self._lock.notify_all()
            # Backpressure: block while we are 2x over budget and flushing.
            while (self._mem_bytes > 2 * self._budget
                   and self._flusher is not None and self._error is None):
                self._lock.wait(timeout=0.5)
            if self._error:
                raise self._error
        return off

    def _flush_loop(self) -> None:
        import time as _time
        stats_timer = self._stats.timer("spill.flush")
        # On a 1-core host the flusher's WALL time is dominated by GIL
        # waits while the main thread computes (measured: 503 s wall at
        # 100M vs ~33 s of actual IO at the disk's 538 MB/s). Record CPU
        # seconds and bytes alongside so the dump separates real work from
        # scheduling (the r4 number read as a host-side bottleneck it
        # is not).
        cpu_var = self._stats.variable("spill.flushCpu")
        bytes_ctr = self._stats.counter("spill.flushBytes")
        while True:
            with self._lock:
                while (self._mem_bytes <= self._budget // 2
                       and not self._closed):
                    self._lock.wait()
                if not self._mem:
                    if self._closed:
                        return
                    continue
                data = self._mem[0]
                off = self._mem_offsets[0]
            try:
                t_cpu = _time.thread_time()
                with stats_timer:
                    # Preallocate ahead in 64 MiB steps: appends into
                    # unallocated space run ~300x slower than into
                    # fallocated blocks on thin-provisioned disks (see
                    # binary.SyscallWriter.resize).
                    end = off + len(data)
                    if end > self._allocated:
                        new_alloc = max(end, self._allocated + (64 << 20))
                        try:
                            os.posix_fallocate(self._file.fileno(), 0,
                                               new_alloc)
                            self._allocated = new_alloc
                        except OSError:
                            self._allocated = 1 << 62  # stop trying
                    self._pwrite(data, off)
                cpu_var.add(_time.thread_time() - t_cpu)
                bytes_ctr.add(len(data))
            except BaseException as e:
                with self._lock:
                    self._error = e
                    self._lock.notify_all()
                return
            with self._lock:
                self._mem.pop(0)
                self._mem_offsets.pop(0)
                self._mem_bytes -= len(data)
                self._peak.add(-len(data))
                self._disk_end = off + len(data)
                self._lock.notify_all()

    # ------------------------------------------------------------- consumer
    def freeze(self) -> None:
        """Stop the background flusher; remaining data stays in memory and
        reads become safe from any thread."""
        with self._lock:
            self._closed = True
            self._lock.notify_all()
            t = self._flusher
            self._flusher = None
        if t is not None:
            t.join()
        if self._error:
            raise self._error

    def read(self, offset: int, nbytes: int) -> bytes:
        """Read a byte range of already-appended data. Safe concurrently
        with ongoing appends and the background flusher (the eager chunk
        writer reads a finished chunk's records while later chunks still
        append): the memory window is snapshotted under the lock (bytes
        objects stay valid even once the flusher pops them), and the disk
        part uses pread so no file position is shared with the flusher.
        Ranges may span the disk/memory boundary and multiple appends."""
        end = offset + nbytes
        with self._lock:
            if self._error:
                raise self._error
            if end > self._end:
                raise EOFError(
                    f"spill read past end: wanted [{offset}, {end}), "
                    f"have {self._end}")
            disk_end = self._disk_end
            parts = []
            if end > disk_end and self._mem:
                lo_off = max(offset, disk_end)
                i = max(bisect.bisect_right(self._mem_offsets, lo_off) - 1, 0)
                while i < len(self._mem):
                    start = self._mem_offsets[i]
                    if start >= end:
                        break
                    parts.append((start, self._mem[i]))
                    i += 1
        out = bytearray()
        if offset < disk_end:
            n = min(end, disk_end) - offset
            out += os.pread(self._file.fileno(), n, offset)
            offset += n
        for start, buf in parts:
            if offset >= end:
                break
            lo = offset - start
            hi = min(end - start, len(buf))
            if lo < 0 or lo >= hi:
                continue
            out += buf[lo:hi]
            offset = start + hi
        if len(out) != nbytes:
            raise EOFError(
                f"spill read past end: wanted [{end - nbytes}, {end}), "
                f"have {self._end}")
        return bytes(out)

    def flush_all(self) -> str:
        """Force every byte to disk (checkpoint path); returns the file."""
        self.freeze()
        if self._end > self._allocated:
            try:
                os.posix_fallocate(self._file.fileno(), 0, self._end)
                self._allocated = self._end
            except OSError:
                pass
        for off, data in zip(self._mem_offsets, self._mem):
            self._pwrite(data, off)
        self._file.flush()
        self._disk_end = self._end
        self._mem = []
        self._mem_offsets = []
        self._mem_bytes = 0
        return self._path

    @classmethod
    def from_file(cls, path: str) -> "SpillStore":
        """Open an existing fully-flushed spill file read-only (resume)."""
        store = cls.__new__(cls)
        store._path = path
        store._file = open(path, "rb")
        store._budget = 0
        store._lock = threading.Condition()
        store._mem = []
        store._mem_offsets = []
        store._mem_bytes = 0
        store._end = store._disk_end = os.path.getsize(path)
        store._error = None
        store._closed = True
        store._flusher = None
        store._stats = get_registry()
        return store

    def cleanup(self) -> None:
        try:
            self.freeze()
        except BaseException:
            pass
        try:
            self._file.close()
        except OSError:
            pass
        try:
            os.remove(self._path)
        except OSError:
            pass
