"""Background-thread writer (reference AsyncWriter, src/async_io.{h,cpp}):
callers obtain byte buffers, fill them, and enqueue (writer, offset) jobs;
a worker thread performs the writes so the producer never blocks on disk.
Bounded memory via a fixed buffer pool (the reference's CircularBuffer
backing)."""

from __future__ import annotations

import queue
import threading
from typing import Optional

from mlsgpu_tpu_torch.utils.errors import StateError
from mlsgpu_tpu_torch.utils.statistics import get_registry


class AsyncWriter:
    def __init__(self, n_buffers: int = 2, buffer_size: int = 32 * 1024 * 1024):
        self._free: "queue.Queue" = queue.Queue()
        for _ in range(n_buffers):
            self._free.put(bytearray(buffer_size))
        self._jobs: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.buffer_size = buffer_size

    def start(self) -> None:
        if self._thread is not None:
            raise StateError("AsyncWriter already started")
        self._thread = threading.Thread(target=self._run, name="async-writer",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        stats = get_registry()
        while True:
            job = self._jobs.get()
            if job is None:
                return
            writer, offset, buf, length = job
            try:
                with stats.timer("asyncWriter.write"):
                    # zero-copy: every backend accepts buffer objects
                    writer.write(offset, memoryview(buf)[:length])
            except BaseException as e:  # surfaced on stop()
                self._error = e
            self._free.put(buf)

    def get(self, nbytes: int) -> bytearray:
        """Block until a pooled buffer is free (backpressure)."""
        if nbytes > self.buffer_size:
            raise ValueError("request exceeds buffer size")
        return self._free.get()

    def push(self, writer, offset: int, buf: bytearray, length: int) -> None:
        if self._thread is None:
            raise StateError("AsyncWriter not started")
        self._jobs.put((writer, offset, buf, length))

    def stop(self) -> None:
        if self._thread is None:
            return
        self._jobs.put(None)
        self._thread.join()
        self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
