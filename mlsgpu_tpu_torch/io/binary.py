"""Thread-safe absolute-offset binary file access with pluggable backends.

Re-creation of src/binary_io.{h,cpp}: readers/writers address the file by
absolute offset (pread/pwrite semantics) so multiple threads can use one
handle; backends are selectable (--reader/--writer): 'mmap' (numpy memmap),
'syscall' (os.pread/pwrite — the reference's default). In-memory fakes for
tests live here too (the test/memory_reader.h / memory_writer.h analogues).
"""

from __future__ import annotations

import io
import mmap as _mmap
import os
import threading
from typing import Dict, Optional


class BinaryReader:
    def open(self, path: str) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def read(self, offset: int, length: int) -> bytes:
        raise NotImplementedError


class SyscallReader(BinaryReader):
    """pread-backed reader (reference SYSCALL_READER, the default)."""

    def __init__(self):
        self._fd: Optional[int] = None

    def open(self, path: str) -> None:
        self._fd = os.open(path, os.O_RDONLY)

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def size(self) -> int:
        return os.fstat(self._fd).st_size

    def read(self, offset: int, length: int) -> bytes:
        out = b""
        while len(out) < length:
            chunk = os.pread(self._fd, length - len(out), offset + len(out))
            if not chunk:
                raise IOError("short read")
            out += chunk
        return out


class MmapReader(BinaryReader):
    """mmap-backed reader (reference MMAP_READER)."""

    def __init__(self):
        self._mm = None
        self._f = None

    def open(self, path: str) -> None:
        self._f = open(path, "rb")
        self._mm = _mmap.mmap(self._f.fileno(), 0, access=_mmap.ACCESS_READ)

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._f.close()
            self._mm = self._f = None

    def size(self) -> int:
        return len(self._mm)

    def read(self, offset: int, length: int) -> bytes:
        return self._mm[offset:offset + length]


class MemoryReader(BinaryReader):
    """In-RAM reader over a bytes object (test/memory_reader.h:44-60)."""

    def __init__(self, data: bytes = b"", store: Optional[Dict[str, bytes]] = None):
        self._data = data
        self._store = store

    def open(self, path: str) -> None:
        if self._store is not None:
            self._data = self._store[path]

    def close(self) -> None:
        pass

    def size(self) -> int:
        return len(self._data)

    def read(self, offset: int, length: int) -> bytes:
        if offset + length > len(self._data):
            raise IOError("read past end")
        return self._data[offset:offset + length]


class BinaryWriter:
    def open(self, path: str) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    def resize(self, size: int) -> None:
        raise NotImplementedError

    def write(self, offset: int, data: bytes) -> None:
        raise NotImplementedError


class SyscallWriter(BinaryWriter):
    """pwrite-backed writer (reference SYSCALL_WRITER, the default). Multiple
    threads may write disjoint ranges concurrently."""

    def __init__(self):
        self._fd: Optional[int] = None

    def open(self, path: str) -> None:
        self._fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o644)

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def resize(self, size: int) -> None:
        os.ftruncate(self._fd, size)
        # Allocate real blocks: writes into sparse (truncate-only) regions
        # pay per-page allocation on thin-provisioned disks — measured
        # 13 MB/s sparse vs ~4 GB/s fallocated on this platform.
        if size > 0:
            try:
                os.posix_fallocate(self._fd, 0, size)
            except OSError:
                pass  # fs without fallocate: sparse writes still correct

    def write(self, offset: int, data: bytes) -> None:
        view = memoryview(data)
        while len(view):
            n = os.pwrite(self._fd, view, offset)
            view = view[n:]
            offset += n


class MemoryWriter(BinaryWriter):
    """Captures output in a filename -> bytearray map so whole-pipeline tests
    can inspect 'files' in memory (test/memory_writer.h:50-75)."""

    def __init__(self, store: Dict[str, bytearray]):
        self._store = store
        self._buf: Optional[bytearray] = None
        self._lock = threading.Lock()

    def open(self, path: str) -> None:
        self._buf = bytearray()
        self._store[path] = self._buf

    def close(self) -> None:
        self._buf = None

    def resize(self, size: int) -> None:
        with self._lock:
            if len(self._buf) < size:
                self._buf.extend(b"\0" * (size - len(self._buf)))
            else:
                del self._buf[size:]

    def write(self, offset: int, data: bytes) -> None:
        with self._lock:
            end = offset + len(data)
            if len(self._buf) < end:
                self._buf.extend(b"\0" * (end - len(self._buf)))
            self._buf[offset:end] = data


class StreamReader(BinaryReader):
    """Buffered-stream reader with a seek+read under a lock (reference
    STREAM_READER, src/binary_io.h:42-71). The syscall reader is usually
    faster for the random ranged reads the loader issues; this backend
    exists for filesystems where buffered IO wins (many tiny ranges)."""

    def __init__(self):
        self._f = None
        self._lock = threading.Lock()

    def open(self, path: str) -> None:
        self._f = open(path, "rb", buffering=1 << 20)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def size(self) -> int:
        with self._lock:
            pos = self._f.tell()
            self._f.seek(0, os.SEEK_END)
            n = self._f.tell()
            self._f.seek(pos)
            return n

    def read(self, offset: int, nbytes: int) -> bytes:
        with self._lock:
            self._f.seek(offset)
            return self._f.read(nbytes)


class StreamWriter(BinaryWriter):
    """Buffered-stream writer (reference STREAM_WRITER): seek+write under a
    lock; resize via truncate."""

    def __init__(self):
        self._f = None
        self._lock = threading.Lock()

    def open(self, path: str) -> None:
        self._f = open(path, "w+b", buffering=1 << 20)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def resize(self, size: int) -> None:
        with self._lock:
            self._f.truncate(size)
            if size > 0:
                try:
                    os.posix_fallocate(self._f.fileno(), 0, size)
                except (OSError, AttributeError):
                    pass

    def write(self, offset: int, data: bytes) -> None:
        with self._lock:
            self._f.seek(offset)
            self._f.write(data)


READER_TYPES = {"syscall": SyscallReader, "mmap": MmapReader,
                "stream": StreamReader}
WRITER_TYPES = {"syscall": SyscallWriter, "stream": StreamWriter}


def make_reader(kind: str = "syscall") -> BinaryReader:
    return READER_TYPES[kind]()


def make_writer(kind: str = "syscall") -> BinaryWriter:
    return WRITER_TYPES[kind]()
