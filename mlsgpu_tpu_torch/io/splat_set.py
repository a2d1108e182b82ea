"""Splat sources: uniform access to in-memory and multi-file splat streams.

Re-creation of the reference's SplatSet models (src/splat_set.h:123-1150):
`SequenceSource` ~ SequenceSet (in-memory array), `FileSource` ~ FileSet
(multiple PLY files, global splat ids = concatenated stream order, chunked
streaming reads, random range reads for bucket loading). The blob
acceleration structure (FastBlobSet) lives in pipeline/blobs.py.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np

from mlsgpu_tpu_torch.io.ply import PlyReader

DEFAULT_CHUNK = 4 * 1024 * 1024  # splats per streaming chunk


class SplatSource:
    """Abstract splat stream with random range access."""

    def __len__(self) -> int:
        raise NotImplementedError

    def iter_chunks(self, chunk_size: int = DEFAULT_CHUNK
                    ) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield (first_global_id, (N, 8) splats) in stream order."""
        raise NotImplementedError

    def read_ranges(self, ranges: Sequence[Tuple[int, int]]) -> np.ndarray:
        """Concatenate splats for [first, last) global-id ranges."""
        raise NotImplementedError

    def read_ranges_into(self, ranges: Sequence[Tuple[int, int]],
                         out: np.ndarray) -> None:
        """read_ranges into `out`, an (N, 8) f32 array of the ranges' total
        length (a shared-memory buffer: the streamer's loader). Sources
        that can write there directly do; this default copies."""
        out[...] = self.read_ranges(ranges)

    def close(self) -> None:
        pass


class SequenceSource(SplatSource):
    """In-memory (N, 8) splat array as a source (SequenceSet equivalent)."""

    def __init__(self, splats: np.ndarray):
        self._data = np.asarray(splats, dtype=np.float32)

    def __len__(self) -> int:
        return len(self._data)

    def iter_chunks(self, chunk_size: int = DEFAULT_CHUNK):
        for start in range(0, len(self._data), chunk_size):
            yield start, self._data[start:start + chunk_size]

    def read_ranges(self, ranges):
        if not len(ranges):
            return np.empty((0, 8), np.float32)
        return np.concatenate([self._data[a:b] for a, b in ranges])

    def read_ranges_into(self, ranges, out):
        if len(ranges):
            np.concatenate([self._data[a:b] for a, b in ranges], out=out)


class FileSource(SplatSource):
    """Multiple PLY files as one concatenated stream (FileSet equivalent,
    src/splat_set.h:389-651). Global splat id = position in the concatenation
    (the reference packs file/offset into one id with scanIdShift=40; a plain
    64-bit stream index + binary search achieves the same addressing)."""

    def __init__(self, paths: Sequence[str], smooth: float = 1.0,
                 max_radius: float = float("inf"), reader_type: str = "syscall"):
        from mlsgpu_tpu_torch.io.binary import make_reader
        self._readers: List[PlyReader] = [
            PlyReader(p, smooth, max_radius, reader=make_reader(reader_type))
            for p in paths
        ]
        counts = np.array([len(r) for r in self._readers], dtype=np.int64)
        self._starts = np.concatenate([[0], np.cumsum(counts)])

    def __len__(self) -> int:
        return int(self._starts[-1])

    def iter_chunks(self, chunk_size: int = DEFAULT_CHUNK):
        for fi, reader in enumerate(self._readers):
            base = int(self._starts[fi])
            for first in range(0, len(reader), chunk_size):
                last = min(first + chunk_size, len(reader))
                yield base + first, reader.read(first, last)

    def read_ranges(self, ranges):
        out = np.empty((sum(b - a for a, b in ranges), 8), np.float32)
        self.read_ranges_into(ranges, out)
        return out

    def read_ranges_into(self, ranges, out):
        """One read per range, but one decode per run of ranges in one
        file, straight into `out` (a bucket lists hundreds of ranges)."""
        row = 0
        for fi, pieces in self._by_file(ranges):
            reader = self._readers[fi]
            raw = b"".join(reader.read_raw(a, b) for a, b in pieces)
            n = sum(b - a for a, b in pieces)
            reader.decode(raw, out=out[row:row + n])
            row += n

    def _by_file(self, ranges):
        """`ranges` cut at file ends, file-local, as (file index, ranges)
        runs in the order given."""
        runs: List[Tuple[int, List[Tuple[int, int]]]] = []
        for a, b in ranges:
            while a < b:
                fi = int(np.searchsorted(self._starts, a, side="right") - 1)
                base = int(self._starts[fi])
                stop = min(b, int(self._starts[fi + 1]))
                if not runs or runs[-1][0] != fi:
                    runs.append((fi, []))
                runs[-1][1].append((a - base, stop - base))
                a = stop
        return runs

    def close(self) -> None:
        for r in self._readers:
            r.close()
