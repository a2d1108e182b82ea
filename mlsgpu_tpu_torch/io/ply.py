"""Fast binary PLY reader/writer for splat clouds and meshes.

Re-creation of src/fast_ply.{h,cpp}: the reader parses the header once, then
reads raw fixed-stride vertex records and decodes them vectorized (numpy
replaces the OpenMP decode loop, src/splat_set.cpp:213). Requirements match
the reference (src/fast_ply.h:83-239): binary little-endian, the vertex
element first, properties x/y/z/nx/ny/nz/radius as float32 (any property
order, extra float32 properties tolerated — their bytes are skipped).

The writer emits the reference's fixed output format (src/fast_ply.h:241-330):
binary little-endian, float32 x/y/z vertices, uint8-count uint32-index
triangle lists, with counts known up front and thread-safe ranged writes so
chunks can be written concurrently and out of order.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from mlsgpu_tpu_torch.core.splat import decode_raw_splats
from mlsgpu_tpu_torch.io.binary import BinaryReader, BinaryWriter, make_reader, make_writer
from mlsgpu_tpu_torch.utils.errors import FormatError

_REQUIRED = ("x", "y", "z", "nx", "ny", "nz", "radius")
_TYPE_SIZES = {
    "int8": 1, "uint8": 1, "char": 1, "uchar": 1,
    "int16": 2, "uint16": 2, "short": 2, "ushort": 2,
    "int32": 4, "uint32": 4, "int": 4, "uint": 4,
    "float32": 4, "float": 4,
    "int64": 8, "uint64": 8, "float64": 8, "double": 8,
}
_FLOAT32 = ("float32", "float")

MAX_HEADER = 1 << 16


class PlyHeader:
    def __init__(self, vertex_count: int, vertex_size: int,
                 offsets: Dict[str, int], header_size: int,
                 triangle_count: int = 0):
        self.vertex_count = vertex_count
        self.vertex_size = vertex_size
        self.offsets = offsets  # property name -> byte offset in record
        self.header_size = header_size
        self.triangle_count = triangle_count


def parse_header(data: bytes, need_splat_fields: bool = True) -> PlyHeader:
    """Parse a PLY header from the first bytes of the file."""
    end_tag = b"end_header\n"
    idx = data.find(end_tag)
    if idx < 0:
        raise FormatError("end_header not found (header too large or not a PLY)")
    header_size = idx + len(end_tag)
    lines = data[:idx].decode("ascii", errors="replace").splitlines()
    if not lines or lines[0].strip() != "ply":
        raise FormatError("missing ply signature")

    fmt = None
    elements: List[Tuple[str, int]] = []
    props: Dict[str, List[Tuple[str, str]]] = {}
    cur: Optional[str] = None
    for line in lines[1:]:
        tokens = line.split()
        if not tokens or tokens[0] == "comment" or tokens[0] == "obj_info":
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            cur = tokens[1]
            elements.append((cur, int(tokens[2])))
            props[cur] = []
        elif tokens[0] == "property":
            if cur is None:
                raise FormatError("property before element")
            if tokens[1] == "list":
                props[cur].append(("list", tokens[-1]))
            else:
                props[cur].append((tokens[1], tokens[2]))
    if fmt != "binary_little_endian":
        raise FormatError(f"unsupported format {fmt!r} (need binary_little_endian)")
    if not elements:
        raise FormatError("no elements")
    name0, count0 = elements[0]
    if name0 != "vertex":
        raise FormatError("vertex element must come first")

    offsets: Dict[str, int] = {}
    pos = 0
    for ptype, pname in props["vertex"]:
        if ptype == "list":
            raise FormatError("list property in vertex element")
        size = _TYPE_SIZES.get(ptype)
        if size is None:
            raise FormatError(f"unknown type {ptype}")
        if pname in _REQUIRED and ptype not in _FLOAT32:
            raise FormatError(f"property {pname} must be float32")
        offsets[pname] = pos
        pos += size
    if need_splat_fields:
        for req in _REQUIRED:
            if req not in offsets:
                raise FormatError(f"missing property {req}")

    tri_count = 0
    for name, count in elements[1:]:
        if name in ("face", "triangle"):
            tri_count = count
    return PlyHeader(count0, pos, offsets, header_size, tri_count)


class PlyReader:
    """Streaming splat reader (FastPly::Reader equivalent).

    read_raw/decode are split like the reference (src/fast_ply.h:148) so the
    raw byte fetch can be overlapped with decode by the pipeline.
    """

    def __init__(self, path: str, smooth: float = 1.0,
                 max_radius: float = float("inf"),
                 reader: Optional[BinaryReader] = None):
        self.path = path
        self.smooth = smooth
        self.max_radius = max_radius
        self._reader = reader if reader is not None else make_reader()
        self._reader.open(path)
        head = self._reader.read(0, min(MAX_HEADER, self._reader.size()))
        self.header = parse_header(head)
        if self._reader.size() < (self.header.header_size
                                  + self.header.vertex_count * self.header.vertex_size):
            raise FormatError(f"{path}: file too small for declared vertex count")

    def __len__(self) -> int:
        return self.header.vertex_count

    def close(self) -> None:
        self._reader.close()

    def read_raw(self, first: int, last: int) -> bytes:
        h = self.header
        return self._reader.read(h.header_size + first * h.vertex_size,
                                 (last - first) * h.vertex_size)

    def decode(self, raw: bytes, out: Optional[np.ndarray] = None
               ) -> np.ndarray:
        """Decode raw records -> (N, 8) splats (vectorized FastPly decode +
        radius clamp/smooth + quality, src/fast_ply.cpp:334-350), into
        `out` when given (C-contiguous (N, 8) f32). Uses the native decoder
        when built; numpy strided-view fallback otherwise."""
        h = self.header
        n = len(raw) // h.vertex_size
        try:
            from mlsgpu_tpu_torch import _native as nat
            offsets = np.array(
                [h.offsets[k] for k in ("x", "y", "z", "nx", "ny", "nz",
                                        "radius")], dtype=np.int64)
            got = nat.decode_splats(raw, n, h.vertex_size, offsets,
                                    self.smooth, self.max_radius, out=out)
            if got is not None:
                return got
        except Exception:
            pass
        if out is not None:
            out[...] = self.decode(raw)
            return out
        buf = np.frombuffer(raw, dtype=np.uint8).reshape(-1, h.vertex_size)
        fields = np.empty((buf.shape[0], 7), dtype=np.float32)
        for i, name in enumerate(("x", "y", "z", "nx", "ny", "nz", "radius")):
            off = h.offsets[name]
            fields[:, i] = buf[:, off:off + 4].reshape(-1).view(np.float32).reshape(-1)
        return decode_raw_splats(fields, self.smooth, self.max_radius)

    def read(self, first: int = 0, last: Optional[int] = None) -> np.ndarray:
        if last is None:
            last = len(self)
        return self.decode(self.read_raw(first, last))


class PlyWriter:
    """Mesh writer with up-front counts and thread-safe ranged writes
    (FastPly::Writer equivalent, src/fast_ply.h:241-330)."""

    VERTEX_SIZE = 12   # 3 * float32
    TRIANGLE_SIZE = 13  # uint8 count + 3 * uint32

    def __init__(self, writer: Optional[BinaryWriter] = None,
                 comments: Optional[List[str]] = None):
        self._writer = writer if writer is not None else make_writer()
        self.comments = list(comments or [])
        self._num_vertices = 0
        self._num_triangles = 0
        self._vertex_start = 0
        self._open = False

    def set_num_vertices(self, n: int) -> None:
        assert not self._open
        self._num_vertices = n

    def set_num_triangles(self, n: int) -> None:
        assert not self._open
        self._num_triangles = n

    def add_comment(self, comment: str) -> None:
        self.comments.append(comment)

    def _header(self) -> bytes:
        lines = ["ply", "format binary_little_endian 1.0"]
        lines += [f"comment {c}" for c in self.comments]
        lines += [
            f"element vertex {self._num_vertices}",
            "property float32 x", "property float32 y", "property float32 z",
            f"element face {self._num_triangles}",
            "property list uint8 uint32 vertex_indices",
            "end_header",
        ]
        return ("\n".join(lines) + "\n").encode("ascii")

    def open(self, path: str) -> None:
        header = self._header()
        self._writer.open(path)
        self._vertex_start = len(header)
        total = (self._vertex_start + self._num_vertices * self.VERTEX_SIZE
                 + self._num_triangles * self.TRIANGLE_SIZE)
        self._writer.resize(total)
        self._writer.write(0, header)
        self._open = True

    def vertex_byte_offset(self, first: int) -> int:
        """Absolute file offset of vertex record `first` (for external
        writers, e.g. AsyncWriter jobs against the raw BinaryWriter)."""
        return self._vertex_start + first * self.VERTEX_SIZE

    def triangle_byte_offset(self, first: int) -> int:
        return (self._vertex_start + self._num_vertices * self.VERTEX_SIZE
                + first * self.TRIANGLE_SIZE)

    def write_vertices(self, first: int, vertices: np.ndarray) -> None:
        data = np.ascontiguousarray(vertices, dtype="<f4")
        self._writer.write(self._vertex_start + first * self.VERTEX_SIZE,
                           data.tobytes())

    def write_triangles(self, first: int, triangles: np.ndarray,
                        offset: int = 0) -> None:
        tris = np.asarray(triangles, dtype=np.uint32) + np.uint32(offset)
        rec = np.empty((len(tris), self.TRIANGLE_SIZE), dtype=np.uint8)
        rec[:, 0] = 3
        rec[:, 1:] = tris.astype("<u4").view(np.uint8).reshape(len(tris), 12)
        start = (self._vertex_start + self._num_vertices * self.VERTEX_SIZE
                 + first * self.TRIANGLE_SIZE)
        self._writer.write(start, rec.tobytes())

    def close(self) -> None:
        if self._open:
            self._writer.close()
            self._open = False


def read_mesh(path: str):
    """Read back a mesh written by PlyWriter (used by tests and the
    plymanifold tool). Returns (vertices (N,3) f32, triangles (M,3) i64)."""
    reader = make_reader("mmap")
    reader.open(path)
    try:
        data = reader.read(0, min(MAX_HEADER, reader.size()))
        head = parse_header(data, need_splat_fields=False)
        nv, nt = head.vertex_count, head.triangle_count
        vbytes = reader.read(head.header_size, nv * 12)
        verts = np.frombuffer(vbytes, dtype="<f4").reshape(nv, 3).copy()
        tbytes = reader.read(head.header_size + nv * 12, nt * 13)
        rec = np.frombuffer(tbytes, dtype=np.uint8).reshape(nt, 13)
        if nt and not np.all(rec[:, 0] == 3):
            raise FormatError("non-triangle face")
        tris = rec[:, 1:].reshape(-1).view("<u4").reshape(nt, 3).astype(np.int64)
        return verts, tris
    finally:
        reader.close()


def write_splats_ply(path: str, splats: np.ndarray) -> None:
    """Write an (N, 8) splat array as a reference-compatible input PLY
    (x y z nx ny nz radius float32) — used by tests and bench data synthesis."""
    n = len(splats)
    header = "\n".join([
        "ply", "format binary_little_endian 1.0",
        f"element vertex {n}",
        "property float32 x", "property float32 y", "property float32 z",
        "property float32 nx", "property float32 ny", "property float32 nz",
        "property float32 radius",
        "end_header",
    ]) + "\n"
    rec = np.empty((n, 7), dtype="<f4")
    rec[:, 0:3] = splats[:, 0:3]
    rec[:, 3:6] = splats[:, 4:7]
    rec[:, 6] = splats[:, 3]
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())
