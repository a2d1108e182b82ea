"""General PLY reader for the offline tools (reference extras/ply.{h,cpp}).

The pipeline's fast path (io/ply.py, the FastPly analogue) deliberately
accepts only binary little-endian files with the vertex element first —
exactly like the reference (src/fast_ply.h:83-239). The reference keeps a
second, fully general reader in extras/ for its offline tools (plymanifold,
plypntcat), supporting ascii 1.0 and both binary endiannesses, arbitrary
property types and order, and list properties. This module is that reader:
correctness and generality over speed (it is never on the reconstruction
path).

API:
    elements = read_ply(path)        # name -> {prop -> ndarray}
    verts, tris = read_mesh_any(path)
    splats = read_splats_any(path, smooth=..., max_radius=...)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from mlsgpu_tpu_torch.utils.errors import FormatError

_DTYPES = {
    "int8": "i1", "char": "i1", "uint8": "u1", "uchar": "u1",
    "int16": "i2", "short": "i2", "uint16": "u2", "ushort": "u2",
    "int32": "i4", "int": "i4", "uint32": "u4", "uint": "u4",
    "float32": "f4", "float": "f4",
    "int64": "i8", "uint64": "u8",
    "float64": "f8", "double": "f8",
}


class _Prop:
    def __init__(self, name: str, dtype: str,
                 count_dtype: Optional[str] = None):
        self.name = name
        self.dtype = dtype              # value dtype code (no byte order)
        self.count_dtype = count_dtype  # list count dtype, None for scalar

    @property
    def is_list(self) -> bool:
        return self.count_dtype is not None


class _Element:
    def __init__(self, name: str, count: int):
        self.name = name
        self.count = count
        self.props: List[_Prop] = []


def _parse_general_header(data: bytes):
    """Returns (format, elements, header_size). Accepts ascii/binary_{le,be},
    any element order, list properties (extras/ply.h header grammar)."""
    end = data.find(b"end_header")
    if end < 0:
        raise FormatError("end_header not found")
    nl = data.find(b"\n", end)
    if nl < 0:
        raise FormatError("unterminated end_header line")
    header_size = nl + 1
    text = data[:end].decode("ascii", errors="replace")
    lines = [ln.strip() for ln in text.splitlines()]
    if not lines or lines[0] != "ply":
        raise FormatError("missing ply signature")

    fmt = None
    elements: List[_Element] = []
    for line in lines[1:]:
        tok = line.split()
        if not tok or tok[0] in ("comment", "obj_info"):
            continue
        if tok[0] == "format":
            if len(tok) < 3:
                raise FormatError("malformed format line")
            if tok[1] not in ("ascii", "binary_little_endian",
                              "binary_big_endian"):
                raise FormatError(f"unknown format {tok[1]!r}")
            if tok[2] != "1.0":
                raise FormatError(f"unsupported PLY version {tok[2]!r}")
            fmt = tok[1]
        elif tok[0] == "element":
            if len(tok) != 3:
                raise FormatError("malformed element line")
            elements.append(_Element(tok[1], int(tok[2])))
        elif tok[0] == "property":
            if not elements:
                raise FormatError("property before element")
            if tok[1] == "list":
                if len(tok) != 5:
                    raise FormatError("malformed list property")
                cdt, vdt = _DTYPES.get(tok[2]), _DTYPES.get(tok[3])
                if cdt is None or vdt is None:
                    raise FormatError(f"unknown type in list property: {line}")
                elements[-1].props.append(_Prop(tok[4], vdt, cdt))
            else:
                if len(tok) != 3:
                    raise FormatError("malformed property line")
                dt = _DTYPES.get(tok[1])
                if dt is None:
                    raise FormatError(f"unknown property type {tok[1]!r}")
                elements[-1].props.append(_Prop(tok[2], dt))
        else:
            raise FormatError(f"unknown header keyword {tok[0]!r}")
    if fmt is None:
        raise FormatError("missing format line")
    return fmt, elements, header_size


def _read_binary_element(buf: memoryview, pos: int, el: _Element,
                         bo: str) -> Tuple[Dict[str, np.ndarray], int]:
    out: Dict[str, np.ndarray] = {}
    if not any(p.is_list for p in el.props):
        dtype = np.dtype([(p.name, bo + p.dtype) for p in el.props])
        need = dtype.itemsize * el.count
        if pos + need > len(buf):
            raise FormatError(f"file too small for element {el.name}")
        rec = np.frombuffer(buf, dtype=dtype, count=el.count, offset=pos)
        for p in el.props:
            out[p.name] = rec[p.name].copy()
        return out, pos + need

    # List properties: try the uniform-count fast path (every face a
    # triangle, say) by reading the first record's counts, building a fixed
    # dtype, and verifying all counts match; fall back to a per-record walk.
    if el.count == 0:
        for p in el.props:
            out[p.name] = (np.empty((0, 0), dtype=bo + p.dtype) if p.is_list
                           else np.empty(0, dtype=bo + p.dtype))
        return out, pos

    def scan_counts(limit: int) -> Tuple[List[int], int]:
        """Read record `limit` boundaries starting at pos; returns first
        record's per-list counts and its byte size."""
        q = pos
        counts = []
        for p in el.props:
            if p.is_list:
                cdt = np.dtype(bo + p.count_dtype)
                c = int(np.frombuffer(buf, cdt, 1, q)[0])
                counts.append(c)
                q += cdt.itemsize + c * np.dtype(p.dtype).itemsize
            else:
                q += np.dtype(p.dtype).itemsize
        return counts, q - pos

    counts0, rec_size = scan_counts(1)
    fields = []
    ci = 0
    for p in el.props:
        if p.is_list:
            fields.append((p.name + "__n", bo + p.count_dtype))
            fields.append((p.name, bo + p.dtype, (counts0[ci],)))
            ci += 1
        else:
            fields.append((p.name, bo + p.dtype))
    dtype = np.dtype(fields)
    assert dtype.itemsize == rec_size
    if pos + rec_size * el.count <= len(buf):
        rec = np.frombuffer(buf, dtype=dtype, count=el.count, offset=pos)
        uniform = True
        ci = 0
        for p in el.props:
            if p.is_list and not np.all(rec[p.name + "__n"] == counts0[ci]):
                uniform = False
            ci += p.is_list
        if uniform:
            for p in el.props:
                out[p.name] = rec[p.name].copy()
            return out, pos + rec_size * el.count

    # Ragged lists: per-record walk (offline-tool slow path).
    vals: Dict[str, list] = {p.name: [] for p in el.props}
    q = pos
    for _ in range(el.count):
        for p in el.props:
            if p.is_list:
                cdt = np.dtype(bo + p.count_dtype)
                if q + cdt.itemsize > len(buf):
                    raise FormatError(f"file too small for element {el.name}")
                c = int(np.frombuffer(buf, cdt, 1, q)[0])
                q += cdt.itemsize
                vdt = np.dtype(bo + p.dtype)
                if q + c * vdt.itemsize > len(buf):
                    raise FormatError(f"file too small for element {el.name}")
                vals[p.name].append(np.frombuffer(buf, vdt, c, q).copy())
                q += c * vdt.itemsize
            else:
                vdt = np.dtype(bo + p.dtype)
                vals[p.name].append(np.frombuffer(buf, vdt, 1, q)[0])
                q += vdt.itemsize
    for p in el.props:
        out[p.name] = (vals[p.name] if p.is_list
                       else np.asarray(vals[p.name], dtype=p.dtype))
    return out, q


def _read_ascii_element(tokens: List[str], ti: int, el: _Element
                        ) -> Tuple[Dict[str, np.ndarray], int]:
    vals: Dict[str, list] = {p.name: [] for p in el.props}
    for _ in range(el.count):
        for p in el.props:
            if p.is_list:
                if ti >= len(tokens):
                    raise FormatError(f"truncated element {el.name}")
                c = int(tokens[ti]); ti += 1
                row = tokens[ti:ti + c]
                if len(row) != c:
                    raise FormatError(f"truncated list in element {el.name}")
                ti += c
                vals[p.name].append(np.asarray(row, dtype=p.dtype))
            else:
                if ti >= len(tokens):
                    raise FormatError(f"truncated element {el.name}")
                vals[p.name].append(tokens[ti]); ti += 1
    out: Dict[str, np.ndarray] = {}
    for p in el.props:
        if p.is_list:
            rows = vals[p.name]
            if rows and all(len(r) == len(rows[0]) for r in rows):
                out[p.name] = np.asarray(rows, dtype=p.dtype)
            else:
                out[p.name] = rows
        else:
            out[p.name] = np.asarray(vals[p.name], dtype=p.dtype)
    return out, ti


def read_ply(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Read any PLY 1.0 file. Returns {element: {property: array}}; uniform
    list properties come back as 2-D arrays, ragged ones as lists of rows."""
    with open(path, "rb") as f:
        data = f.read()
    fmt, elements, header_size = _parse_general_header(data)
    out: Dict[str, Dict[str, np.ndarray]] = {}
    if fmt == "ascii":
        tokens = data[header_size:].decode("ascii", errors="replace").split()
        ti = 0
        for el in elements:
            out[el.name], ti = _read_ascii_element(tokens, ti, el)
    else:
        bo = "<" if fmt == "binary_little_endian" else ">"
        buf = memoryview(data)
        pos = header_size
        for el in elements:
            out[el.name], pos = _read_binary_element(buf, pos, el, bo)
    return out


def read_mesh_any(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(vertices (N,3) f32, triangles (M,3) i64) from any PLY mesh."""
    els = read_ply(path)
    if "vertex" not in els:
        raise FormatError("no vertex element")
    v = els["vertex"]
    for k in ("x", "y", "z"):
        if k not in v:
            raise FormatError(f"vertex element missing property {k}")
    verts = np.stack([np.asarray(v[k], np.float32) for k in ("x", "y", "z")],
                     axis=1)
    face = els.get("face") or els.get("triangle") or {}
    idx = None
    for key in ("vertex_indices", "vertex_index"):
        if key in face:
            idx = face[key]
            break
    if idx is None:
        return verts, np.empty((0, 3), np.int64)
    if isinstance(idx, list):  # ragged — reject non-triangles like the tool
        raise FormatError("non-triangle face")
    idx = np.asarray(idx)
    if idx.ndim != 2 or idx.shape[1] != 3:
        raise FormatError("non-triangle face")
    return verts, idx.astype(np.int64)


def read_splats_any(path: str, smooth: float = 1.0,
                    max_radius: float = float("inf")) -> np.ndarray:
    """(N, 8) splat array from any PLY with x/y/z/nx/ny/nz/radius vertex
    properties (the extras tools' input decode, matching FastPly semantics:
    radius *= smooth, then clamped to max_radius)."""
    els = read_ply(path)
    v = els.get("vertex")
    if v is None:
        raise FormatError("no vertex element")
    need = ("x", "y", "z", "nx", "ny", "nz", "radius")
    for k in need:
        if k not in v:
            raise FormatError(f"vertex element missing property {k}")
    from mlsgpu_tpu_torch.core.splat import decode_raw_splats
    fields = np.stack([np.asarray(v[k], np.float32) for k in need], axis=1)
    return decode_raw_splats(fields, smooth, max_radius)
