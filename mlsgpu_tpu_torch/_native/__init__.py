"""ctypes loader for the native host library (the port's copy of the JAX
package's `_native`: the same C++ source, its own loader and build).

The library is built with g++ on first use into
`mlsgpu_tpu_torch/_build/libmlsnative.so` (or MLSGPU_TORCH_BUILD_DIR), under
a file lock and through a temporary file (utils/native_build.py), so
processes that start at once never load a half-written library. Most
consumers have a numpy fallback, so a missing toolchain only costs speed;
the codes readback needs the library and raises without it
(pipeline/reconstruct.require_native).
"""

from __future__ import annotations

import ctypes
import os
import shlex
import subprocess
import threading
from typing import Optional

import numpy as np

from mlsgpu_tpu_torch.utils import native_build

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "native.cpp")
LIBRARY_NAME = "libmlsnative.so"
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
            "-Wall", "-pthread"]
#: Environment variable that disables the library (forces the numpy paths).
DISABLE_ENV = "MLSGPU_TPU_NO_NATIVE"

_lock = threading.Lock()
_lib = None
#: Why the last attempt in this process failed (None after a success or
#: before any attempt).
last_error: Optional[str] = None

_I64 = ctypes.POINTER(ctypes.c_int64)
_I32 = ctypes.POINTER(ctypes.c_int32)
_U32 = ctypes.POINTER(ctypes.c_uint32)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_F32 = ctypes.POINTER(ctypes.c_float)


def library_path() -> str:
    return os.path.join(native_build.build_dir(), LIBRARY_NAME)


def build() -> str:
    """Compile the library unless it is up to date; returns its path.
    Raises RuntimeError when the compiler fails."""
    target = library_path()

    def compile_into(tmp: str) -> None:
        cmd = [*shlex.split(os.environ.get("CXX", "g++")), *CXXFLAGS,
               "-o", tmp, SOURCE]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed "
                               f"({proc.returncode}):\n{proc.stderr}")

    native_build.build_locked(target, [SOURCE], compile_into)
    return target


def load_library():
    """Build if needed and load the library, with its argument types set.
    Raises on failure."""
    lib = ctypes.CDLL(build())
    _declare(lib)
    return lib


def get_lib():
    """The loaded library, or None when it is unavailable. After a failure
    the library is not rebuilt on every call, but a call that finds a fresh
    library on disk (another process built it) loads it."""
    global _lib, last_error
    with _lock:
        if _lib is not None:
            return _lib
        if os.environ.get(DISABLE_ENV):
            return None  # debug escape hatch: force the numpy fallbacks
        if last_error is not None and not native_build.is_fresh(
                library_path(), [SOURCE]):
            return None
        try:
            _lib = load_library()
            last_error = None
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            last_error = str(e) or type(e).__name__
        return _lib


def _declare(lib) -> None:
    """Argument and result types of every entry point."""
    lib.mls_uf_find_many.argtypes = [_I64, _I64, _I64, ctypes.c_int64]
    lib.mls_uf_merge_pairs.argtypes = [
        _I64, _I64, ctypes.POINTER(_I64), ctypes.c_int64,
        _I64, _I64, ctypes.c_int64]
    lib.mls_keymap_new.restype = ctypes.c_void_p
    lib.mls_keymap_new.argtypes = [ctypes.c_int64]
    lib.mls_keymap_free.argtypes = [ctypes.c_void_p]
    lib.mls_keymap_size.restype = ctypes.c_int64
    lib.mls_keymap_size.argtypes = [ctypes.c_void_p]
    lib.mls_keymap_get_or_insert.argtypes = [
        ctypes.c_void_p, _I64, ctypes.c_int64, _I64, _I64, _U8]
    lib.mls_keymap_lookup.argtypes = [ctypes.c_void_p, _I64,
                                      ctypes.c_int64, _I64]
    lib.mls_keymap_items.argtypes = [ctypes.c_void_p, _I64, _I64]
    lib.mls_blob_rle.restype = ctypes.c_int64
    lib.mls_blob_rle.argtypes = [
        _F32, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
        ctypes.c_int64, _I64, _I64, _I64, _I64, _I64, _I64, _I64]
    lib.mls_decode_splats.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, _I64,
        ctypes.c_float, ctypes.c_float, _F32]
    lib.mls_decode_splats_mt.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, _I64,
        ctypes.c_float, ctypes.c_float, _F32, ctypes.c_int64]
    lib.mls_unpack_readback.argtypes = [
        _U32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, _I64, _F32, _I32, _I64]
    lib.mls_mesher_add.restype = ctypes.c_int64
    lib.mls_mesher_add.argtypes = [
        _F32, ctypes.c_int64, _I32, ctypes.c_int64, ctypes.c_int64,
        _I64, _I64, _I64, _I64, _I64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        _U32, _U32, _I64]
    lib.mls_rebuild_block.restype = ctypes.c_int64
    lib.mls_rebuild_block.argtypes = [
        _U32, _U8, ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _I64, _I64, _I32, ctypes.c_int64, _I32, ctypes.c_int64,
        _I32, _I32, _I32, _F32, _I32, _I64, _I64]
    lib.mls_write_pass_a.restype = ctypes.c_int64
    lib.mls_write_pass_a.argtypes = [
        _U32, ctypes.c_int64, _I64, _I64, ctypes.c_int64,
        ctypes.c_int64, _U32]
    lib.mls_write_verts.restype = ctypes.c_int64
    lib.mls_write_verts.argtypes = [
        _U32, ctypes.c_int64, _U32, _F32, ctypes.c_float, _F32, _F32]
    lib.mls_write_tris.restype = ctypes.c_int64
    lib.mls_write_tris.argtypes = [_U32, ctypes.c_int64, _U32, _U8]
    lib.mls_count_tris_kept.restype = ctypes.c_int64
    lib.mls_count_tris_kept.argtypes = [_U32, ctypes.c_int64, _U32]


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctype)


def available() -> bool:
    return get_lib() is not None


class KeyMap:
    """Batch int64->int64 hash map backed by the native library, with a
    pure-dict fallback. Used for the mesher's key->clump and key->index
    maps (src/mesher.h:349-352)."""

    def __init__(self, capacity_hint: int = 1024):
        self._lib = get_lib()
        if self._lib is not None:
            self._h = self._lib.mls_keymap_new(capacity_hint)
            self._dict = None
        else:
            self._h = None
            self._dict = {}

    def __del__(self):
        if getattr(self, "_h", None) is not None and self._lib is not None:
            self._lib.mls_keymap_free(self._h)
            self._h = None

    def __len__(self) -> int:
        if self._dict is not None:
            return len(self._dict)
        return int(self._lib.mls_keymap_size(self._h))

    def get_or_insert(self, keys: np.ndarray, insert_vals: np.ndarray):
        """Returns (values (n,), was_new (n,) bool)."""
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        insert_vals = np.ascontiguousarray(insert_vals, dtype=np.int64)
        n = len(keys)
        if self._dict is not None:
            out = np.empty(n, np.int64)
            new = np.empty(n, bool)
            d = self._dict
            for i in range(n):
                k = int(keys[i])
                v = d.get(k)
                if v is None:
                    d[k] = v = int(insert_vals[i])
                    new[i] = True
                else:
                    new[i] = False
                out[i] = v
            return out, new
        out = np.empty(n, np.int64)
        new = np.empty(n, np.uint8)
        self._lib.mls_keymap_get_or_insert(
            self._h, _ptr(keys, _I64), n, _ptr(insert_vals, _I64),
            _ptr(out, _I64), _ptr(new, _U8))
        return out, new.astype(bool)

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        n = len(keys)
        if self._dict is not None:
            return np.array([self._dict.get(int(k), -1) for k in keys],
                            dtype=np.int64)
        out = np.empty(n, np.int64)
        self._lib.mls_keymap_lookup(self._h, _ptr(keys, _I64), n,
                                    _ptr(out, _I64))
        return out

    def items_arrays(self):
        """(keys, values) arrays — for checkpoint serialization."""
        if self._dict is not None:
            if not self._dict:
                return (np.empty(0, np.int64), np.empty(0, np.int64))
            ks = np.fromiter(self._dict.keys(), np.int64, len(self._dict))
            vs = np.fromiter(self._dict.values(), np.int64, len(self._dict))
            return ks, vs
        n = len(self)
        ks = np.empty(n, np.int64)
        vs = np.empty(n, np.int64)
        self._lib.mls_keymap_items(self._h, _ptr(ks, _I64), _ptr(vs, _I64))
        return ks, vs

    @classmethod
    def from_items(cls, keys: np.ndarray, vals: np.ndarray) -> "KeyMap":
        km = cls(capacity_hint=max(len(keys), 1024))
        if len(keys):
            km.get_or_insert(keys, vals)
        return km

    # pickle support (checkpoint/resume)
    def __getstate__(self):
        ks, vs = self.items_arrays()
        return {"keys": ks, "vals": vs}

    def __setstate__(self, state):
        fresh = KeyMap.from_items(state["keys"], state["vals"])
        self.__dict__.update(fresh.__dict__)
        fresh._h = None  # ownership moved


def uf_find_many(parent: np.ndarray, xs: np.ndarray) -> np.ndarray:
    lib = get_lib()
    xs = np.ascontiguousarray(xs, dtype=np.int64)
    if lib is None:
        return None  # caller falls back
    out = np.empty(len(xs), np.int64)
    lib.mls_uf_find_many(_ptr(parent, _I64), _ptr(xs, _I64),
                         _ptr(out, _I64), len(xs))
    return out


def uf_merge_pairs(parent: np.ndarray, size: np.ndarray, metas,
                   a: np.ndarray, b: np.ndarray) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    a = np.ascontiguousarray(a, dtype=np.int64)
    b = np.ascontiguousarray(b, dtype=np.int64)
    meta_ptrs = (_I64 * len(metas))(*[_ptr(m, _I64) for m in metas])
    lib.mls_uf_merge_pairs(_ptr(parent, _I64), _ptr(size, _I64),
                           meta_ptrs, len(metas),
                           _ptr(a, _I64), _ptr(b, _I64), len(a))
    return True


def decode_splats(buf: bytes, n: int, stride: int, offsets: np.ndarray,
                  smooth: float, max_radius: float, nthreads: int = 0,
                  out: Optional[np.ndarray] = None):
    """Decode n raw PLY records into `out` ((n, 8) f32, C-contiguous; a new
    array when None); nthreads > 1 splits rows across native threads (the
    reference's OpenMP decode, src/splat_set.cpp:213). nthreads=0 uses the
    hardware core count."""
    lib = get_lib()
    if lib is None:
        return None
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if out is None:
        out = np.empty((n, 8), np.float32)
    elif (out.shape != (n, 8) or out.dtype != np.float32
          or not out.flags.c_contiguous):
        raise ValueError("decode_splats: out must be a C-contiguous "
                         f"({n}, 8) float32 array")
    if nthreads == 0:
        nthreads = os.cpu_count() or 1
    if nthreads > 1:
        lib.mls_decode_splats_mt(buf, n, stride, _ptr(offsets, _I64),
                                 np.float32(smooth), np.float32(max_radius),
                                 _ptr(out, _F32), int(nthreads))
    else:
        lib.mls_decode_splats(buf, n, stride, _ptr(offsets, _I64),
                              np.float32(smooth), np.float32(max_radius),
                              _ptr(out, _F32))
    return out


def blob_rle(chunk: np.ndarray, first_id: int, inv_spacing: float,
             micro: int, carry: np.ndarray, bbox: np.ndarray,
             nonfinite: np.ndarray):
    """Native single-pass blob RLE over one splat chunk; returns
    (starts, counts, lo, hi) for the runs closed within the chunk, or None
    when the library is unavailable. carry/bbox/nonfinite are int64 arrays
    mutated in place (run state across chunks)."""
    lib = get_lib()
    if lib is None:
        return None
    chunk = np.ascontiguousarray(chunk, dtype=np.float32)
    n = len(chunk)
    out_start = np.empty(n + 1, np.int64)
    out_count = np.empty(n + 1, np.int64)
    out_lo = np.empty((n + 1, 3), np.int64)
    out_hi = np.empty((n + 1, 3), np.int64)
    k = lib.mls_blob_rle(
        chunk.ctypes.data_as(_F32), n, first_id,
        ctypes.c_float(inv_spacing), micro,
        _ptr(carry, _I64), _ptr(bbox, _I64), _ptr(nonfinite, _I64),
        _ptr(out_start, _I64), _ptr(out_count, _I64),
        _ptr(out_lo, _I64), _ptr(out_hi, _I64))
    return out_start[:k], out_count[:k], out_lo[:k], out_hi[:k]


_INDEX_MODES = {"u16": 0, "u21x3": 1, "u32": 2}


def rebuild_block(flat: np.ndarray, num_cells: int, num_unwelded: int,
                  num_indices: int, nc_axis: int, cell_origin: np.ndarray,
                  region_cells: np.ndarray):
    """Rebuild + weld a block mesh from the codes-mode readback buffer
    (layout [cells u32 | codes u8 | t16 u16], ops/block._pack_codes).
    Returns (verts (nw,3) f32 GLOBAL grid coords, tris (ni/3,3) i32,
    ext_keys (nw-fe,) i64, first_external) or None when the library is
    unavailable. Raises ValueError on a corrupt buffer."""
    lib = get_lib()
    if lib is None:
        return None
    from mlsgpu_tpu_torch.ops import tables
    flat = np.ascontiguousarray(flat, dtype=np.uint32)
    nc, nuw, ni = int(num_cells), int(num_unwelded), int(num_indices)
    cells = flat[:nc]
    codes = flat.view(np.uint8)[4 * nc: 4 * nc + nc]
    w2 = nc + (nc + 3) // 4
    t16 = flat.view(np.uint16)[2 * w2: 2 * w2 + nuw]
    cell_origin = np.ascontiguousarray(cell_origin, dtype=np.int64)
    region_cells = np.ascontiguousarray(region_cells, dtype=np.int64)
    verts = np.empty((max(nuw, 1), 3), np.float32)
    tris = np.empty(max(ni, 3), np.int32)
    keys = np.empty(max(nuw, 1), np.int64)
    counts = np.zeros(2, np.int64)
    tabs = [np.ascontiguousarray(t, np.int32) for t in
            (tables.VERT_TABLE, tables.INDEX_TABLE, tables.EDGES,
             tables.EDGE_KEY, tables.COUNT_TABLE)]
    nw = lib.mls_rebuild_block(
        _ptr(cells, _U32), _ptr(codes, _U8),
        t16.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        nc, nuw, ni, nc_axis, _ptr(cell_origin, _I64),
        _ptr(region_cells, _I64),
        _ptr(tabs[0], _I32), tables.MAX_CELL_VERTICES,
        _ptr(tabs[1], _I32), tables.MAX_CELL_INDICES,
        _ptr(tabs[2], _I32), _ptr(tabs[3], _I32), _ptr(tabs[4], _I32),
        _ptr(verts, _F32), _ptr(tris, _I32), _ptr(keys, _I64),
        _ptr(counts, _I64))
    if nw < 0:
        raise ValueError("corrupt codes readback buffer")
    fe = int(counts[1])
    return (verts[:nw], tris[:ni].reshape(-1, 3), keys[:nw - fe], fe)


def unpack_readback(flat: np.ndarray, ni: int, nv: int, fe: int,
                    index_mode: str, vertex_words: int,
                    cell_origin: np.ndarray):
    """Native decode of the packed block readback; returns (verts (nv,3)
    f32 in GLOBAL grid coords, tris (ni/3,3) i32, ext_keys (nv-fe,) i64),
    or None when the library is unavailable. Bitwise-identical to
    ops/block.unpack_readback + the cell-origin add."""
    lib = get_lib()
    if lib is None:
        return None
    flat = np.ascontiguousarray(flat, dtype=np.uint32)
    cell_origin = np.ascontiguousarray(cell_origin, dtype=np.int64)
    verts = np.empty((nv, 3), np.float32)
    tris = np.empty((ni // 3, 3), np.int32)
    keys = np.empty(nv - fe, np.int64)
    lib.mls_unpack_readback(
        _ptr(flat, _U32), ni, nv, fe, _INDEX_MODES[index_mode],
        vertex_words, _ptr(cell_origin, _I64), _ptr(verts, _F32),
        _ptr(tris, _I32), _ptr(keys, _I64))
    return verts, tris, keys


def mesher_add(verts, tris, first_ext, keys, clumps, base,
               key_clump: "KeyMap", chunk_keys: "KeyMap",
               chunk_nv_base: int):
    """Fused OOCMesher.add hot path. clumps supplies raw int64 capacity
    buffers (_parent/_size/_nv/_nt), pre-grown to hold base + len(verts)
    nodes. Returns (n_new, vrec (n_new,4) u32, trec (m,3) u32,
    stats [num_local, new_global_keys, new_chunk_keys]) or None when the
    library (or a native map) is unavailable. Raises ValueError on a
    corrupt triangle index."""
    lib = get_lib()
    if lib is None or key_clump._h is None or chunk_keys._h is None:
        return None
    verts = np.ascontiguousarray(verts, dtype=np.float32)
    tris = np.ascontiguousarray(tris, dtype=np.int32)
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    n, m = len(verts), len(tris)
    vrec = np.empty((max(n, 1), 4), np.uint32)
    trec = np.empty((max(m, 1), 3), np.uint32)
    stats = np.zeros(3, np.int64)
    n_new = lib.mls_mesher_add(
        _ptr(verts, _F32), n, _ptr(tris, _I32), m, first_ext,
        _ptr(keys, _I64),
        _ptr(clumps._parent, _I64), _ptr(clumps._size, _I64),
        _ptr(clumps._nv, _I64), _ptr(clumps._nt, _I64), base,
        key_clump._h, chunk_keys._h, chunk_nv_base,
        _ptr(vrec, _U32), _ptr(trec, _U32), _ptr(stats, _I64))
    if n_new < 0:
        raise ValueError("triangle index out of range")
    return n_new, vrec[:n_new], trec[:m], stats


def write_pass_a(raw: np.ndarray, parent: np.ndarray,
                 pruned_sorted, nv_base: int):
    """Final-write pass A over one (n,4) u32 vertex-record slice. Returns
    (kept_count, remap (n,) u32) or None."""
    lib = get_lib()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, dtype=np.uint32)
    remap = np.empty(len(raw), np.uint32)
    if pruned_sorted is None or len(pruned_sorted) == 0:
        pp, np_ = np.empty(0, np.int64), 0
    else:
        pp = np.ascontiguousarray(pruned_sorted, dtype=np.int64)
        np_ = len(pp)
    kept = lib.mls_write_pass_a(_ptr(raw, _U32), len(raw),
                                _ptr(parent, _I64), _ptr(pp, _I64), np_,
                                nv_base, _ptr(remap, _U32))
    return kept, remap


def write_verts(raw: np.ndarray, remap: np.ndarray, ext_lo, spacing,
                reference):
    """Final-write pass B vertices: compact + grid->world transform.
    Returns an (kept,3) f32 array or None."""
    lib = get_lib()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, dtype=np.uint32)
    remap = np.ascontiguousarray(remap, dtype=np.uint32)
    ext_lo = np.ascontiguousarray(ext_lo, dtype=np.float32)
    reference = np.ascontiguousarray(reference, dtype=np.float32)
    out = np.empty((len(raw), 3), np.float32)
    kept = lib.mls_write_verts(_ptr(raw, _U32), len(raw), _ptr(remap, _U32),
                               _ptr(ext_lo, _F32), np.float32(spacing),
                               _ptr(reference, _F32), _ptr(out, _F32))
    return out[:kept]


def write_tris(raw: np.ndarray, remap: np.ndarray):
    """Final-write pass B triangles: 13-byte PLY records for kept
    triangles. Returns a bytes object or None."""
    lib = get_lib()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, dtype=np.uint32)
    remap = np.ascontiguousarray(remap, dtype=np.uint32)
    out = np.empty(len(raw) * 13, np.uint8)
    kept = lib.mls_write_tris(_ptr(raw, _U32), len(raw), _ptr(remap, _U32),
                              _ptr(out, _U8))
    return out[:kept * 13].tobytes()


def write_verts_into(raw: np.ndarray, remap: np.ndarray, ext_lo, spacing,
                     reference, out_buf) -> int:
    """write_verts variant filling a caller buffer (e.g. an AsyncWriter
    pool buffer) directly; returns bytes written, or -1 if unavailable."""
    lib = get_lib()
    if lib is None:
        return -1
    raw = np.ascontiguousarray(raw, dtype=np.uint32)
    remap = np.ascontiguousarray(remap, dtype=np.uint32)
    ext_lo = np.ascontiguousarray(ext_lo, dtype=np.float32)
    reference = np.ascontiguousarray(reference, dtype=np.float32)
    out = np.frombuffer(out_buf, np.uint8)
    assert len(out) >= len(raw) * 12
    kept = lib.mls_write_verts(_ptr(raw, _U32), len(raw), _ptr(remap, _U32),
                               _ptr(ext_lo, _F32), np.float32(spacing),
                               _ptr(reference, _F32),
                               out.ctypes.data_as(_F32))
    return int(kept) * 12


def write_tris_into(raw: np.ndarray, remap: np.ndarray, out_buf) -> int:
    """write_tris variant filling a caller buffer directly; returns bytes
    written (13 per kept triangle), or -1 if unavailable."""
    lib = get_lib()
    if lib is None:
        return -1
    raw = np.ascontiguousarray(raw, dtype=np.uint32)
    remap = np.ascontiguousarray(remap, dtype=np.uint32)
    out = np.frombuffer(out_buf, np.uint8)
    assert len(out) >= len(raw) * 13
    kept = lib.mls_write_tris(_ptr(raw, _U32), len(raw), _ptr(remap, _U32),
                              _ptr(out, _U8))
    return int(kept) * 13


def count_tris_kept(raw: np.ndarray, remap: np.ndarray):
    """Count triangles surviving pruning in one (m,3) slice, or None."""
    lib = get_lib()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, dtype=np.uint32)
    remap = np.ascontiguousarray(remap, dtype=np.uint32)
    return int(lib.mls_count_tris_kept(_ptr(raw, _U32), len(raw),
                                       _ptr(remap, _U32)))
