"""The packed and raw readbacks' kernels (csrc/marching.cu's mesh
emission, csrc/mesh.cu's weld and pack) and the functions the block step
calls for them: `generate_mesh`, `weld`, then `pack_readback` (packed) or
`welded_mesh` (raw); `mesh_image` runs the packed chain whole.

Tensors on a CUDA device take the kernel path: the codes path's classify
and scan kernels (ops/marching_cuda.py: one C call, the totals and n_occ
copied to pinned host memory with one wait on the stream, the stage's
first sync; their list row also carries each listed tile's index base),
then `march_emit_mesh_kernel` (a CTA a listed tile, one CTA scan of its
cells' counts for their bases, a thread a vertex and a thread a triangle:
each vertex's position, key halves and compact sort key (4 bytes up to
32 key bits), each triangle's three int32 indices; csrc/mesh.cuh holds
the arithmetic), bit for bit
`marching.generate_mesh`; the weld's radix sort of the compact keys over
their top digits and `weld_group_kernel`, which finishes each key group's
sort in shared memory and compacts (one C call; the welded counts copied
back with one wait, the second sync), bit for bit `weld.weld`; and
`pack_readback_kernel` (one launch over the welded vertices and the
triangles), bit for bit `block.pack_readback`, or, for raw, the same
kernel's remap of the triangles alone. Tensors on the CPU take those plain
functions. A CUDA tensor launches the kernels or raises; nothing falls
back.

On the card the key halves are int32 words with the u32 bits (the raw
readback's layout) and the triangles int32; the plain versions hold them
as int64 values. The compact key sorts as the global keys only while
every doubled global coordinate fits its 21 bits, so the kernels refuse
a block past that (or at a negative origin), where the global keys would
overlap anyway.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, NamedTuple, Optional, Sequence, Union

import torch

from mlsgpu_tpu_torch.ops import (binning_cuda, launches, marching,
                                  marching_cuda, mls_cuda)
from mlsgpu_tpu_torch.ops import weld as weld_ops

#: Bits an axis of the global weld keys (marching.generate_mesh's scheme).
KEY_AXIS_BITS = 21
#: The packed layout's index modes, in the kernels' numbering
#: (MESH_INDEX_*), and the raw readback's remap of the triangles.
INDEX_MODES = ("u16", "u21x3", "u32")
INDEX_RAW = 3
#: The radix sort's digits, CTA and tiles (csrc/radix_sort.cuh), and the
#: weld's plan and group kernel (csrc/mesh.cuh): a vertex's copies by its
#: odd doubled coordinates (a cube edge's midpoint, a face diagonal's, the
#: body diagonal's), the group kernel's largest capacity and its tile,
#: and its counts (welded, internal, groups past the capacity).
SORT_DIGIT_BITS = 8
SORT_MAX_PASSES = 6
SORT_RADIX = 256
SORT_THREADS = 256
WELD_COPIES = (0, 4, 2, 1)
WELD_MAX_CAPACITY = 1024
WELD_MAX_FREE_BITS = 30
WELD_TILE = 2048
WELD_COUNTS = 3
#: The most bits an axis of a compact key: 2^13 corners an axis take 14.
MAX_AXES = 15


class CardMesh(NamedTuple):
    """`generate_mesh`'s unwelded mesh on the card: marching.BlockMesh's
    fields (key halves as int32 words, triangles int32), then the compact
    sort keys (at their sort width, `key_dtype`), their bits an axis, and
    n_occ as copied back with the totals (None when not given)."""
    vertices: torch.Tensor    # (n, 3) f32 block-local grid coords
    key_hi: torch.Tensor      # (n,) int32 words: ext<<31 | z<<10 | y>>11
    key_lo: torch.Tensor      # (n,) int32 words: (y & 0x7FF)<<21 | x
    triangles: torch.Tensor   # (ni // 3, 3) int32 into vertices
    num_cells: int
    num_vertices: int
    num_indices: int
    num_tiles: int
    sort_keys: torch.Tensor   # (n,) (ext, kz, ky, kx) block-local: int32
                              # words up to 32 key bits, else int64
    axis_bits: int
    n_occ: Optional[int] = None


class CardWeld(NamedTuple):
    """`weld`'s result on the card: weld.WeldedMesh's welded vertices and
    key halves (int32 words) and counts, with the old -> new remap and the
    unwelded triangles in place of the welded ones (pack_readback remaps
    them as it packs; welded_mesh remaps them for raw)."""
    vertices: torch.Tensor    # (nw, 3) f32, internal vertices first
    key_hi: torch.Tensor      # (nw,) int32 words
    key_lo: torch.Tensor      # (nw,) int32 words
    remap: torch.Tensor       # (n,) int32 welded index of each vertex
    unwelded: torch.Tensor    # (nt, 3) int32 into the unwelded vertices
    num_vertices: int
    first_external: int
    num_indices: int


class MeshImage(NamedTuple):
    """`mesh_image`: the packed image, its layout, and the meshes it was
    made from."""
    image: torch.Tensor
    fmt: object               # block.PackFormat
    mesh: Union[marching.BlockMesh, CardMesh]
    welded: Union[weld_ops.WeldedMesh, CardWeld]


def axis_bits(b: int) -> int:
    """Bits an axis of the compact key of a block of b corners an axis:
    its doubled block-local coordinates run up to 2 (b - 1)."""
    return (2 * (b - 1)).bit_length()


def key_bits(axes: int) -> int:
    """Bits of the compact key: three axes and the external flag."""
    return 3 * axes + 1


def sort_key_bytes(bits: int) -> int:
    """The weld sort's key bytes between passes (csrc/mesh.cuh)."""
    return 4 if bits <= 32 else 8


def key_dtype(bits: int) -> torch.dtype:
    """The compact keys' dtype on the card: int32 words (the u32 bits)
    where the sort keeps 4 bytes, else int64."""
    return torch.int32 if sort_key_bytes(bits) == 4 else torch.int64


def free_bits(bits: int, passes: int) -> int:
    """The key bits below `passes` global 8-bit passes over the top."""
    return max(bits - SORT_DIGIT_BITS * passes, 0)


@functools.lru_cache(maxsize=None)
def group_bound(bits: int, free: int) -> int:
    """The most keys the emission can put in one key group of `bits`-bit
    keys with `free` free bits (mesh_weld_group_bound): the free bits fill
    kx's, ky's, then kz's bits; a coordinate with a free bit takes either
    parity, the others the top bits' parity; a position's copies follow
    its odd coordinates (WELD_COPIES: the cells sharing its edge)."""
    if free > 40:
        return 1 << 42
    a = (bits - 1) // 3
    free_axes = [free > 0, free > a, free > 2 * a]
    per = (1 << free) >> sum(free_axes)
    best = 0
    for fixed in range(8):
        if any(fixed >> i & 1 and free_axes[i] for i in range(3)):
            continue
        keys = sum(WELD_COPIES[bin(odd).count("1")] * per
                   for odd in range(8)
                   if all(free_axes[i] or (odd >> i & 1) == (fixed >> i & 1)
                          for i in range(3)))
        best = max(best, keys)
    return best


@functools.lru_cache(maxsize=None)
def sort_passes(bits: int) -> int:
    """g, the weld sort's global passes (mesh_sort_passes): the least whose
    key groups fit the group kernel's largest capacity. 3 at 28 and 31
    bits."""
    g = 1
    while group_bound(bits, free_bits(bits, g)) > WELD_MAX_CAPACITY:
        g += 1
    return g


@functools.lru_cache(maxsize=None)
def weld_plan(bits: int):
    """(g, free bits, capacity C) of the weld of `bits`-bit keys."""
    g = sort_passes(bits)
    f = free_bits(bits, g)
    return g, f, group_bound(bits, f)


def weld_scratch_words(n: int, bits: int) -> int:
    """The weld's scratch for n vertices, int64 words
    (mesh_weld_scratch_words): each sort pass's histogram (SORT_RADIX
    int32) and scan state (binning_cuda.sort_pass_words), then the group
    kernel's ticket and a status word a count a tile."""
    kb = sort_key_bytes(bits)
    tile = SORT_THREADS * (8 if kb == 8 else 16)
    pass_words = binning_cuda.sort_pass_words(n, tile)
    return (sort_passes(bits) * (SORT_RADIX // 2 + pass_words)
            + 1 + WELD_COUNTS * -(-n // WELD_TILE))


def weld_work_words(n: int, bits: int) -> int:
    """The weld sort's work buffers, int32 words (mesh_weld_work_words): a
    key and an index a vertex (a buffer an even count of words), two
    buffers where a pass reads another's."""
    buffer = -(-(sort_key_bytes(bits) // 4 + 1) * n // 2) * 2
    return (2 if sort_passes(bits) > 1 else 1) * buffer


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError_t {err}")


def _check_origin(cell_origin: Sequence[int], b: int):
    origin = tuple(int(v) for v in cell_origin)
    if len(origin) != 3 or any(
            v < 0 or 2 * (v + b - 1) >= 1 << KEY_AXIS_BITS for v in origin):
        raise ValueError(f"cell origin {origin}: a block of {b} corners an "
                         f"axis there leaves the weld keys' "
                         f"{KEY_AXIS_BITS} bits an axis")
    return origin


def generate_mesh(field: torch.Tensor, region_cells: Sequence[int],
                  cell_origin: Sequence[int],
                  n_occ: Optional[torch.Tensor] = None,
                  axes: Optional[int] = None,
                  sync: Callable[[], contextlib.AbstractContextManager]
                  = contextlib.nullcontext
                  ) -> Union[marching.BlockMesh, CardMesh]:
    """The unwelded mesh of a (B, B, B) field [z, y, x] (NaN = undefined):
    marching.generate_mesh for a CPU tensor; for a CUDA tensor the
    classify and scan kernels (the totals and n_occ, an int32 device
    scalar, copied back with one wait, inside `sync()`) and the mesh
    emission kernel. axes: the compact key's bits an axis, by default
    axis_bits(B); more (up to MAX_AXES) weld as a larger block's keys
    would."""
    if field.device.type == "cpu":
        return marching.generate_mesh(field, region_cells, cell_origin)
    if field.device.type != "cuda":
        raise ValueError(f"no mesh path for device {field.device}")
    b = field.shape[0] if field.dim() == 3 else -1
    origin = _check_origin(cell_origin, b)
    axes = axis_bits(b) if axes is None else int(axes)
    if not axis_bits(b) <= axes <= MAX_AXES:
        raise ValueError(f"{axes} key bits an axis: a block of {b} corners "
                         f"needs {axis_bits(b)}-{MAX_AXES}")
    marched = marching_cuda.classify(
        field, region_cells, n_occ,
        max_corners=marching_cuda.MESH_MAX_CORNERS, sync=sync)
    c = marched.counts
    dev = field.device
    n, ni = c.num_vertices, c.num_indices
    vertices = torch.empty((n, 3), dtype=torch.float32, device=dev)
    key_hi = torch.empty(n, dtype=torch.int32, device=dev)
    key_lo = torch.empty(n, dtype=torch.int32, device=dev)
    sort_keys = torch.empty(n, dtype=key_dtype(key_bits(axes)), device=dev)
    triangles = torch.empty((ni // 3, 3), dtype=torch.int32, device=dev)
    if marched.march_tiles > 0:
        lib = mls_cuda.load()
        with torch.cuda.device(dev):
            _raise_on(lib.march_emit_mesh_launch(
                field.data_ptr(), b, *marched.region, *origin, axes,
                marched.tile_list.data_ptr(), marched.march_tiles,
                vertices.data_ptr(), key_hi.data_ptr(), key_lo.data_ptr(),
                sort_keys.data_ptr(), triangles.data_ptr(), _stream(dev)),
                "march_emit_mesh_launch")
        launches.count("march_emit_mesh")
    return CardMesh(vertices=vertices, key_hi=key_hi, key_lo=key_lo,
                    triangles=triangles, num_cells=c.num_cells,
                    num_vertices=n, num_indices=ni, num_tiles=c.num_tiles,
                    sort_keys=sort_keys, axis_bits=axes,
                    n_occ=marched.n_occ)


def weld(mesh: Union[marching.BlockMesh, CardMesh],
         sync: Callable[[], contextlib.AbstractContextManager]
         = contextlib.nullcontext
         ) -> Union[weld_ops.WeldedMesh, CardWeld]:
    """Weld an unwelded mesh: weld.weld for CPU tensors; for generate_mesh's
    card mesh the weld's sort over the keys' top digits and its group
    kernel (one C call), then the welded counts copied back with one wait
    on the stream, inside `sync()`. Raises where a key group is past the
    group kernel's capacity (keys the emission cannot make)."""
    if mesh.vertices.device.type == "cpu":
        return weld_ops.weld(mesh.vertices, mesh.key_hi, mesh.key_lo,
                             mesh.triangles)
    if not isinstance(mesh, CardMesh):
        raise ValueError("the weld kernels take generate_mesh's card mesh")
    dev = mesh.vertices.device
    n = mesh.num_vertices
    bits = key_bits(mesh.axis_bits)
    if mesh.sort_keys.dtype != key_dtype(bits) or \
            mesh.sort_keys.shape != (n,):
        raise ValueError(f"{bits}-bit keys: the weld takes {n} keys of "
                         f"{key_dtype(bits)}, not {mesh.sort_keys.dtype} "
                         f"{tuple(mesh.sort_keys.shape)}")
    passes, free, capacity = weld_plan(bits)
    if passes > SORT_MAX_PASSES or free > WELD_MAX_FREE_BITS:
        raise ValueError(f"{bits}-bit keys: the weld's plan of {passes} "
                         f"passes and {free} free bits is past the kernels' "
                         f"{SORT_MAX_PASSES} and {WELD_MAX_FREE_BITS}")
    out_vertices = torch.empty((n, 3), dtype=torch.float32, device=dev)
    out_hi = torch.empty(n, dtype=torch.int32, device=dev)
    out_lo = torch.empty(n, dtype=torch.int32, device=dev)
    remap = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return CardWeld(out_vertices, out_hi, out_lo, remap, mesh.triangles,
                        0, 0, mesh.num_indices)
    work = torch.empty(weld_work_words(n, bits), dtype=torch.int32,
                       device=dev)
    scratch = torch.empty(weld_scratch_words(n, bits), dtype=torch.int64,
                          device=dev)
    totals = torch.empty(WELD_COUNTS, dtype=torch.int64, device=dev)
    lib = mls_cuda.load()
    with torch.cuda.device(dev):
        _raise_on(lib.weld_launch(
            mesh.sort_keys.data_ptr(), n, bits, mesh.vertices.data_ptr(),
            mesh.key_hi.data_ptr(), mesh.key_lo.data_ptr(), work.data_ptr(),
            scratch.data_ptr(), out_vertices.data_ptr(), out_hi.data_ptr(),
            out_lo.data_ptr(), remap.data_ptr(), totals.data_ptr(),
            _stream(dev)), "weld_launch")
        launches.count("weld_sort_histogram")
        for _ in range(passes):
            launches.count("weld_sort_pass")
        launches.count("weld_group")
        host = torch.empty(WELD_COUNTS, dtype=torch.int64, pin_memory=True)
        host.copy_(totals, non_blocking=True)
        with sync():
            torch.cuda.current_stream(dev).synchronize()
    nw, fe, past = (int(v) for v in host.numpy())
    if past:
        raise RuntimeError(f"weld: {past} key groups of {bits}-bit keys "
                           f"past the group kernel's {capacity} keys: more "
                           f"copies of a key than the emission makes")
    return CardWeld(vertices=out_vertices[:nw], key_hi=out_hi[:nw],
                    key_lo=out_lo[:nw], remap=remap, unwelded=mesh.triangles,
                    num_vertices=nw, first_external=fe,
                    num_indices=mesh.num_indices)


def _launch_pack(welded: CardWeld, cell_origin: Sequence[int], mode: int,
                 vertex_words: int, out: torch.Tensor) -> None:
    dev = welded.vertices.device
    nt = welded.unwelded.shape[0]
    nw = welded.num_vertices if mode != INDEX_RAW else 0
    if nw + nt == 0:
        return
    lib = mls_cuda.load()
    with torch.cuda.device(dev):
        _raise_on(lib.pack_readback_launch(
            welded.vertices.data_ptr(), welded.key_hi.data_ptr(),
            welded.key_lo.data_ptr(), nw, welded.unwelded.data_ptr(),
            welded.remap.data_ptr(), nt, *(int(v) for v in cell_origin),
            mode, vertex_words, out.data_ptr(), _stream(dev)),
            "pack_readback_launch")
    launches.count("pack_readback")


def pack_readback(welded: Union[weld_ops.WeldedMesh, CardWeld],
                  cell_origin: Sequence[int], fmt) -> torch.Tensor:
    """The packed image (block.PackFormat `fmt`, int32 words) of a welded
    mesh: block.pack_readback for CPU tensors, the pack kernel (one
    launch) for weld's card result."""
    if welded.vertices.device.type == "cpu":
        from mlsgpu_tpu_torch.ops import block
        return block.pack_readback(welded, cell_origin, fmt)
    if not isinstance(welded, CardWeld):
        raise ValueError("the pack kernel takes weld's card result")
    image = torch.empty(fmt.total_words(welded.num_indices,
                                        welded.num_vertices),
                        dtype=torch.int32, device=welded.vertices.device)
    _launch_pack(welded, cell_origin, INDEX_MODES.index(fmt.index_mode),
                 fmt.vertex_words, image)
    return image


def welded_mesh(welded: Union[weld_ops.WeldedMesh, CardWeld]
                ) -> weld_ops.WeldedMesh:
    """The raw readback's welded mesh: a CPU WeldedMesh as it is; weld's
    card result with its triangles remapped by the pack kernel (int32)."""
    if not isinstance(welded, CardWeld):
        return welded
    tris = torch.empty(welded.unwelded.shape, dtype=torch.int32,
                       device=welded.vertices.device)
    _launch_pack(welded, (0, 0, 0), INDEX_RAW, 0, tris)
    return weld_ops.WeldedMesh(
        vertices=welded.vertices, key_hi=welded.key_hi, key_lo=welded.key_lo,
        triangles=tris, num_vertices=welded.num_vertices,
        first_external=welded.first_external,
        num_indices=welded.num_indices)


def mesh_image(field: torch.Tensor, region_cells: Sequence[int],
               cell_origin: Sequence[int], levels: int, subsampling: int,
               n_occ: Optional[torch.Tensor] = None) -> MeshImage:
    """The packed readback of a block's field whole: generate_mesh, weld,
    its PackFormat from the welded count, pack_readback; the kernels for
    a CUDA tensor (two syncs), the plain chain for a CPU tensor."""
    from mlsgpu_tpu_torch.ops import block
    mesh = generate_mesh(field, region_cells, cell_origin, n_occ)
    welded = weld(mesh)
    fmt = block.pack_format(levels, subsampling, welded.num_vertices)
    if fmt is None:
        raise ValueError(f"block of 2^{levels + subsampling - 1} corners an "
                         "axis is too large for the packed readback")
    return MeshImage(pack_readback(welded, cell_origin, fmt), fmt, mesh,
                     welded)

