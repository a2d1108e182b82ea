"""The binning stage's kernels (csrc/binning.cu) and the functions the block
step calls for binning: `bin_splats` and `tile_segments`, with
ops/binning.py's signatures.

Tensors on a CUDA device take the kernel path: the key pass
(`bin_keys_kernel`), the stable radix sort of the keys (`sort_keys`: a
histogram kernel, then a pass kernel a digit, on the look-back scan of
csrc/scan.cuh; one C call), the entry gather (`bin_entries_kernel`) and
the tile segments (`tile_bounds_kernel`, the first entry of every node
key, then `tile_segments_kernel`, which gathers each (tile, level)'s
segment from that table; one C call), with no host synchronisation, bit
for bit the plain functions (the sort torch.sort(stable=True)'s). Tensors
on the CPU take the plain versions (ops/binning.py; bin_splats sorts with
torch.sort there). A CUDA tensor launches the kernels or raises; nothing
falls back. The kernels live in the library ops/mls_cuda.py builds.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mlsgpu_tpu_torch.ops import binning, launches, mls_cuda
from mlsgpu_tpu_torch.ops.binning import BinnedSplats


def _path(t: torch.Tensor) -> bool:
    """True for the kernel path (a CUDA tensor), False for the plain one
    (a CPU tensor); raises for any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no binning path for device {t.device}")


def _check_splats(splats: torch.Tensor) -> int:
    n = splats.shape[0] if splats.dim() == 2 else -1
    mls_cuda._check("splats", splats, torch.float32, (n, 8))
    if splats.data_ptr() % 16:
        raise ValueError("splats must be 16-byte aligned")
    return n


def _check_shifts(min_shift: int, max_shift: int) -> None:
    if not 3 <= min_shift <= max_shift <= 13:
        raise ValueError(f"shifts [{min_shift}, {max_shift}]: the kernels "
                         "take 3 <= min_shift <= max_shift <= 13")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError_t {err}")


def splat_keys(splats: torch.Tensor, valid: torch.Tensor, cell_origin,
               min_shift: int, max_shift: int) -> torch.Tensor:
    """binning.splat_keys: the key kernel for CUDA tensors (one launch;
    none for no splats), the plain version for CPU tensors."""
    if not _path(splats):
        return binning.splat_keys(splats, valid, cell_origin, min_shift,
                                  max_shift)
    dev = splats.device
    n = _check_splats(splats)
    mls_cuda._check("valid", valid, torch.bool, (n,))
    if valid.device != dev:
        raise ValueError(f"valid on {valid.device}, splats on {dev}")
    _check_shifts(min_shift, max_shift)
    ox, oy, oz = (int(v) for v in cell_origin)
    keys = torch.empty(8 * n, dtype=torch.int64, device=dev)
    if n == 0:
        return keys
    lib = mls_cuda.load()
    with torch.cuda.device(dev):
        _raise_on(lib.bin_keys_launch(
            splats.data_ptr(), valid.data_ptr(), n, min_shift, max_shift,
            ox, oy, oz, keys.data_ptr(), _stream(dev)), "bin_keys_launch")
    launches.count("bin_keys")
    return keys


#: The radix sort's keys a tile (a CTA) and digits a pass
#: (csrc/binning.cuh).
SORT_TILE = 4096
SORT_RADIX = 256
#: Tiles a group of the passes' two-level look-back (csrc/scan.cuh), and
#: the most tiles of a pass that takes it (csrc/radix_sort.cuh).
SCAN_GROUP = 16
SORT_GROUPED_TILES = 256


def sort_pass_words(n: int, tile: int) -> int:
    """A pass's scan state for n keys in tiles of `tile` keys, int64 words
    (radix_sort.cuh's sort_pass_words): its ticket, then a status word a
    (tile, digit), or, for a pass of at most SORT_GROUPED_TILES tiles (the
    two-level look-back), 32-bit words, two a 64-bit word: a count a
    (tile, digit), a sum and an exclusive prefix a (group, digit)."""
    tiles = -(-n // tile)
    if tiles <= SORT_GROUPED_TILES:
        return 1 + (tiles + 2 * -(-tiles // SCAN_GROUP)) * (SORT_RADIX // 2)
    return 1 + tiles * SORT_RADIX


def sort_scratch_words(n: int, min_shift: int, max_shift: int) -> int:
    """The sort's scratch for n keys, int64 words
    (bin_sort_scratch_words): each pass's histogram (SORT_RADIX int32) and
    its scan state (sort_pass_words)."""
    passes = len(binning.sort_digits(min_shift, max_shift))
    return passes * (SORT_RADIX // 2 + sort_pass_words(n, SORT_TILE))


def sort_keys(keys: torch.Tensor, min_shift: int, max_shift: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted keys, permutation) of (M,) int64 node keys of the shifts
    [min_shift, max_shift] (each below binning.node_count, or
    INVALID_KEY): torch.sort(keys, stable=True)'s. For a CUDA tensor the
    radix sort's kernels (one C call: the histogram kernel and a pass
    kernel a digit of binning.sort_digits; nothing for no keys), for a CPU
    tensor its plain version, binning.radix_sort."""
    if not _path(keys):
        return binning.radix_sort(keys, min_shift, max_shift)
    dev = keys.device
    m = keys.numel()
    mls_cuda._check("keys", keys, torch.int64, (m,))
    _check_shifts(min_shift, max_shift)
    if m >= 1 << 31:
        raise ValueError(f"{m} keys: the sort's indices are int32")
    sorted_keys = torch.empty(m, dtype=torch.int64, device=dev)
    perm = torch.empty(m, dtype=torch.int64, device=dev)
    if m == 0:
        return sorted_keys, perm
    passes = len(binning.sort_digits(min_shift, max_shift))
    work = torch.empty(2 * m if passes > 1 else 0, dtype=torch.int32,
                       device=dev)
    scratch = torch.empty(sort_scratch_words(m, min_shift, max_shift),
                          dtype=torch.int64, device=dev)
    lib = mls_cuda.load()
    with torch.cuda.device(dev):
        _raise_on(lib.bin_sort_launch(
            keys.data_ptr(), m, min_shift, max_shift, sorted_keys.data_ptr(),
            perm.data_ptr(), work.data_ptr() if passes > 1 else None,
            scratch.data_ptr(), _stream(dev)), "bin_sort_launch")
    launches.count("bin_sort_histogram")
    for _ in range(passes):
        launches.count("bin_sort_pass")
    return sorted_keys, perm


def entry_rows(splats: torch.Tensor, perm: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """binning.entry_rows: the entry kernel for CUDA tensors (one launch;
    none for no splats), the plain version for CPU tensors."""
    if not _path(splats):
        return binning.entry_rows(splats, perm)
    dev = splats.device
    n = _check_splats(splats)
    mls_cuda._check("perm", perm, torch.int64, (8 * n,))
    if perm.device != dev:
        raise ValueError(f"perm on {perm.device}, splats on {dev}")
    data = torch.empty((8 * n, 8), dtype=torch.float32, device=dev)
    vals = torch.empty(8 * n, dtype=torch.int64, device=dev)
    if n == 0:
        return data, vals
    lib = mls_cuda.load()
    with torch.cuda.device(dev):
        _raise_on(lib.bin_entries_launch(
            splats.data_ptr(), perm.data_ptr(), n, data.data_ptr(),
            vals.data_ptr(), _stream(dev)), "bin_entries_launch")
    launches.count("bin_entries")
    return data, vals


def bin_splats(splats: torch.Tensor, valid: torch.Tensor, cell_origin,
               min_shift: int, max_shift: int) -> BinnedSplats:
    """binning.bin_splats: on a CUDA device the key kernel, the sort's
    kernels and the entry kernel; on the CPU the plain version."""
    if not _path(splats):
        return binning.bin_splats(splats, valid, cell_origin, min_shift,
                                  max_shift)
    keys = splat_keys(splats, valid, cell_origin, min_shift, max_shift)
    sorted_keys, perm = sort_keys(keys, min_shift, max_shift)
    del keys
    entry_data, entry_vals = entry_rows(splats, perm)
    return BinnedSplats(entry_data=entry_data, entry_keys=sorted_keys,
                        entry_vals=entry_vals)


def tile_segments(entry_keys: torch.Tensor, min_shift: int, max_shift: int,
                  tiles_per_axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """binning.tile_segments: the bounds and segment kernels for CUDA
    tensors (one C call, a launch of each), the plain version for CPU
    tensors. Returns (starts, lens), each (T, L) int32."""
    if not _path(entry_keys):
        return binning.tile_segments(entry_keys, min_shift, max_shift,
                                     tiles_per_axis)
    return segments_and_bounds(entry_keys, min_shift, max_shift,
                               tiles_per_axis)[:2]


def segments_and_bounds(entry_keys: torch.Tensor, min_shift: int,
                        max_shift: int, tiles_per_axis: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(starts, lens, bounds): tile_segments' segments and the table of
    binning.node_bounds they are gathered from. For CUDA tensors the
    bounds kernel and the segment kernel, launched back to back by one C
    call, tiles_per_axis at most 2^(max_shift - 3); for CPU tensors the
    plain versions."""
    if not _path(entry_keys):
        return (*binning.tile_segments(entry_keys, min_shift, max_shift,
                                       tiles_per_axis),
                binning.node_bounds(entry_keys, min_shift, max_shift))
    dev = entry_keys.device
    mls_cuda._check("entry_keys", entry_keys, torch.int64,
                    (entry_keys.numel(),))
    _check_shifts(min_shift, max_shift)
    tpa = int(tiles_per_axis)
    if not 1 <= tpa <= 1 << (max_shift - 3):
        raise ValueError(f"{tpa} tiles an axis: the kernels take 1-"
                         f"{1 << (max_shift - 3)} at max_shift {max_shift}")
    shape = (tpa ** 3, max_shift - min_shift + 1)
    if entry_keys.numel() >= 1 << 31 or shape[0] * shape[1] >= 1 << 31:
        raise ValueError(f"{entry_keys.numel()} entries, {shape} segments: "
                         "segment starts and items are int32")
    nodes = binning.node_count(min_shift, max_shift)
    starts = torch.empty(shape, dtype=torch.int32, device=dev)
    lens = torch.empty(shape, dtype=torch.int32, device=dev)
    bounds = torch.empty(nodes + 1, dtype=torch.int32, device=dev)
    lib = mls_cuda.load()
    with torch.cuda.device(dev):
        _raise_on(lib.bin_segments_launch(
            entry_keys.data_ptr(), entry_keys.numel(), min_shift, max_shift,
            tpa, bounds.data_ptr(), starts.data_ptr(), lens.data_ptr(),
            _stream(dev)), "bin_segments_launch")
    launches.count("tile_bounds")
    launches.count("tile_segments")
    return starts, lens, bounds
