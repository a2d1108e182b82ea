"""Several devices in one call (port of mlsgpu_tpu/parallel/sharded.py, same
three names).

The JAX package shards one compiled program over a device mesh and lets
XLA insert the collectives. Eager PyTorch has no such program, so a "mesh"
here is the list of devices, and a sharded call runs one thread per entry,
each under its device and, on a card, its own CUDA stream:

- `data_parallel_block_step`: one block per mesh entry, all run at the same
  time (the reference's multi-GPU load balancing and MPI bucket scatter,
  src/workers.cpp:315-351, mlsgpu-mpi.cpp:202-246). Welding across the
  blocks rides the external-key machinery on the host, so the devices
  exchange nothing.
- `distributed_cell_bounds`: per-entry reduction of splat statistics, then
  combined on the first entry's device (the reference's collective
  blob/bbox pass, src/splat_set_mpi.h:129-169).

A mesh may name one device more than once; each entry still gets its own
thread and stream.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from mlsgpu_tpu_torch.device import resolve_devices
from mlsgpu_tpu_torch.ops.block import BlockResult, block_step

Mesh = List[torch.device]


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """The device list sharded calls run over: `devices`, or every visible
    card."""
    if devices is None:
        return resolve_devices("cuda", 0)
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def run_per_entry(mesh: Mesh, fn: Callable[[int, torch.device], object]
                   ) -> list:
    """fn(i, device) for every mesh entry at the same time, one thread per
    entry, under the entry's device and (on a card) a stream of its own
    that first waits for the work already queued on the caller's stream.
    Returns the results in mesh order once every stream has finished; the
    first exception of any entry is raised after all threads have ended."""
    results: list = [None] * len(mesh)
    errors: list = [None] * len(mesh)
    callers, ready = {}, {}
    for dev in set(mesh):
        if dev.type == "cuda":
            callers[dev] = torch.cuda.current_stream(dev)
            ready[dev] = callers[dev].record_event()

    def entry(i: int, dev: torch.device) -> None:
        try:
            if dev.type != "cuda":
                results[i] = fn(i, dev)
                return
            stream = torch.cuda.Stream(dev)
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                stream.wait_event(ready[dev])
                results[i] = fn(i, dev)
                # the caller reads the results on its own stream: they are
                # complete when this returns, and their memory is not
                # handed out again while that stream may still read it
                for t in _tensors(results[i]):
                    t.record_stream(callers[dev])
                stream.synchronize()
        except BaseException as e:  # raised by the caller
            errors[i] = e

    threads = [threading.Thread(target=entry, args=(i, dev),
                                name=f"shard.{i}", daemon=True)
               for i, dev in enumerate(mesh)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    return results


def _tensors(obj):
    """The tensors inside nested tuples (a BlockResult and its mesh)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for item in obj:
            yield from _tensors(item)


def _host_triple(row) -> Tuple[int, int, int]:
    return tuple(int(v) for v in torch.as_tensor(row).tolist())


def data_parallel_block_step(mesh: Mesh,
                             splats,        # (D, N, 8)
                             valid,         # (D, N)
                             region_cells,  # (D, 3)
                             cell_origin,   # (D, 3)
                             boundary_factor: float = 0.0,
                             **statics) -> List[BlockResult]:
    """Run one block per mesh entry at the same time: entry i runs
    `ops.block.block_step` on splats[i], valid[i], region_cells[i],
    cell_origin[i] (tensors or arrays, on any device; each row is moved to
    its entry's device). `statics` are block_step's keyword arguments
    (levels, subsampling, fit_shape, readback, ...).

    Returns the entries' BlockResults in mesh order, each on its entry's
    device: a list where the JAX package stacks a leading device axis,
    because the port sizes every output from its true count and the blocks
    have no common padded shape to stack."""
    if not (len(splats) == len(valid) == len(region_cells)
            == len(cell_origin) == len(mesh)):
        raise ValueError(f"{len(mesh)} mesh entries need as many blocks")

    def per_device(i: int, dev: torch.device) -> BlockResult:
        return block_step(
            torch.as_tensor(splats[i]).to(dev),
            torch.as_tensor(valid[i]).to(dev),
            _host_triple(region_cells[i]), _host_triple(cell_origin[i]),
            float(boundary_factor), **statics)

    return run_per_entry(mesh, per_device)


def distributed_cell_bounds(mesh: Mesh,
                            positions,   # (D, N, 3)
                            radii,       # (D, N)
                            valid,       # (D, N)
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Bounding box and count over splat shards: entry i reduces its shard
    on its device (min of position - radius, max of position + radius,
    number valid), then the D triples are copied to the first entry's
    device and combined there. Returns (lo (3,), hi (3,), count ()) on
    mesh[0].

    The copies take the place of the JAX package's pmin/pmax/psum over the
    mesh. No NCCL group is opened for them: the devices belong to one
    process, the payload is 7 numbers per device, and setting up a process
    group costs far more than D small copies."""
    if not len(positions) == len(radii) == len(valid) == len(mesh):
        raise ValueError(f"{len(mesh)} mesh entries need as many shards")
    big = 3.0e38

    def per_device(i: int, dev: torch.device):
        pos = torch.as_tensor(positions[i], dtype=torch.float32).to(dev)
        r = torch.as_tensor(radii[i], dtype=torch.float32).to(dev)[:, None]
        v = torch.as_tensor(valid[i], dtype=torch.bool).to(dev)
        lo = torch.where(v[:, None], pos - r, pos.new_tensor(big)).amin(0)
        hi = torch.where(v[:, None], pos + r, pos.new_tensor(-big)).amax(0)
        return lo, hi, v.sum()

    parts = run_per_entry(mesh, per_device)
    first = mesh[0]
    with (torch.cuda.device(first) if first.type == "cuda"
          else contextlib.nullcontext()):
        lo = torch.stack([p[0].to(first) for p in parts]).amin(0)
        hi = torch.stack([p[1].to(first) for p in parts]).amax(0)
        cnt = torch.stack([p[2].to(first) for p in parts]).sum()
    return lo, hi, cnt
