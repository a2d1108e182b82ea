"""Faults planted in the program underneath a run, for the benchmark's own
checks: each must turn `correct` false. `plant(name)` breaks the
timed path in this process and returns a function that mends it.

* `block_dropped`: a block's step leaves the mesh as it was (its decoded
  mesh comes back empty): a hole.
* `half_splats`: every other splat of each block left out (marked
  invalid before the step), the field fitted over the rest. The cloud
  samples a sphere without noise, so the rest fit the same sphere inside
  the scan; what moves is where the fit gives out, at the scan's rim,
  and `boundary_edges` reads it. It changes nothing at the rehearsal's
  size, where the rest fit the same sphere everywhere.
* `half_block`: the second half of every block's splats, in the order the
  block streams them, left out, the field fitted over the first half.
* `vertex_moved`: a block's vertices moved a quarter of a cell where they
  are produced (its decoded mesh).
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict

import numpy as np

FAULTS = ("block_dropped", "half_splats", "half_block", "vertex_moved")


def _patch(module, name: str, new) -> Callable[[], None]:
    old = getattr(module, name)
    setattr(module, name, new(old))
    return lambda: setattr(module, name, old)


def plant(fault: str) -> Callable[[], None]:
    """Break the program for `fault` (one of FAULTS); returns the mend."""
    rec = importlib.import_module("mlsgpu_tpu_torch.pipeline.reconstruct")
    streamer = importlib.import_module("mlsgpu_tpu_torch.pipeline.streamer")
    mesher = importlib.import_module("mlsgpu_tpu_torch.pipeline.mesher")
    order: Dict[tuple, int] = {}

    def nth_block(pick: Callable[[int], bool], change):
        """`change` the blocks that `pick` chooses by their place among the
        blocks with triangles, in the order first seen: the same blocks in
        every job (a block with no surface would hide the fault)."""
        def wrap(old):
            def decode(result, bucket):
                block = old(result, bucket)
                if not len(block.triangles):
                    return block
                key = tuple(int(c) for c in bucket.cell_lo)
                place = order.setdefault(key, len(order))
                return change(block) if pick(place) else block
            return decode
        return _patch(rec, "block_result_to_input", wrap)

    def empty(block):
        return mesher.BlockInput(
            chunk_id=block.chunk_id,
            vertices=np.zeros((0, 3), np.float32), first_external=0,
            ext_keys=np.zeros(0, np.int64),
            triangles=np.zeros((0, 3), block.triangles.dtype))

    def moved(block):
        v = block.vertices.copy()
        v[:, 0] += np.float32(0.25)
        return mesher.BlockInput(
            chunk_id=block.chunk_id, vertices=v,
            first_external=block.first_external, ext_keys=block.ext_keys,
            triangles=block.triangles)

    if fault == "block_dropped":
        return nth_block(lambda i: i == 0, empty)
    if fault == "vertex_moved":
        return nth_block(lambda i: i == 0, moved)
    if fault in ("half_splats", "half_block"):
        def wrap(old):
            def block_inputs(splats, grid):
                grid_form, valid = old(splats, grid)
                valid = valid.copy()
                if fault == "half_splats":
                    valid[1::2] = False
                else:
                    valid[len(valid) // 2:] = False
                return grid_form, valid
            return block_inputs
        return _patch(streamer, "block_inputs", wrap)
    raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
