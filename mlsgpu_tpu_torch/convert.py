"""Numpy -> torch conversion of the state that crosses from the JAX package
to the port: the sorted entry state (BinnedSplats) and the block inputs.

Tests feed both packages from the same numpy arrays; handing the JAX
package's binning output to the port's field passes keeps the unstable JAX
sort's tie order out of field comparisons.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mlsgpu_tpu_torch.ops.binning import BinnedSplats


def binned_from_numpy(entry_data: np.ndarray, entry_keys: np.ndarray,
                      entry_vals: np.ndarray, device="cpu") -> BinnedSplats:
    """BinnedSplats from numpy arrays (uint32 keys become int64)."""
    return BinnedSplats(
        entry_data=torch.as_tensor(np.array(entry_data, np.float32),
                                   device=device),
        entry_keys=torch.as_tensor(np.asarray(entry_keys).astype(np.int64),
                                   device=device),
        entry_vals=torch.as_tensor(np.asarray(entry_vals).astype(np.int64),
                                   device=device))


def block_inputs_from_numpy(splats: np.ndarray, valid: np.ndarray,
                            region_cells, cell_origin,
                            points: Optional[np.ndarray] = None,
                            device="cpu") -> dict:
    """Keyword arguments of ops.block.block_step / block_field: splats and
    valid as device tensors, region and origin as host int triples, points
    as an int64 device tensor (or None)."""
    return dict(
        splats=torch.as_tensor(np.array(splats, np.float32), device=device),
        valid=torch.as_tensor(np.array(valid, bool), device=device),
        region_cells=tuple(int(v) for v in np.asarray(region_cells)),
        cell_origin=tuple(int(v) for v in np.asarray(cell_origin)),
        points=(None if points is None or not len(points) else
                torch.as_tensor(np.array(points, np.int64), device=device)))
