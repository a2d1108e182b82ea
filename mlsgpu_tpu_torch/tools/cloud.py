"""The bench cloud: the synthetic sphere scan the port is measured on.

The port's own copy of the JAX package's benchmark cloud (`make_cloud` in
the repo-root bench.py), bitwise equal to it for the same `n` and `seed`.
"""

from __future__ import annotations

import os

import numpy as np


def make_cloud(n, seed=123):
    """Synthetic scan: sphere cloud with outward normals, sized so the
    volume spans multiple 256^3 blocks at the chosen grid spacing. Returns
    (splats (n, 8) f32, splat radius).

    Ordered as a jittered lat-long sweep (scanline order), the spatial
    coherence real scanners produce — the property the blob pass exists to
    exploit (reference FastBlobSet, src/splat_set.h:653-708; a randomly
    permuted cloud degenerates to one blob per splat, which no real scan
    does). Set BENCH_SHUFFLE=1 for the adversarial random-order variant."""
    rng = np.random.default_rng(seed)
    ids = np.arange(n, dtype=np.int64)
    bands = max(int(np.sqrt(n / 2)), 1)
    band = ids * bands // n
    in_band = ids - band * n // bands
    band_len = np.maximum((band + 1) * n // bands - band * n // bands, 1)
    j1 = rng.random(n) - 0.5
    j2 = rng.random(n) - 0.5
    # Equal-AREA bands (uniform in cos theta): each band holds n/bands
    # splats over equal area, so density is uniform over the sphere
    # (uniform-in-theta banding oversamples the poles ~1/sin(theta)).
    cos_t = 1.0 - 2.0 * (band + 0.5 + 0.9 * j1) / bands
    theta = np.arccos(np.clip(cos_t, -1.0, 1.0))
    phi = (in_band + 0.5 + 0.9 * j2) / band_len * 2 * np.pi
    st, ct = np.sin(theta), np.cos(theta)
    v = np.stack([st * np.cos(phi), st * np.sin(phi), ct],
                 axis=1).astype(np.float32)
    if os.environ.get("BENCH_SHUFFLE"):
        v = v[rng.permutation(n)]
    radius = 3.0
    splats = np.zeros((n, 8), dtype=np.float32)
    splats[:, 0:3] = radius * v
    # splat radius ~3x mean neighbor spacing for solid coverage
    spacing = np.sqrt(4 * np.pi * radius ** 2 / n)
    sr = 3.0 * spacing
    splats[:, 3] = sr
    splats[:, 4:7] = v
    splats[:, 7] = 1.0 / sr ** 2
    return splats, sr


def bench_config(splat_radius, levels=6):
    """The bench configuration on a cloud of this splat radius: grid
    spacing a third of it (splat radius ~3 cells), 256^3-corner dispatches
    at `levels` 6."""
    from mlsgpu_tpu_torch.config import ReconstructConfig
    return ReconstructConfig(
        fit_grid=float(splat_radius / 3.0), fit_smooth=1.0, fit_prune=0.02,
        levels=levels, subsampling=3, max_device_splats=4 << 20,
        tile_candidates=384, progress=False)


def densest_bucket(source, cfg):
    """(blob info, buckets with their skeleton points, the bucket with the
    most splats) of `source` under `cfg`, bucketed as the main path does."""
    from mlsgpu_tpu_torch.pipeline import blobs as blobs_mod
    from mlsgpu_tpu_torch.pipeline import bucket as bucket_mod
    info = blobs_mod.compute_blobs(source, cfg.fit_grid, cfg.micro_cells)
    buckets = bucket_mod.make_buckets(
        info, cfg.device_block_cells, cfg.micro_cells,
        max_splats=min(cfg.max_device_splats, cfg.mem_bucket_splats // 32))
    return info, buckets, max(buckets, key=lambda b: b.num_splats)


def bucket_inputs(source, info, bucket):
    """One bucket's block inputs as the loader makes them: (grid-frame
    splats (N, 8) f32, valid (N,) bool)."""
    from mlsgpu_tpu_torch.io.splat_set import merge_ranges
    from mlsgpu_tpu_torch.pipeline.streamer import prepare_block_inputs
    start, count = info.blobs.start, info.blobs.count
    ranges = merge_ranges((int(start[i]), int(start[i] + count[i]))
                          for i in bucket.blob_ids)
    return prepare_block_inputs(source.read_ranges(ranges), info.grid)
