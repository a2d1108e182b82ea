"""The benchmark's one traffic generator: the seeded sphere scan and the
PLY file a job reads it from.

`make_cloud` is a frozen copy of the port's bench cloud
(`mlsgpu_tpu_torch/tools/cloud.py::make_cloud`), bitwise equal to it for the
same `n` and `seed` (portbench/tests/test_portbench_cloud.py holds it to
that). Unlike the original it reads no environment variable: the order of
the splats is a parameter of the traffic file, not of the process.
"""

from __future__ import annotations

import numpy as np

#: Orders the generator can emit the scan in (a traffic file's "order").
ORDERS = ("scan", "shuffled")


def make_cloud(n: int, seed: int, order: str = "scan",
               sphere_radius: float = 3.0, spacings_per_radius: float = 3.0):
    """A synthetic scan of a sphere: `n` splats with outward normals, in a
    jittered lat-long sweep of equal-area bands (the scanline order a
    scanner produces), or that sweep permuted from the same seed
    ("shuffled"). Returns (splats (n, 8) f32 in the layout x y z radius nx
    ny nz quality, splat radius): the radius is `spacings_per_radius` times
    the mean spacing of the splats over the sphere."""
    if order not in ORDERS:
        raise ValueError(f"unknown order {order!r}; known: {ORDERS}")
    rng = np.random.default_rng(seed)
    ids = np.arange(n, dtype=np.int64)
    bands = max(int(np.sqrt(n / 2)), 1)
    band = ids * bands // n
    in_band = ids - band * n // bands
    band_len = np.maximum((band + 1) * n // bands - band * n // bands, 1)
    j1 = rng.random(n) - 0.5
    j2 = rng.random(n) - 0.5
    cos_t = 1.0 - 2.0 * (band + 0.5 + 0.9 * j1) / bands
    theta = np.arccos(np.clip(cos_t, -1.0, 1.0))
    phi = (in_band + 0.5 + 0.9 * j2) / band_len * 2 * np.pi
    st, ct = np.sin(theta), np.cos(theta)
    v = np.stack([st * np.cos(phi), st * np.sin(phi), ct],
                 axis=1).astype(np.float32)
    if order == "shuffled":
        v = v[rng.permutation(n)]
    splats = np.zeros((n, 8), dtype=np.float32)
    splats[:, 0:3] = sphere_radius * v
    spacing = np.sqrt(4 * np.pi * sphere_radius ** 2 / n)
    sr = spacings_per_radius * spacing
    splats[:, 3] = sr
    splats[:, 4:7] = v
    splats[:, 7] = 1.0 / sr ** 2
    return splats, sr


def write_splats_ply(path: str, splats: np.ndarray) -> int:
    """Write (N, 8) splats as a binary little-endian PLY of float32 x y z
    nx ny nz radius, the input format of the reconstruction. Returns the
    bytes written."""
    n = len(splats)
    header = "\n".join([
        "ply", "format binary_little_endian 1.0", f"element vertex {n}",
        "property float32 x", "property float32 y", "property float32 z",
        "property float32 nx", "property float32 ny", "property float32 nz",
        "property float32 radius", "end_header"]) + "\n"
    rec = np.empty((n, 7), dtype="<f4")
    rec[:, 0:3] = splats[:, 0:3]
    rec[:, 3:6] = splats[:, 4:7]
    rec[:, 6] = splats[:, 3]
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())
    return len(header) + rec.nbytes
