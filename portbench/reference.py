"""The plain reference that decides `correct`: the MLS surface of the raw
splats and the mesh rules a reconstruction guarantees, in plain PyTorch.

It imports nothing of the program. It reads the seeded cloud (made again
from the seed by portbench/traffic/generator.py) and the bytes of the PLY a
timed job wrote, and nothing else the program made.

What it compares, and which layers of the program each reading reaches:

* `vertex_gap_cells`: each sampled mesh vertex lies on an edge of the
  marching tetrahedra between two lattice corners (along an axis, a
  face's diagonal or the cube's). The reference works out the MLS field
  of the raw splats at both ends of that edge
  (the algebraic-sphere fit of upstream mlsgpu's kernels/mls.cl: weights
  (1 - d)^4 * quality over splats with d = |x - c|^2 / r^2 < 0.99, at
  least 4 of them, the boundary test). The reading is the widest
  distance, in cells, from a vertex the PLY holds to the surface, along
  that field: |f0 + t (f1 - f0)| for a vertex at share t of its edge. (The
  share alone is ill-conditioned where the field barely changes along an
  edge; the distance is not.) It reaches binning (a missed splat moves the
  field), the field kernel, the face and skeleton seam passes (the sample
  takes extra vertices on the planes where blocks meet), marching's
  vertex placement, the decode, and the writer's grid-to-world transform.
* `boundary_edges`: edges of one triangle. Holes, from a block lost or a
  weld that failed across blocks, raise it.
* `nonmanifold_edges`: edges of three or more triangles, an edge used
  twice in one direction (orientation) and degenerate triangles: 0.
* `duplicate_vertices`: vertices at one position off the lattice's
  corners, which the welds left apart: 0. (On a corner two vertices of
  different edges may meet where the field is zero there; they are
  counted apart as `corner_duplicates` and not held to a limit.)
* `small_components`: connected components under the pruning threshold
  (--fit-prune times the vertices): 0.
* `ply_errors`: header, list-count byte or index out of range: 0.

The field is worked out in float64 (the control passes a lower precision,
portbench/control.py) and in blocks of queries, so it fits beside
nothing else on the card once the program's state is freed.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

RADIUS_CUTOFF = 0.99
HITS_CUTOFF = 4
FLT_EPSILON = 1.1920929e-07
#: A vertex closer than this to a lattice corner (cells, on every axis) is
#: taken as lying on it: the gap is then |f(corner)| in cells.
CORNER_EPS = 1e-3


# ------------------------------------------------------------------ the PLY

_HEADER_END = b"end_header\n"


def read_mesh(buf: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """(vertices (N, 3) f32, triangles (M, 3) int64, errors) from the
    bytes of a binary little-endian PLY of float32 x y z vertices and
    uint8-count uint32 triangle lists. `errors` counts what breaks the
    format: a header that does not say so, a byte count that does not
    match, a face whose count byte is not 3, an index out of range."""
    data = memoryview(buf)
    head = bytes(data[:65536])
    end = head.find(_HEADER_END)
    if end < 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64), 1
    lines = head[:end].decode("ascii", "replace").splitlines()
    errors = 0
    if lines[:2] != ["ply", "format binary_little_endian 1.0"]:
        errors += 1
    body = [ln for ln in lines[2:] if not ln.startswith("comment")]
    want = ["element vertex N", "property float32 x", "property float32 y",
            "property float32 z", "element face M",
            "property list uint8 uint32 vertex_indices"]
    nv = nt = 0
    got = []
    for ln in body:
        m = re.fullmatch(r"element (vertex|face) (\d+)", ln)
        if m:
            if m.group(1) == "vertex":
                nv = int(m.group(2))
            else:
                nt = int(m.group(2))
            ln = f"element {m.group(1)} {'N' if m.group(1) == 'vertex' else 'M'}"
        got.append(ln)
    if got != want:
        errors += 1
    start = end + len(_HEADER_END)
    if len(buf) != start + 12 * nv + 13 * nt:
        errors += 1
        nv = min(nv, max(len(buf) - start, 0) // 12)
        nt = min(nt, max(len(buf) - start - 12 * nv, 0) // 13)
    verts = np.frombuffer(buf, dtype="<f4", count=3 * nv,
                          offset=start).reshape(nv, 3)
    rec = np.frombuffer(buf, dtype=np.uint8, count=13 * nt,
                        offset=start + 12 * nv).reshape(nt, 13)
    errors += int(np.count_nonzero(rec[:, 0] != 3))
    tris = (np.ascontiguousarray(rec[:, 1:]).view("<u4")
            .reshape(nt, 3).astype(np.int64))
    errors += int(np.count_nonzero(tris >= nv))
    errors += int(np.count_nonzero(~np.isfinite(verts)))
    return verts, tris, errors


# ----------------------------------------------------------------- topology

def _runs(keys: torch.Tensor) -> torch.Tensor:
    """The length of each run of equal values in `keys`, sorted first."""
    _, counts = torch.unique_consecutive(torch.sort(keys).values,
                                         return_counts=True)
    return counts


def components(nv: int, tris: torch.Tensor) -> torch.Tensor:
    """The size of every connected component of the vertices under the
    triangles' edges (a vertex in no triangle is a component of its own):
    hooking each edge's larger root under its smaller one, then pointer
    jumping, until every edge's ends share a root."""
    dev = tris.device
    parent = torch.arange(nv, device=dev)
    u = torch.cat([tris[:, 0], tris[:, 1]])
    v = torch.cat([tris[:, 1], tris[:, 2]])
    while True:
        pu, pv = parent[u], parent[v]
        differ = pu != pv
        if not bool(differ.any()):
            break
        lo = torch.minimum(pu, pv)[differ]
        hi = torch.maximum(pu, pv)[differ]
        parent.scatter_reduce_(0, hi, lo, reduce="amin")
        while True:
            up = parent[parent]
            if bool((up == parent).all()):
                break
            parent = up
    return torch.bincount(parent, minlength=nv)[
        torch.unique(parent)]


def duplicate_vertices(verts: np.ndarray, spacing: float,
                       device: torch.device) -> Tuple[int, int]:
    """Vertices at the position of another, (off lattice corners, on
    them). Off a corner a position names one edge and where along it, so
    two vertices there are one the welds left apart. On a corner they may
    be vertices of different edges that the field crosses at that corner
    (marching tetrahedra key a vertex by its edge): not a fault."""
    if not len(verts):
        return 0, 0
    v = torch.as_tensor(np.array(verts, np.float32), device=device)
    _, inverse, counts = torch.unique(v.view(torch.int32), dim=0,
                                      return_inverse=True,
                                      return_counts=True)
    extra = (counts[inverse] > 1)
    g = v.to(torch.float64) / spacing
    corner = ((g - torch.round(g)).abs() < CORNER_EPS).all(dim=1)
    # each position of k copies counts k - 1
    def surplus(mask):
        c = torch.bincount(inverse[mask], minlength=len(counts))
        return int((c - 1).clamp(min=0).sum())
    return surplus(extra & ~corner), surplus(extra & corner)


def mesh_checks(verts: np.ndarray, tris: np.ndarray, prune: float,
                spacing: float, device: torch.device) -> Dict[str, int]:
    """The whole mesh's topology readings (module docstring)."""
    nv = len(verts)
    t = torch.as_tensor(tris, device=device)
    if len(t) and int(t.max()) >= nv:
        t = t[(t < nv).all(dim=1)]
    degenerate = int(((t[:, 0] == t[:, 1]) | (t[:, 1] == t[:, 2])
                      | (t[:, 0] == t[:, 2])).sum())
    a = torch.cat([t[:, 0], t[:, 1], t[:, 2]])
    b = torch.cat([t[:, 1], t[:, 2], t[:, 0]])
    undirected = _runs(torch.minimum(a, b) * nv + torch.maximum(a, b))
    directed = _runs(a * nv + b)
    del a, b
    boundary = int((undirected == 1).sum())
    nonmanifold = (int((undirected > 2).sum()) + int((directed > 1).sum())
                   + degenerate)
    duplicates, corner_duplicates = duplicate_vertices(verts, spacing,
                                                       device)
    sizes = components(nv, t)
    small = int((sizes.to(torch.float64) < prune * nv).sum())
    return {"boundary_edges": boundary, "nonmanifold_edges": nonmanifold,
            "duplicate_vertices": duplicates,
            "corner_duplicates": corner_duplicates, "small_components": small,
            "components": int(len(sizes)), "vertices": nv,
            "triangles": int(len(tris))}


# -------------------------------------------------------- the MLS surface

def neighbour_pairs(queries: torch.Tensor, centres: torch.Tensor,
                    reach: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every (query, splat) pair whose distance may be under `reach`: the
    splats of the 27 hash cells of side `reach` around each query."""
    dev = queries.device
    cell = torch.floor(centres / reach).to(torch.int64)
    lo = cell.min(dim=0).values - 2
    span = cell.max(dim=0).values - lo + 3
    def key(c):
        c = c - lo
        return (c[..., 0] * span[1] + c[..., 1]) * span[2] + c[..., 2]
    skeys, perm = torch.sort(key(cell))
    qcell = torch.floor(queries / reach).to(torch.int64)
    qcell = torch.maximum(torch.minimum(qcell, lo + span - 2), lo + 1)
    r = torch.tensor([-1, 0, 1], device=dev)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       dim=-1).reshape(27, 3)
    k = key(qcell[:, None, :] + offs[None]).reshape(-1)
    first = torch.searchsorted(skeys, k, right=False)
    last = torch.searchsorted(skeys, k, right=True)
    counts = last - first
    total = int(counts.sum())
    slot = torch.repeat_interleave(torch.arange(len(k), device=dev), counts,
                                   output_size=total)
    base = torch.cumsum(counts, 0) - counts
    pos = torch.arange(total, device=dev) - base[slot] + first[slot]
    return slot // 27, perm[pos]


def mls_field(queries: torch.Tensor, splats: torch.Tensor,
              boundary_factor: float, dtype: torch.dtype,
              block: int = 4096) -> torch.Tensor:
    """The algebraic-sphere MLS field (module docstring) at `queries` (Q, 3)
    float64 grid coordinates, from `splats` (N, 8) float64 in the grid
    frame (x y z, radius in cells, nx ny nz, quality). The relative
    positions are formed in float64; weights, moments and the fit run in
    `dtype`. Returns (Q,) float64, NaN where the fit is undefined."""
    dev = queries.device
    out = torch.empty(len(queries), dtype=torch.float64, device=dev)
    reach = float(splats[:, 3].max())
    pos, rad = splats[:, 0:3], splats[:, 3]
    for s in range(0, len(queries), block):
        q = queries[s:s + block]
        qi, si = neighbour_pairs(q, pos, reach)
        p = pos[si] - q[qi]
        d64 = (p * p).sum(dim=1) / (rad[si] * rad[si])
        keep = d64 < RADIUS_CUTOFF
        qi, si, p = qi[keep], si[keep], p[keep]
        d = d64[keep].to(dtype)
        w = (1.0 - d) ** 4 * splats[si, 7].to(dtype)
        pd = p.to(dtype)
        nd = splats[si, 4:7].to(dtype)
        feats = torch.cat([w[:, None], w[:, None] * pd,
                           (w * (pd * pd).sum(dim=1))[:, None],
                           w[:, None] * nd,
                           (w * (nd * pd).sum(dim=1))[:, None]], dim=1)
        m = torch.zeros((len(q), 9), dtype=dtype, device=dev)
        m.index_add_(0, qi, feats)
        hits = torch.bincount(qi, minlength=len(q))
        out[s:s + block] = sphere_fit(m, hits, boundary_factor).to(
            torch.float64)
    return out


def _dot(a, b):
    return (a * b).sum(dim=-1)


def sphere_fit(m: torch.Tensor, hits: torch.Tensor,
               boundary_factor: float) -> torch.Tensor:
    """Signed distance of the query (the moments' origin) to the sphere
    fitted to moments m (Q, 9) = [sum w, sum w p, sum w |p|^2, sum w n,
    sum w n.p]; NaN where undefined."""
    sw, swp, swpp = m[:, 0], m[:, 1:4], m[:, 4]
    swn, swpn = m[:, 5:8], m[:, 8]
    inv = 1.0 / sw
    mean = swp * inv[:, None]
    q_den = swpp - _dot(mean, swp)
    q = (swpn - _dot(mean, swn)) / q_den
    unstable = q_den.abs() < (4 * FLT_EPSILON) * hits * swpp.abs()
    q = torch.where(unstable | ~torch.isfinite(q), torch.zeros_like(q), q)
    a = 0.5 * q
    b = (swn - q[:, None] * swp) * inv[:, None]
    c = (-a * swpp - _dot(b, swp)) * inv
    b2 = _dot(b, b)
    # the root of (a b2) l^2 + b2 l + c = 0 nearer the origin
    qa = a * b2
    bdet = b2 + torch.sqrt(b2 * b2 - 4.0 * qa * c)
    x1 = -2.0 * c / bdet
    x2 = bdet / (-2.0 * qa)
    lam = torch.where(torch.isfinite(x1), x1, x2)
    av = lam[:, None] * b
    aa = _dot(av, av)
    rhs = swpp - 2.0 * _dot(swp, av) + sw * aa
    ok = ((aa < 3.0) & (q_den > boundary_factor * rhs)
          & (hits >= HITS_CUTOFF) & torch.isfinite(lam))
    f = -_dot(b, av) / torch.sqrt(b2)
    return torch.where(ok, f, torch.full_like(f, float("nan")))


# ------------------------------------------------------- vertices to edges

def seam_sample(grid_verts: np.ndarray, rng: np.random.Generator,
                sizes: Dict[str, int], plane: int) -> np.ndarray:
    """Indices of the vertices to judge, drawn from `rng`: `uniform` of
    them from all vertices, `face` from those with an edge end on a plane
    a whole multiple of `plane` cells from the grid's origin (where blocks
    may meet: the face seam passes compute those corners), `skeleton` from
    those on two such planes (the skeleton pass's lines)."""
    near = np.rint(grid_verts)
    on_plane = (np.abs(grid_verts - near) < 0.5) & (
        np.mod(near, plane) == 0)
    frac = np.abs(grid_verts - near) >= CORNER_EPS
    # an edge whose low or high end lies on a plane along its own axis
    lo_end = np.floor(grid_verts)
    along = frac & ((np.mod(lo_end, plane) == 0)
                    | (np.mod(lo_end + 1, plane) == 0))
    planes = (on_plane & ~frac).sum(axis=1) + along.sum(axis=1)
    picks = [rng.choice(len(grid_verts),
                        size=min(sizes["uniform"], len(grid_verts)),
                        replace=False)]
    for name, mask in (("face", planes >= 1), ("skeleton", planes >= 2)):
        idx = np.nonzero(mask)[0]
        if len(idx):
            picks.append(rng.choice(idx, size=min(sizes[name], len(idx)),
                                    replace=False))
    return np.unique(np.concatenate(picks))


def edge_fields(grid_verts: np.ndarray, splats: torch.Tensor,
                boundary_factor: float, dtype: torch.dtype,
                device: torch.device):
    """Per vertex (grid coordinates, float64): the field (of precision
    `dtype`) at the two ends of the vertex's lattice edge, and where the
    vertex lies along it as a share of the edge (NaN where it lies on no
    lattice edge). The marching tetrahedra's edges run from a corner c
    along a direction of 0s and 1s (an axis, a face's diagonal or the
    cube's), so a vertex's fractional coordinates are all alike: those
    axes are the edge's. A vertex on a corner lies at share 0 of an edge
    of no length."""
    g = torch.as_tensor(grid_verts, dtype=torch.float64, device=device)
    near = torch.round(g)
    frac_axes = (g - near).abs() >= CORNER_EPS
    low = torch.floor(g)
    c0 = torch.where(frac_axes, low, near)
    c1 = c0 + frac_axes.to(torch.float64)
    share = torch.where(frac_axes, g - low, torch.full_like(g, float("nan")))
    spread = (torch.nan_to_num(share, nan=-1.0).max(dim=1).values
              - torch.nan_to_num(share, nan=2.0).min(dim=1).values)
    at = torch.nan_to_num(torch.nanmean(share, dim=1), nan=0.0)
    at = torch.where(frac_axes.any(dim=1) & (spread >= CORNER_EPS),
                     torch.full_like(at, float("nan")), at)
    f = mls_field(torch.cat([c0, c1]), splats, boundary_factor, dtype)
    return f[:len(g)], f[len(g):], at


def surface_gap(f0: torch.Tensor, f1: torch.Tensor,
                at: torch.Tensor) -> np.ndarray:
    """The distance in cells, along the reference's field, from a vertex
    at share `at` of its edge to the surface: the field of the edge's ends
    (f0, f1, float64) interpolated to the vertex. inf where the field is
    undefined or the vertex lies on no lattice edge."""
    gap = (f0 + at * (f1 - f0)).abs()
    return torch.where(torch.isfinite(gap), gap,
                       torch.full_like(gap, float("inf"))).cpu().numpy()


def grid_splats(cloud: np.ndarray, spacing: float, smooth: float,
                device: torch.device) -> torch.Tensor:
    """The raw splats in the grid frame the field is defined in (float64):
    positions over the spacing, radius times --fit-smooth over the
    spacing, quality 1 / r^2 of the smoothed world radius (upstream
    FastPly's decode)."""
    s = torch.as_tensor(cloud, device=device).to(torch.float64)
    r = s[:, 3] * smooth
    out = torch.empty_like(s)
    out[:, 0:3] = s[:, 0:3] / spacing
    out[:, 3] = r / spacing
    out[:, 4:7] = s[:, 4:7]
    out[:, 7] = 1.0 / (r * r)
    return out


def judge(buf: np.ndarray, cloud: np.ndarray, spacing: float,
          smooth: float, prune: float, boundary_factor: float,
          sample_seed: int, sample_sizes: Dict[str, int], plane: int,
          device: torch.device,
          control: Optional[torch.dtype] = None) -> Dict[str, float]:
    """Every reading of one written mesh (module docstring). With
    `control`, also `control_gap_cells`: the same sampled edges with the
    field computed in that lower precision, judged against float64."""
    verts, tris, ply_errors = read_mesh(buf)
    out: Dict[str, float] = {"ply_errors": ply_errors}
    out.update(mesh_checks(verts, tris, prune, spacing, device))
    grid = verts.astype(np.float64) / spacing
    idx = seam_sample(grid, np.random.default_rng(sample_seed),
                      sample_sizes, plane)
    splats = grid_splats(cloud, spacing, smooth, device)
    f0, f1, at = edge_fields(grid[idx], splats, boundary_factor,
                             torch.float64, device)
    gaps = surface_gap(f0, f1, at)
    out["vertex_gap_cells"] = float(gaps.max()) if len(gaps) else float("inf")
    out["judged_vertices"] = int(len(idx))
    if control is not None:
        # the control in the program's place: its vertex where its own
        # field crosses zero along the edge, judged by the float64 field
        c0, c1, at_c = edge_fields(grid[idx], splats, boundary_factor,
                                   control, device)
        cross = torch.where(at_c == 0, at_c, c0 / (c0 - c1))
        out["control_gap_cells"] = float(np.max(surface_gap(f0, f1, cross)))
    return out
