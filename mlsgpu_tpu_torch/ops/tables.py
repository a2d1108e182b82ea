"""Marching-tetrahedra case tables, generated at import.

The cube is split into six tetrahedra around the 0-7 body diagonal — the
face-consistent decomposition (each cube face is cut by the diagonal through
its lowest-numbered corner's opposite pair), so adjacent cells agree on shared
faces. Cube corner v has coordinates (v&1, (v>>1)&1, (v>>2)&1) (x = bit 0).

For each of the 256 inside/outside codes (bit v set = corner v outside, i.e.
iso >= 0) we enumerate per-tet surface triangles, orient them so the geometric
normal points toward the outside region, deduplicate the cut edges into a
per-cell vertex list, and pack:

- ``EDGES (19, 2)``       cut-able edge endpoints (cube corner ids)
- ``EDGE_KEY (19, 3)``    per-edge midpoint in doubled (.1 fixed point) coords
- ``COUNT_TABLE (256,2)`` [num vertices, num indices] per code
- ``VERT_TABLE (256,MAX_CELL_VERTICES)``  edge id per local vertex (-1 pad)
- ``INDEX_TABLE (256,MAX_CELL_INDICES)``  local vertex index per index (-1 pad)

This plays the role of the reference's host-side table construction
(src/marching.cpp:109-247) but derives winding geometrically (midpoint
representative + inside/outside centroid test) instead of by permutation
parity; the resulting tables have identical counts (max 13 vertices / 36
indices per cell, src/marching.h:86-111).
"""

from __future__ import annotations

import itertools

import numpy as np

NUM_CUBES = 256

_CORNER = np.array([[(v >> a) & 1 for a in range(3)] for v in range(8)], dtype=np.float64)

# The six tets: (0, 7, p, q) for each cube edge (p, q) avoiding corners 0 and 7.
TETS = tuple(
    (0, 7, p, q)
    for p, q in itertools.combinations(range(1, 7), 2)
    if bin(p ^ q).count("1") == 1
)
assert len(TETS) == 6


def _build():
    # Collect every edge used by any tet, canonical (lo, hi) order.
    edge_set = set()
    for tet in TETS:
        for a, b in itertools.combinations(tet, 2):
            edge_set.add((min(a, b), max(a, b)))
    edges = sorted(edge_set)
    edge_id = {e: i for i, e in enumerate(edges)}
    num_edges = len(edges)
    assert num_edges == 19

    def tri_for(a_out, b_in_list):
        """Triangle edges for one outside vertex `a_out` vs 3 inside vertices."""
        return [(a_out, b) for b in b_in_list]

    def orient(tri_edges, outside, inside):
        """Order the 3 cut edges so the midpoint-triangle normal points toward
        the outside centroid."""
        pts = [0.5 * (_CORNER[e[0]] + _CORNER[e[1]]) for e in tri_edges]
        n = np.cross(pts[1] - pts[0], pts[2] - pts[0])
        direction = (np.mean(_CORNER[list(outside)], axis=0)
                     - np.mean(_CORNER[list(inside)], axis=0))
        if np.dot(n, direction) < 0:
            tri_edges = [tri_edges[0], tri_edges[2], tri_edges[1]]
        return tri_edges

    max_v = 0
    max_i = 0
    count = np.zeros((NUM_CUBES, 2), dtype=np.int32)
    vert_rows = []
    index_rows = []
    for code in range(NUM_CUBES):
        tris = []  # list of edge-id triples
        for tet in TETS:
            outside = [v for v in tet if (code >> v) & 1]
            inside = [v for v in tet if not (code >> v) & 1]
            if len(outside) == 1:
                a = outside[0]
                t = orient(tri_for(a, inside), outside, inside)
                tris.append([edge_id[(min(a, b), max(a, b))] for a, b in t])
            elif len(outside) == 3:
                a = inside[0]
                t = orient(tri_for(a, outside), outside, inside)
                tris.append([edge_id[(min(a, b), max(a, b))] for a, b in t])
            elif len(outside) == 2:
                (a, b), (c, d) = outside, inside
                quad = [(a, c), (b, c), (b, d), (a, d)]
                t1 = orient([quad[0], quad[1], quad[2]], outside, inside)
                t2 = orient([quad[2], quad[3], quad[0]], outside, inside)
                for t in (t1, t2):
                    tris.append([edge_id[(min(x, y), max(x, y))] for x, y in t])

        used = sorted({e for t in tris for e in t})
        local = {e: i for i, e in enumerate(used)}
        inds = [local[e] for t in tris for e in t]
        count[code] = (len(used), len(inds))
        vert_rows.append(used)
        index_rows.append(inds)
        max_v = max(max_v, len(used))
        max_i = max(max_i, len(inds))

    vert_table = np.full((NUM_CUBES, max_v), -1, dtype=np.int32)
    index_table = np.full((NUM_CUBES, max_i), -1, dtype=np.int32)
    for code in range(NUM_CUBES):
        vert_table[code, :len(vert_rows[code])] = vert_rows[code]
        index_table[code, :len(index_rows[code])] = index_rows[code]

    edges_arr = np.array(edges, dtype=np.int32)
    # Edge midpoint in doubled coords: sum of the endpoint offsets per axis
    # (same key scheme as src/marching.cpp:209-217).
    edge_key = np.array(
        [[((e[0] >> a) & 1) + ((e[1] >> a) & 1) for a in range(3)] for e in edges],
        dtype=np.int32)
    return edges_arr, edge_key, count, vert_table, index_table


EDGES, EDGE_KEY, COUNT_TABLE, VERT_TABLE, INDEX_TABLE = _build()
NUM_EDGES = len(EDGES)
MAX_CELL_VERTICES = VERT_TABLE.shape[1]
MAX_CELL_INDICES = INDEX_TABLE.shape[1]
MAX_CELL_TRIANGLES = MAX_CELL_INDICES // 3

# The reference documents the same bounds (src/marching.h:86-111).
assert MAX_CELL_VERTICES <= 13 and MAX_CELL_INDICES <= 36
