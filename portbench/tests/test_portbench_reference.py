"""The reference's pieces on shapes whose answers are known."""

import numpy as np
import pytest
import torch

from portbench import reference

CPU = torch.device("cpu")


def ply_bytes(verts, tris, count_byte=3):
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\nproperty float32 x\n"
            "property float32 y\nproperty float32 z\n"
            f"element face {len(tris)}\n"
            "property list uint8 uint32 vertex_indices\nend_header\n")
    rec = np.zeros((len(tris), 13), np.uint8)
    rec[:, 0] = count_byte
    rec[:, 1:] = np.asarray(tris, np.uint32).view(np.uint8).reshape(-1, 12)
    return np.frombuffer(head.encode() + np.asarray(verts, "<f4").tobytes()
                         + rec.tobytes(), np.uint8)


TETRA_V = [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]]
TETRA_T = [[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]]


def test_closed_tetrahedron_is_clean():
    v, t, errors = reference.read_mesh(ply_bytes(TETRA_V, TETRA_T))
    assert errors == 0 and len(v) == 4 and len(t) == 4
    got = reference.mesh_checks(v, t, 0.02, 1.0, CPU)
    assert got["boundary_edges"] == 0
    assert got["nonmanifold_edges"] == 0
    assert got["duplicate_vertices"] == 0
    assert got["components"] == 1 and got["small_components"] == 0


def test_faults_of_a_mesh_are_counted():
    # a triangle missing: 3 boundary edges; a flipped one: orientation;
    # a copy of a vertex; a stray second component
    v = TETRA_V + [[0, 0, 0], [5, 5, 5], [6, 5, 5], [5, 6, 5]]
    t = [[0, 2, 1], [0, 1, 3], [0, 3, 2], [4, 5, 6]]
    got = reference.mesh_checks(np.asarray(v, np.float32),
                                np.asarray(t), 0.5, 1.0, CPU)
    assert got["boundary_edges"] == 3 + 3
    # vertex 4 copies vertex 0, a lattice corner at spacing 1
    assert got["duplicate_vertices"] == 0
    assert got["corner_duplicates"] == 1
    assert got["components"] == 2 + 1   # vertex 7 is in no triangle
    assert got["small_components"] == 2     # sizes 4, 3, 1 against 4
    flipped = [[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 3, 2]]
    got = reference.mesh_checks(np.asarray(TETRA_V, np.float32),
                                np.asarray(flipped), 0.02, 1.0, CPU)
    assert got["nonmanifold_edges"] == 3


def test_format_errors_are_counted():
    _, _, errors = reference.read_mesh(ply_bytes(TETRA_V, TETRA_T,
                                                 count_byte=4))
    assert errors == 4
    _, _, errors = reference.read_mesh(ply_bytes(TETRA_V, [[0, 1, 9]]))
    assert errors == 1


def test_components_in_pieces():
    rng = np.random.default_rng(3)
    # a strip of triangles, shuffled labels: one component
    n = 2000
    tris = np.stack([np.arange(n - 2), np.arange(1, n - 1),
                     np.arange(2, n)], axis=1)
    perm = rng.permutation(n)
    sizes = reference.components(n, torch.as_tensor(perm[tris]))
    assert sorted(sizes.tolist()) == [n]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_field_of_a_sampled_sphere_is_its_distance(dtype):
    # splats on a sphere of radius 20 cells, normals outward: the fit is
    # the sphere itself, so the field is the signed distance to it
    rng = np.random.default_rng(1)
    n = 20000
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    splats = np.zeros((n, 8))
    splats[:, 0:3] = 20 * u
    splats[:, 3] = 3.0
    splats[:, 4:7] = u
    splats[:, 7] = 1.0
    q = np.array([[20.5, 0, 0], [0, -19.25, 0], [0, 0, 20.0],
                  [11.0, 11.0, 11.0]])
    f = reference.mls_field(torch.as_tensor(q), torch.as_tensor(splats),
                            0.0, dtype).numpy()
    want = np.linalg.norm(q, axis=1) - 20
    np.testing.assert_allclose(f, want, atol=1e-3 if dtype == torch.float32
                               else 1e-9)
    far = reference.mls_field(torch.tensor([[0.0, 0.0, 0.0]]),
                              torch.as_tensor(splats), 0.0, dtype)
    assert torch.isnan(far).all()      # no splat within reach


def test_vertex_on_a_diagonal_edge():
    rng = np.random.default_rng(2)
    n = 20000
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    splats = np.zeros((n, 8))
    splats[:, 0:3] = 20 * u
    splats[:, 3] = 3.0
    splats[:, 4:7] = u
    splats[:, 7] = 1.0
    s = torch.as_tensor(splats)
    # the cube diagonal from (11, 11, 11) crosses r = 20 at t
    t = 20 / np.sqrt(3) - 11
    v = np.array([[11 + t, 11 + t, 11 + t]])
    f0, f1, at = reference.edge_fields(v, s, 0.0, torch.float64, CPU)
    assert abs(float(at[0]) - t) < 1e-12
    assert reference.surface_gap(f0, f1, at)[0] < 1e-2
    off = reference.surface_gap(*reference.edge_fields(
        v + [[0, 0.25, 0]], s, 0.0, torch.float64, CPU))
    assert off[0] == np.inf            # on no lattice edge


def test_duplicates_off_a_corner_are_counted():
    v = np.array([[0.5, 0, 0], [0.5, 0, 0], [0.5, 0, 0], [1, 0, 0],
                  [1, 0, 0], [0, 0.25, 0.25]], np.float32)
    assert reference.duplicate_vertices(v, 1.0, CPU) == (2, 1)
