"""Standalone manifold verifier for PLY meshes.

Re-creation of the reference's extras/plymanifold.cpp:152-186: re-reads a
final output PLY and checks manifoldness (the project's definition of
end-to-end correctness), printing per-component metadata.

Usage: python -m mlsgpu_tpu_torch.tools.plymanifold mesh.ply [mesh2.ply ...]
"""

from __future__ import annotations

import sys

from mlsgpu_tpu_torch.io.ply import read_mesh
from mlsgpu_tpu_torch.utils.errors import FormatError
from mlsgpu_tpu_torch.utils.manifold import check_manifold


def _read_mesh(path: str):
    """Fast path for our own writer's output; general reader (ascii /
    big-endian / arbitrary layout, tools/plyio.py = reference extras/ply.h)
    for everything else."""
    try:
        return read_mesh(path)
    except FormatError:
        from mlsgpu_tpu_torch.tools.plyio import read_mesh_any
        return read_mesh_any(path)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: plymanifold mesh.ply [...]", file=sys.stderr)
        return 2
    status = 0
    for path in argv:
        verts, tris = _read_mesh(path)
        rep = check_manifold(verts, tris)
        if rep.is_manifold:
            print(f"{path}: manifold; {rep.num_vertices} vertices, "
                  f"{rep.num_triangles} triangles, "
                  f"{rep.num_components} component(s), "
                  f"{rep.num_boundary_edges} boundary edge(s), "
                  f"euler {rep.euler_characteristics}")
        else:
            print(f"{path}: NOT MANIFOLD: {rep.reason}")
            status = 1
    return status


if __name__ == "__main__":
    sys.exit(main())
