"""Offline verification of a chunked reconstruction output.

Two checks, both against the geometry the files themselves declare (the
`mlsgpu_tpu geom ...` PLY comment written by the mesher):

1. **Manifold sampling** — run the vectorized manifold oracle
   (utils/manifold.check_manifold, the re-implementation of the reference's
   plymanifold, extras/plymanifold.cpp:152-186) on a sample of chunk files.

2. **Cross-chunk continuity** — the chunked-output welding contract
   (reference src/mesher.cpp:763-852): a vertex on the cut plane between
   two adjacent chunks must appear in BOTH chunk files with bitwise-equal
   f32 world coordinates (the determinism contract makes shared cut-plane
   vertices bitwise equal: both chunks stream the same welded spill
   records through the same transform). Pure file reading — no mesh
   rebuild — so it runs at 1B scale.

   Per adjacent pair along axis a: chunk boundaries are data-dependent
   (buckets tile the absolute micro grid, not multiples of chunk_cells in
   the extent frame), so the cut plane is recovered from the files
   themselves — it lies in the tight window [B.min - eps, A.max + eps]
   along the axis, and on-plane vertices all share one exact f32 world
   coordinate there (repeated thousands of times, while interpolated
   near-plane values are continuous and essentially unique). The shared
   plane value is the bit pattern with the highest min(count_A, count_B).
   Vertices present in both files must be bitwise equal; a one-sided
   on-plane vertex fails ONLY when the other file holds a near-but-not-
   bitwise twin (a 1-ulp seam crack) -- with no nearby twin it is a
   legitimate open-surface boundary at the cut plane (the adjacent cell
   on the other side was boundary-limit rejected; the reference allows
   boundary there too, test/manifold.h:82-87). A dominant repeated
   pattern on one side with NO occurrences at all on the other is still
   a failure (the whole cut cross-section is missing from one file).

Usage:
    python -m mlsgpu_tpu_torch.tools.verify_chunks OUT_BASE.ply \
        [--sample 10] [--no-continuity]

OUT_BASE.ply is the path passed to the reconstruction; chunk files
`OUT_BASE_XXXX_YYYY_ZZZZ.ply` are discovered next to it.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

_CHUNK_RE = re.compile(r"_(\d{4})_(\d{4})_(\d{4})\.[^.]+$")
_MAX_HEADER = 65536


def parse_geom_comment(path: str) -> Optional[dict]:
    """Read the `mlsgpu_tpu geom ...` comment from a PLY header."""
    with open(path, "rb") as f:
        head = f.read(_MAX_HEADER)
    idx = head.find(b"end_header\n")
    if idx < 0:
        return None
    for line in head[:idx].decode("ascii", errors="replace").splitlines():
        t = line.split()
        if len(t) >= 3 and t[0] == "comment" and t[1] == "mlsgpu_tpu" \
                and t[2] == "geom":
            kv = dict(p.split("=", 1) for p in t[3:] if "=" in p)
            # reference/ext_lo are space-separated triples: re-parse
            m = re.search(r"spacing=(\S+) reference=(\S+) (\S+) (\S+) "
                          r"ext_lo=(\S+) (\S+) (\S+) chunk_cells=(\S+)", line)
            if not m:
                return None
            return {
                "spacing": float(m.group(1)),
                "reference": np.array([float(m.group(i)) for i in (2, 3, 4)]),
                "ext_lo": np.array([float(m.group(i)) for i in (5, 6, 7)]),
                "chunk_cells": int(m.group(8)),
            }
    return None


def read_vertices(path: str) -> np.ndarray:
    """Memory-map just the vertex section of a chunk PLY -> (N, 3) f32
    view (zero-copy; the caller must not outlive the mmap longer than
    needed)."""
    from mlsgpu_tpu_torch.io.ply import parse_header
    with open(path, "rb") as f:
        head = f.read(_MAX_HEADER)
    h = parse_header(head, need_splat_fields=False)
    mm = np.memmap(path, dtype=np.uint8, mode="r",
                   offset=h.header_size, shape=(h.vertex_count * 12,))
    return mm.view("<f4").reshape(h.vertex_count, 3)


def discover_chunks(base: str) -> Dict[Tuple[int, int, int], str]:
    """Find chunk files next to OUT_BASE.ply, keyed by chunk coords."""
    stem, ext = os.path.splitext(base)
    out = {}
    for p in sorted(glob.glob(f"{stem}_*_*_*{ext}")):
        m = _CHUNK_RE.search(p)
        if m:
            out[tuple(int(g) for g in m.groups())] = p
    return out


def _plane_value(vals_a: np.ndarray, vals_b: np.ndarray):
    """The shared on-plane coordinate: the exact bit pattern maximizing
    min(count_A, count_B). Returns (pattern, one_sided): pattern is None
    when no repeated value exists at all; one_sided is True when one file
    holds a dominant repeated pattern (>= 16 occurrences) that the other
    file lacks entirely — the cut cross-section is missing from one side."""
    ua, ca = np.unique(vals_a.view(np.uint32), return_counts=True)
    ub, cb = np.unique(vals_b.view(np.uint32), return_counts=True)
    common, ia, ib = np.intersect1d(ua, ub, return_indices=True)
    if len(common):
        mn = np.minimum(ca[ia], cb[ib])
        best = int(np.argmax(mn))
        if mn[best] >= 4:
            return common[best], False
    max_a = int(ca.max()) if len(ca) else 0
    max_b = int(cb.max()) if len(cb) else 0
    if max(max_a, max_b) >= 16:
        return None, True  # one side rides the plane, the other is absent
    return None, False


def _triple_set(verts: np.ndarray) -> np.ndarray:
    """Sorted unique (x,y,z) triples as a structured u32 view for set ops."""
    u = np.ascontiguousarray(verts).view(np.uint32).reshape(-1, 3)
    rec = u.view([("x", np.uint32), ("y", np.uint32), ("z", np.uint32)])
    return np.unique(rec)


def check_continuity(chunks: Dict[Tuple[int, int, int], str], geom: dict,
                     log=lambda s: None, on_crack=None) -> dict:
    """Compare on-plane vertex sets across every adjacent chunk pair.

    One pass per file: extracts the six near-face slabs, then compares
    pairs. Returns {"pairs", "checked", "mismatched_pairs", "missing",
    "examples"}. on_crack(pair, axis, side, vertex, twin), when given, is
    called for every near-twin crack vertex: the chunk pair, the cut axis,
    "A" or "B" for the file that alone holds `vertex`, and the other
    file's vertex nearest it (world coordinates)."""
    spacing = geom["spacing"]

    # Pass 1: per-file axis extents (one cheap scan per file). The cut
    # plane of pair (A, B) along axis a lies in [B.min - eps, A.max + eps].
    extents: Dict[Tuple[int, int, int], np.ndarray] = {}
    for coords, path in chunks.items():
        v = read_vertices(path)
        mm = np.stack([v.min(axis=0), v.max(axis=0)]) if len(v) else \
            np.zeros((2, 3), np.float32)
        extents[coords] = mm
        del v

    # Pass 2: per file, collect the candidate slab for each shared face.
    slabs: Dict[Tuple[Tuple[int, int, int], int, int], np.ndarray] = {}
    eps = 0.45 * spacing
    for coords, path in chunks.items():
        v = read_vertices(path)
        for axis in range(3):
            for side in (0, 1):
                nb = list(coords)
                nb[axis] += 1 if side else -1
                nb = tuple(nb)
                if nb not in chunks:
                    continue
                if side:
                    lo = extents[nb][0, axis] - eps
                    hi = extents[coords][1, axis] + eps
                else:
                    lo = extents[coords][0, axis] - eps
                    hi = extents[nb][1, axis] + eps
                sel = (v[:, axis] >= lo) & (v[:, axis] <= hi)
                slabs[(coords, axis, side)] = np.array(v[sel])
        del v

    pairs = 0
    mismatched = 0
    checked = 0
    boundary_verts = 0
    examples: List[str] = []
    for coords in chunks:
        for axis in range(3):
            nb = list(coords)
            nb[axis] += 1
            nb = tuple(nb)
            if nb not in chunks:
                continue
            pairs += 1
            a = slabs.get((coords, axis, 1))
            b = slabs.get((nb, axis, 0))
            if a is None or b is None:
                continue
            pv, one_sided = _plane_value(a[:, axis], b[:, axis])
            if pv is None:
                if one_sided:
                    checked += 1
                    mismatched += 1
                    if len(examples) < 5:
                        examples.append(
                            f"{coords}->{nb} axis {axis}: cut cross-"
                            f"section present on one side only "
                            f"(|A slab|={len(a)} |B slab|={len(b)})")
                continue  # surface does not cross this plane
            checked += 1
            sa = _triple_set(a[a[:, axis].view(np.uint32) == pv])
            sb = _triple_set(b[b[:, axis].view(np.uint32) == pv])
            only_a = np.setdiff1d(sa, sb)
            only_b = np.setdiff1d(sb, sa)
            # A one-sided on-plane vertex is a CRACK only when the other
            # file has geometry within a few ULPS of it but not bitwise
            # equal (float-nondeterminism twins differ by ~1 ulp; see
            # PLAN.md's seam analysis). With no ulp-near twin it is a
            # legitimate open-surface boundary at the cut plane: the
            # adjacent cell on the other side was undefined (boundary-
            # limit rejection, kernels/mls.cl:394-426) — the reference's
            # manifold contract allows boundary there too
            # (test/manifold.h:82-87). Verified on a 100M run: one-sided
            # vertices form open boundary arcs whose nearest other-side
            # geometry sits 0.02-2 CELLS away (~100+ ulps), while a
            # spacing-scaled threshold misread them as cracks.
            cracks = 0
            for rec, other, side in ((only_a, b, "A"), (only_b, a, "B")):
                for r in rec:
                    v = np.array([r["x"], r["y"], r["z"]],
                                 np.uint32).view(np.float32)
                    crack_eps = (4.0 * np.finfo(np.float32).eps
                                 * max(1.0, float(np.abs(v).max())))
                    if len(other):
                        d = np.abs(other - v[None, :]).max(axis=1)
                        if d.min() < crack_eps:
                            cracks += 1
                            if on_crack is not None:
                                on_crack((coords, nb), axis, side, v,
                                         other[int(d.argmin())])
            boundary_verts += len(only_a) + len(only_b) - cracks
            if cracks:
                mismatched += 1
                if len(examples) < 5:
                    examples.append(
                        f"{coords}->{nb} axis {axis}: {cracks} near-twin "
                        f"crack(s); |A|={len(sa)} |B|={len(sb)} "
                        f"onlyA={len(only_a)} onlyB={len(only_b)}")
            log(f"pair {coords}->{nb} axis {axis}: "
                f"{len(sa)} on-plane verts, "
                f"{len(only_a) + len(only_b)} one-sided (boundary), "
                f"{'OK' if not cracks else f'{cracks} CRACKS'}")
    return {"pairs": pairs, "checked": checked,
            "mismatched_pairs": mismatched,
            "boundary_only_verts": int(boundary_verts), "missing": 0,
            "examples": examples}


def sample_manifold(chunks: Dict[Tuple[int, int, int], str], n: int,
                    log=lambda s: None) -> dict:
    """Manifold-check an evenly-spread sample of n chunk files."""
    from mlsgpu_tpu_torch.io.ply import read_mesh
    from mlsgpu_tpu_torch.utils.manifold import check_manifold
    paths = [chunks[c] for c in sorted(chunks)]
    if n <= 0 or not paths:
        return {"sampled": 0, "failures": 0, "reports": []}
    step = max(len(paths) // n, 1)
    sel = paths[::step][:n]
    failures = 0
    reports = []
    for p in sel:
        verts, tris = read_mesh(p)
        rep = check_manifold(verts, tris)
        log(f"manifold {os.path.basename(p)}: "
            f"{'OK' if rep.is_manifold else 'FAIL ' + str(rep.reason)} "
            f"({len(verts)} v / {len(tris)} t)")
        if not rep.is_manifold:
            failures += 1
            reports.append(f"{os.path.basename(p)}: {rep.reason}")
    return {"sampled": len(sel), "failures": failures, "reports": reports}


def verify(base: str, sample: int = 10, continuity: bool = True,
           log=lambda s: print(s, file=sys.stderr, flush=True)) -> dict:
    """Full verification; returns a JSON-able result dict."""
    t0 = time.monotonic()
    chunks = discover_chunks(base)
    single = not chunks and os.path.exists(base)
    if single:
        chunks = {(0, 0, 0): base}
    geom = parse_geom_comment(next(iter(chunks.values()))) if chunks else None
    result: dict = {"chunks": len(chunks)}
    result["manifold"] = sample_manifold(chunks, sample, log=log)
    if continuity and not single:
        if geom is None:
            result["continuity"] = {"note": "no geom comment; skipped"}
        else:
            result["continuity"] = check_continuity(chunks, geom, log=log)
    result["elapsed_s"] = round(time.monotonic() - t0, 1)
    ok = (result["manifold"]["failures"] == 0
          and result.get("continuity", {}).get("mismatched_pairs", 0) == 0)
    result["ok"] = ok
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("base", help="OUT_BASE.ply (chunk files discovered)")
    p.add_argument("--sample", type=int, default=10,
                   help="manifold-check this many chunks (0 = skip)")
    p.add_argument("--no-continuity", action="store_true")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)
    log = (lambda s: None) if args.quiet else \
        (lambda s: print(s, file=sys.stderr, flush=True))
    result = verify(args.base, sample=args.sample,
                    continuity=not args.no_continuity, log=log)
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
