"""Out-of-core mesher: welds block meshes into final PLY output.

Re-creation of the reference's OOCMesher (src/mesher.{h,cpp}, design doc at
src/mesher.h:322-352):

- per block, a union-find over the triangles yields local components
  ("clumps"); each becomes a global clump node;
- external vertex keys (block-boundary edge ids) merge clumps across blocks
  and deduplicate boundary vertices within an output chunk;
- vertices/triangles (with their clump ids) are spilled to append-only temp
  files so host memory stays bounded;
- write() computes the prune threshold from global component sizes
  (--fit-prune, src/mesher.cpp:491-538), then streams each chunk back,
  drops pruned components, compacts indices, and writes the PLY(s);
- checkpoint()/resume() persist the mesher state + temp files so the final
  write can be re-run in a separate invocation (src/mesher.cpp:854-947).

Keys are 63-bit ints (hi << 32 | lo with the external flag stripped), chunk
ids order the output (reference ChunkId generations).
"""

from __future__ import annotations

import os
import pickle
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from mlsgpu_tpu_torch._native import KeyMap
from mlsgpu_tpu_torch.core.chunk import ChunkId
from mlsgpu_tpu_torch.core.grid import Grid
from mlsgpu_tpu_torch.io.ply import PlyWriter
from mlsgpu_tpu_torch.io.spill import SpillStore
from mlsgpu_tpu_torch.utils import logging as log
from mlsgpu_tpu_torch.utils.errors import StateError
from mlsgpu_tpu_torch.utils.statistics import get_registry
from mlsgpu_tpu_torch.utils.union_find import UnionFind


@dataclass
class BlockInput:
    """One welded block mesh, in *global grid* coordinates."""
    chunk_id: ChunkId
    vertices: np.ndarray       # (n, 3) f32 global grid coords
    first_external: int        # vertices[first_external:] have keys
    ext_keys: np.ndarray       # (n - first_external,) int64 (63-bit, flag stripped)
    triangles: np.ndarray      # (m, 3) int32/int64 into vertices


class _ClumpSet(UnionFind):
    """Union-find over global clumps carrying vertex/triangle totals."""

    def __init__(self):
        self._nv = np.zeros(0, dtype=np.int64)
        self._nt = np.zeros(0, dtype=np.int64)
        super().__init__(0)

    @property
    def num_vertices(self) -> np.ndarray:
        return self._nv[:self._n]

    @num_vertices.setter
    def num_vertices(self, arr) -> None:
        self._nv = np.ascontiguousarray(arr, dtype=np.int64)

    @property
    def num_triangles(self) -> np.ndarray:
        return self._nt[:self._n]

    @num_triangles.setter
    def num_triangles(self, arr) -> None:
        self._nt = np.ascontiguousarray(arr, dtype=np.int64)

    def _grow_buffers(self, cap: int, n: int) -> None:
        super()._grow_buffers(cap, n)
        for name in ("_nv", "_nt"):
            new = np.empty(cap, np.int64)
            new[:n] = getattr(self, name)[:n]
            setattr(self, name, new)

    def add_clumps(self, count: int) -> int:
        start = super().add(count)
        self._nv[start:self._n] = 0
        self._nt[start:self._n] = 0
        return start

    def _meta_arrays(self):
        return [self.num_vertices, self.num_triangles]


@dataclass
class _ChunkRecord:
    chunk_id: ChunkId
    key_index: KeyMap = field(default_factory=KeyMap)
    num_vertices: int = 0
    num_triangles: int = 0
    # byte offsets of this chunk's segments in the spill files
    vert_segments: List[tuple] = field(default_factory=list)  # (off, count)
    tri_segments: List[tuple] = field(default_factory=list)
    # [base, end) clump-id ranges created by this chunk's blocks — every
    # written vertex's clump id lies in one of them (ids are assigned
    # contiguously per block), so "does pruning touch this chunk" is a
    # roots-of-ranges lookup, no spill re-read (eager write cleanliness)
    clump_ranges: List[tuple] = field(default_factory=list)


class _CheckpointUnpickler(pickle.Unpickler):
    """Loads a checkpoint written by the port or by the JAX package: the JAX
    package's host classes (grid, chunk ids, key maps) load as the port's
    copies of them, so resuming never imports that package."""

    def find_class(self, module, name):
        if module == "mlsgpu_tpu" or module.startswith("mlsgpu_tpu."):
            module = "mlsgpu_tpu_torch" + module[len("mlsgpu_tpu"):]
        return super().find_class(module, name)


class OOCMesher:
    """Single-pass collector (MesherBase::numPasses == 1 for OOCMesher)."""

    VREC = 3 * 4 + 4   # vertex record: xyz f32 + clump uint32
    TREC = 3 * 4       # triangle record: abc uint32 (clump = vertex a's)

    def __init__(self, grid: Grid, prune: float = 0.0,
                 reorder_budget: int = 2 * 1024 ** 3):
        self.grid = grid
        self.prune = prune
        self.clumps = _ClumpSet()
        self.key_clump = KeyMap()
        self.chunks: Dict[ChunkId, _ChunkRecord] = {}
        # Reorder window: records stay in RAM up to the budget, spilling
        # asynchronously beyond it (--mem-reorder, src/mesher.h:514-620).
        self._verts = SpillStore("mlsgpu_tpu.verts.", reorder_budget // 2)
        self._tris = SpillStore("mlsgpu_tpu.tris.", reorder_budget // 2)
        self._finalized = False
        self._stats = get_registry()
        # per-container memory accounting (reference allocator.h:58-250)
        self._key_entries = 0        # global key->clump map entries
        self._chunk_key_entries = 0  # sum of per-chunk key->index entries
        self._nsegs = 0              # spill segment descriptors
        self._eager = None           # eager per-chunk write state
        self._vertices_total = 0     # welded vertices added so far
        # Output-chunk edge length in grid cells (None for unchunked
        # output); recorded into every output PLY's geometry comment so
        # offline verifiers can locate chunk cut planes (tools/verify_chunks).
        self.chunk_cells: Optional[int] = None

    def _geom_comments(self) -> List[str]:
        """Self-describing geometry provenance for output PLYs: the grid →
        world transform ((v + ext_lo) * spacing + reference) and the chunk
        size, enough for tools/verify_chunks to reconstruct cut-plane
        positions without the run's config (the reference likewise embeds
        provenance in PLY comments, src/mlsgpu_core.cpp:680-685)."""
        g = self.grid
        lo = " ".join(str(int(e[0])) for e in g.extents)
        ref = " ".join(repr(float(v)) for v in g.reference)
        return [(f"mlsgpu_tpu geom spacing={float(g.spacing)!r} "
                 f"reference={ref} ext_lo={lo} "
                 f"chunk_cells={int(self.chunk_cells or 0)}")]

    def _make_factory(self, writer_factory, comments=None):
        """Writer factory that always appends the geometry comment (to the
        default PlyWriter or to a caller-provided factory's writers)."""
        geom = self._geom_comments()
        if writer_factory is None:
            base = list(comments or []) + geom
            return lambda: PlyWriter(comments=base)

        def f():
            w = writer_factory()
            add = getattr(w, "add_comment", None)
            if add is not None:
                for c in geom:
                    add(c)
            return w
        return f

    # ----------------------------------------------------------- eager write
    def enable_eager_write(self, path: str, expected_blocks: Dict,
                           writer_factory=None, comments=None) -> None:
        """Write each output chunk's PLY as soon as its LAST block is added,
        on a background thread — the final write then overlaps device
        compute instead of serializing after pass 1 (measured 79 s of a
        499 s 10M run; the reference's rationale for its overlapped
        TmpWriter/AsyncWriter, src/mesher.h:514-620). Speculative w.r.t.
        pruning: each eager file is written with a PREDICTED prune decision
        per clump (component size now, scaled by the fraction of blocks
        still to come, against the prune threshold — noise components stay
        tiny, the main surface is huge, so the prediction is almost always
        exact). write() reuses a chunk's file iff the final per-clump
        decisions equal the predicted ones and rewrites it classically
        otherwise (measured: the earlier nothing-pruned speculation left
        5 of 8 chunks dirty on a 10M run because every chunk holds some
        pruned noise clump). Only valid for multi-chunk (--split) outputs —
        a single-file output needs global counts in its header.
        `expected_blocks` maps chunk coords -> the number of add() calls
        that chunk will receive."""
        import queue as _queue
        if self._finalized:
            raise StateError("mesher already finalized")
        self._eager = {
            "path": path,
            "writer_factory": self._make_factory(writer_factory, comments),
            "expected": dict(expected_blocks),
            "expected_total": sum(expected_blocks.values()),
            "seen": {},
            "seen_total": 0,
            "queue": _queue.Queue(),
            "written": {},
            "predicted": {},
            "failed": {},
        }
        import threading
        t = threading.Thread(target=self._eager_loop, name="eager-writer",
                             daemon=True)
        self._eager["thread"] = t
        t.start()

    def _predict_pruned(self, rec) -> Optional[np.ndarray]:
        """Predict the final prune decision for a completed chunk's clumps,
        as a sorted array of ORIGINAL clump ids predicted dropped (None =
        nothing). Runs on the add() thread (the union-find mutates there;
        the eager thread never touches it). The final threshold is
        prune * total_vertices at write() time; total-so-far is scaled by
        blocks-remaining to estimate it. Mispredictions are safe: write()
        verifies per-clump equality and falls back to the classic
        rewrite."""
        e = self._eager
        if not self.prune or not rec.clump_ranges:
            return None
        seen = max(e["seen_total"], 1)
        est_total = self._vertices_total * e["expected_total"] / seen
        threshold = self.prune * est_total
        ids = np.concatenate([np.arange(a, b, dtype=np.int64)
                              for a, b in rec.clump_ranges])
        roots = self.clumps.find_many(ids)
        dropped = self.clumps.num_vertices[roots] < threshold
        if not dropped.any():
            return None
        return np.sort(ids[dropped])

    def _eager_note(self, coords) -> None:
        e = self._eager
        if e is None:
            return
        e["seen"][coords] = e["seen"].get(coords, 0) + 1
        e["seen_total"] += 1
        if e["seen"][coords] == e["expected"].get(coords, -1):
            rec = self.chunks.get(coords)
            predicted = self._predict_pruned(rec) if rec is not None else None
            e["predicted"][coords] = predicted
            e["queue"].put((coords, predicted))

    def _eager_pass_a(self, rec, predicted: np.ndarray):
        """Pass A against a predicted-dropped clump-id set in ORIGINAL clump
        space: no union-find access (it belongs to the add thread), so an
        identity parent array feeds the native kernel."""
        from mlsgpu_tpu_torch import _native as nat
        use_native = nat.available()
        ident = None
        if use_native:
            hi = int(rec.clump_ranges[-1][1]) if rec.clump_ranges else 0
            ident = np.arange(hi, dtype=np.int64)
        remap = np.full(rec.num_vertices, 0xFFFFFFFF, dtype=np.uint32)
        nv = 0
        for pos, raw in self._iter_segments(rec.vert_segments, self._verts,
                                            self.VREC, 4,
                                            self.STREAM_RECORDS):
            out = (nat.write_pass_a(raw, ident, predicted, nv)
                   if use_native else None)
            if out is not None:
                kept, rm = out
                remap[pos:pos + len(raw)] = rm
                nv += kept
                continue
            keep = ~np.isin(raw[:, 3].astype(np.int64), predicted)
            ids = nv + np.cumsum(keep, dtype=np.int64) - 1
            remap[pos:pos + len(raw)][keep] = ids[keep].astype(np.uint32)
            nv += int(keep.sum())
        nt = 0
        for pos, raw in self._iter_segments(rec.tri_segments, self._tris,
                                            self.TREC, 3,
                                            self.STREAM_RECORDS):
            cnt = nat.count_tris_kept(raw, remap) if use_native else None
            if cnt is None:
                cnt = int((remap[raw[:, 0]] != 0xFFFFFFFF).sum())
            nt += cnt
        return remap, nv, nt

    def _eager_loop(self) -> None:
        e = self._eager
        t_eager = self._stats.variable("write.eager")
        while True:
            item = e["queue"].get()
            if item is None:
                return
            coords, predicted = item
            rec = self.chunks.get(coords)
            if rec is None:
                continue
            cpath = self._chunk_path(e["path"], rec.chunk_id)
            t0 = time.monotonic()
            try:
                if predicted is None or len(predicted) == 0:
                    self._write_records(cpath, [rec], [None],
                                        rec.num_vertices, rec.num_triangles,
                                        e["writer_factory"])
                else:
                    remap, nv, nt = self._eager_pass_a(rec, predicted)
                    self._write_records(cpath, [rec], [remap], nv, nt,
                                        e["writer_factory"])
                e["written"][coords] = cpath
            except BaseException as ex:  # fall back to the classic rewrite
                log.warning(f"eager write of chunk {coords} failed "
                            f"({ex}); will rewrite at finalization")
                e["failed"][coords] = ex
            t_eager.add(time.monotonic() - t0)

    def _eager_finish(self) -> None:
        e = self._eager
        if e is None or e.get("thread") is None:
            return
        e["queue"].put(None)
        e["thread"].join()
        e["thread"] = None

    def _eager_clean(self, coords, rec, pruned_arr) -> bool:
        """True when the chunk's eager file is already the correct final
        output: written without error, and the final per-clump prune
        decision equals the predicted one the file was written with (equal
        decisions => identical remap => bitwise-identical bytes)."""
        e = self._eager
        if e is None or coords not in e.get("written", {}):
            return False
        predicted = e.get("predicted", {}).get(coords)
        for a, b in rec.clump_ranges:
            ids = np.arange(a, b, dtype=np.int64)
            if pruned_arr is None:
                actual = np.zeros(len(ids), dtype=bool)
            else:
                actual = np.isin(self.clumps.find_many(ids), pruned_arr)
            pred = (np.isin(ids, predicted) if predicted is not None
                    else np.zeros(len(ids), dtype=bool))
            if not np.array_equal(actual, pred):
                return False
        return True

    # ------------------------------------------------------------------ add
    def add(self, block: BlockInput) -> None:
        """Consume one block (the reference's OOCMesher::add,
        src/mesher.cpp:447-468)."""
        if self._finalized:
            raise StateError("mesher already finalized")
        verts = np.asarray(block.vertices, dtype=np.float32)
        n = len(verts)
        first_ext = block.first_external
        keys = np.asarray(block.ext_keys, dtype=np.int64)
        assert len(keys) == n - first_ext
        if n == 0:
            self._eager_note(block.chunk_id.coords)
            return
        if self._add_native(block, verts, n, first_ext, keys):
            self._eager_note(block.chunk_id.coords)
            return
        tris = np.asarray(block.triangles, dtype=np.int64)
        if len(tris):
            # Fail loud on an internally inconsistent block: an out-of-range
            # triangle index would otherwise be undefined behaviour inside
            # the native union-find (the reference's mesher asserts the same
            # invariant, src/mesher.cpp:447-468).
            tmin, tmax = int(tris.min()), int(tris.max())
            if tmin < 0 or tmax >= n:
                raise StateError(
                    f"corrupt block mesh for chunk {block.chunk_id}: "
                    f"triangle index range [{tmin}, {tmax}] outside "
                    f"[0, {n}) welded vertices")

        # 1. Local components over the block's triangles
        # (computeLocalComponents, src/mesher.cpp:220).
        t_uf = self._stats.timer("mesher.localUF")
        t_uf.__enter__()
        local = UnionFind(n)
        if len(tris):
            local.merge_pairs(np.concatenate([tris[:, 0], tris[:, 0]]),
                              np.concatenate([tris[:, 1], tris[:, 2]]))
        roots = local.roots()
        uroots, local_label = np.unique(roots, return_inverse=True)
        num_local = len(uroots)
        t_uf.__exit__(None, None, None)

        t_cl = self._stats.timer("mesher.clumps")
        t_cl.__enter__()
        # 2. A global clump per local component (updateGlobalClumps).
        base = self.clumps.add_clumps(num_local)
        vert_clump = (base + local_label).astype(np.int64)
        np.add.at(self.clumps.num_vertices, vert_clump, 1)
        tri_clump = vert_clump[tris[:, 0]] if len(tris) else np.zeros(0, np.int64)
        np.add.at(self.clumps.num_triangles, tri_clump, 1)

        # 3. Merge clumps across blocks via shared external keys
        # (updateClumpKeyMap, src/mesher.cpp:280) — one batch get-or-insert
        # plus a batch union of the duplicates.
        if len(keys):
            ext_clumps = vert_clump[first_ext:]
            prev, was_new = self.key_clump.get_or_insert(keys, ext_clumps)
            self._key_entries += int(was_new.sum())
            dup = ~was_new & (prev != ext_clumps)
            if dup.any():
                self.clumps.merge_pairs(prev[dup], ext_clumps[dup])

        t_cl.__exit__()
        t_sp = self._stats.timer("mesher.spill")
        t_sp.__enter__()
        # 4. Spill vertices/triangles, deduplicating externals within the
        # output chunk (updateLocalClumps / reorder buffer). Chunk identity
        # is the coordinate triple; the generation number only orders writes
        # (reference ChunkId semantics, src/chunk_id.h:41-88).
        rec = self.chunks.get(block.chunk_id.coords)
        if rec is None:
            rec = self.chunks[block.chunk_id.coords] = _ChunkRecord(block.chunk_id)
        if num_local:
            rec.clump_ranges.append((base, base + num_local))

        # Which vertices get written: all internals + unseen-key externals.
        write_mask = np.ones(n, dtype=bool)
        remap = np.empty(n, dtype=np.int64)
        if len(keys):
            existing = rec.key_index.lookup(keys)
            new_flags = existing < 0
        else:
            existing = np.empty(0, np.int64)
            new_flags = np.zeros(0, dtype=bool)
        write_mask[first_ext:] = new_flags

        n_new = int(write_mask.sum())
        new_ids = rec.num_vertices + np.arange(n_new, dtype=np.int64)
        remap[write_mask] = new_ids
        remap[~write_mask] = 0  # placeholder, fixed below
        remap[first_ext:][~new_flags] = existing[~new_flags]
        # register newly-written external keys
        if new_flags.any():
            rec.key_index.get_or_insert(keys[new_flags],
                                        remap[first_ext:][new_flags])
            self._chunk_key_entries += int(new_flags.sum())

        # vertex records: xyz float32 bits + clump id in a uint32 lane
        vrec_bytes = np.empty((n_new, 4), dtype=np.uint32)
        vrec_bytes[:, 0:3] = verts[write_mask].view(np.uint32)
        vrec_bytes[:, 3] = vert_clump[write_mask].astype(np.uint32)
        off = self._verts.append(vrec_bytes)
        rec.vert_segments.append((off, n_new))
        self._nsegs += 1
        rec.num_vertices += n_new

        # triangle records (chunk-local indices; the triangle's clump is its
        # first vertex's clump, so no clump lane is stored)
        m = len(tris)
        if m:
            trec = remap[tris].astype(np.uint32)
            toff = self._tris.append(trec)
            rec.tri_segments.append((toff, m))
            self._nsegs += 1
            rec.num_triangles += m

        t_sp.__exit__()
        # Systematic per-container peaks (the reference's allocator-backed
        # Statistics::Peak per container, src/allocator.h:58-250): clump
        # union-find arrays (allocated capacity), hash maps (~32B/entry at
        # 0.5 load), and segment bookkeeping. mem.spill covers the reorder
        # window; mem.blobs the blob arrays.
        self._record_add_stats(n_new, m)
        self._eager_note(block.chunk_id.coords)

    def _add_native(self, block: BlockInput, verts, n, first_ext,
                    keys) -> bool:
        """Fused C++ hot path for add() (_native.mesher_add): local UF,
        clump registration/merge, chunk dedup/remap, and record packing in
        one pass. Returns False when unavailable (caller runs the numpy
        path). Output meshes are identical either way; only internal clump
        id numbering may differ."""
        from mlsgpu_tpu_torch import _native as nat
        rec = self.chunks.get(block.chunk_id.coords)
        fresh_rec = rec is None
        if fresh_rec:
            rec = _ChunkRecord(block.chunk_id)
        if rec.key_index._h is None or self.key_clump._h is None:
            return False
        t_nat = self._stats.timer("mesher.native")
        t_nat.__enter__()
        self.clumps.reserve(n)
        prior_clumps = len(self.clumps)
        try:
            out = nat.mesher_add(verts, block.triangles, first_ext, keys,
                                 self.clumps, len(self.clumps),
                                 self.key_clump, rec.key_index,
                                 rec.num_vertices)
        except ValueError:
            raise StateError(
                f"corrupt block mesh for chunk {block.chunk_id}: "
                f"triangle index outside [0, {n}) welded vertices")
        finally:
            t_nat.__exit__(None, None, None)
        if out is None:
            return False
        n_new, vrec, trec, nstats = out
        self.clumps.commit(int(nstats[0]))
        self._key_entries += int(nstats[1])
        self._chunk_key_entries += int(nstats[2])
        if fresh_rec:
            self.chunks[block.chunk_id.coords] = rec
        if int(nstats[0]):
            rec.clump_ranges.append((prior_clumps,
                                     prior_clumps + int(nstats[0])))

        t_sp = self._stats.timer("mesher.spill")
        t_sp.__enter__()
        off = self._verts.append(vrec)
        rec.vert_segments.append((off, n_new))
        self._nsegs += 1
        rec.num_vertices += n_new
        m = len(trec)
        if m:
            toff = self._tris.append(trec)
            rec.tri_segments.append((toff, m))
            self._nsegs += 1
            rec.num_triangles += m
        t_sp.__exit__()
        self._record_add_stats(n_new, m)
        return True

    def _record_add_stats(self, n_new: int, m: int) -> None:
        self._stats.peak("mem.mesherClumps").set(
            self.clumps._parent.nbytes + self.clumps._size.nbytes
            + self.clumps._nv.nbytes + self.clumps._nt.nbytes)
        self._stats.peak("mem.mesherKeyMaps").set(
            32 * (self._key_entries + self._chunk_key_entries))
        self._stats.peak("mem.mesherSegments").set(120 * self._nsegs)
        self._stats.counter("mesher.blocks").add(1)
        self._stats.counter("mesher.vertices").add(n_new)
        self._stats.counter("mesher.triangles").add(m)
        self._vertices_total += n_new

    # ---------------------------------------------------------------- write
    def _finalize(self) -> None:
        if not self._finalized:
            self._verts.freeze()
            self._tris.freeze()
            self._finalized = True

    def _pruned_roots(self) -> set:
        roots = self.clumps.roots()
        if len(roots) == 0:
            return set()
        uroot = np.unique(roots)
        total = int(self.clumps.num_vertices[uroot].sum())
        threshold = self.prune * total
        return {int(r) for r in uroot
                if self.clumps.num_vertices[r] < threshold}

    def write(self, path: str, writer_factory=None, comments=None,
              split_size: int = 0, progress=None,
              pruned_override: Optional[set] = None) -> List[str]:
        """Final output pass (src/mesher.cpp:763-852). One PLY per chunk when
        there are multiple chunks (--split), else a single file.

        pruned_override supplies an externally-computed pruned clump-root
        set (the distributed path computes it globally across hosts)."""
        self._eager_finish()
        self._finalize()
        writer_factory = self._make_factory(writer_factory, comments)
        pruned = (pruned_override if pruned_override is not None
                  else self._pruned_roots())
        pruned_arr = (np.sort(np.fromiter(pruned, dtype=np.int64,
                                          count=len(pruned)))
                      if pruned else None)
        chunk_ids = sorted(self.chunks.keys())
        # --split always emits coordinate-suffixed chunk files (even a single
        # chunk), so concurrent distributed writers never collide on `path`.
        multi = split_size != 0

        outputs: List[str] = []
        if multi:
            for cid in chunk_ids:
                rec = self.chunks[cid]
                cpath = self._chunk_path(path, rec.chunk_id)
                if self._eager_clean(cid, rec, pruned_arr):
                    # the eager file is bitwise what the classic pass would
                    # write (identity remap == no-prune pass A remap)
                    self._stats.counter("write.eagerClean").add(1)
                    outputs.append(cpath)
                    continue
                if self._eager is not None:
                    self._stats.counter("write.eagerDirty").add(1)
                self._write_chunk(cpath, [rec],
                                  pruned, writer_factory, comments, progress)
                outputs.append(cpath)
        else:
            self._write_chunk(path, [self.chunks[c] for c in chunk_ids],
                              pruned, writer_factory, comments, progress)
            outputs.append(path)
        return outputs

    @staticmethod
    def _chunk_path(path: str, cid: ChunkId) -> str:
        base, ext = os.path.splitext(path)
        x, y, z = cid.coords
        return f"{base}_{x:04d}_{y:04d}_{z:04d}{ext}"

    def _iter_segments(self, segments, store, rec_size, lanes, max_records):
        """Yield (rec_start, uint32 (n, lanes) array) slices of the spill
        segments, each at most max_records long (bounded memory)."""
        pos = 0
        for off, count in segments:
            done = 0
            while done < count:
                n = min(count - done, max_records)
                raw = np.frombuffer(
                    store.read(off + done * rec_size, n * rec_size),
                    dtype=np.uint32).reshape(n, lanes)
                yield pos, raw
                pos += n
                done += n

    # vertices/triangles per streamed slice of the final write (~16 MiB)
    STREAM_RECORDS = 1 << 20

    def _write_chunk(self, path, recs, pruned,
                     writer_factory, comments, progress) -> None:
        """Stream the chunk's spill segments into the output PLY with bounded
        memory (the reference's final write loop, src/mesher.cpp:763-852:
        temp-file readers + AsyncWriter double-buffering). Two passes: one
        over the clump lanes to size the output and build per-record vertex
        remaps, one over the data, written through a background writer."""
        from mlsgpu_tpu_torch import _native as nat
        from mlsgpu_tpu_torch.io.async_io import AsyncWriter
        pruned_arr = (np.sort(np.fromiter(pruned, dtype=np.int64,
                                          count=len(pruned)))
                      if pruned else None)
        use_native = nat.available()

        def keep_mask(clumps_u32):
            if pruned_arr is None:
                return np.ones(len(clumps_u32), dtype=bool)
            roots = self.clumps.find_many(clumps_u32.astype(np.int64))
            return ~np.isin(roots, pruned_arr)

        # Pass A (clump lanes): per-record remap rec-local id -> final vertex
        # id (0xFFFFFFFF = pruned) and total counts for the PLY header. A
        # triangle is kept iff its first vertex is (all three share a clump).
        remaps: List[np.ndarray] = []
        nv_total = 0
        nt_total = 0
        t_pass_a = self._stats.timer("write.passA")
        t_pass_a.__enter__()
        for rec in recs:
            remap = np.full(rec.num_vertices, 0xFFFFFFFF, dtype=np.uint32)
            for pos, raw in self._iter_segments(rec.vert_segments, self._verts,
                                                self.VREC, 4,
                                                self.STREAM_RECORDS):
                out = (nat.write_pass_a(raw, self.clumps._parent, pruned_arr,
                                        nv_total) if use_native else None)
                if out is not None:
                    kept, rm = out
                    remap[pos:pos + len(raw)] = rm
                    nv_total += kept
                    continue
                keep = keep_mask(raw[:, 3])
                ids = nv_total + np.cumsum(keep, dtype=np.int64) - 1
                remap[pos:pos + len(raw)][keep] = ids[keep].astype(np.uint32)
                nv_total += int(keep.sum())
            remaps.append(remap)
            if pruned_arr is not None:
                for pos, raw in self._iter_segments(rec.tri_segments,
                                                    self._tris, self.TREC, 3,
                                                    self.STREAM_RECORDS):
                    cnt = (nat.count_tris_kept(raw, remap)
                           if use_native else None)
                    if cnt is None:
                        cnt = int((remap[raw[:, 0]] != 0xFFFFFFFF).sum())
                    nt_total += cnt
            else:
                nt_total += rec.num_triangles
        t_pass_a.__exit__(None, None, None)

        self._write_records(path, recs, remaps, nv_total, nt_total,
                            writer_factory, progress)

    def _write_records(self, path, recs, remaps, nv_total, nt_total,
                       writer_factory, progress=None) -> None:
        """Pass B: stream the records of `recs` through their remaps into
        the output PLY with bounded memory (AsyncWriter double-buffering,
        the reference's src/async_io.h:41-148). `remaps[i] is None` means
        identity — every record kept, already in final id order (the eager
        no-prune path); per-slice aranges stand in for the array."""
        from mlsgpu_tpu_torch import _native as nat
        from mlsgpu_tpu_torch.io.async_io import AsyncWriter
        use_native = nat.available()
        writer = writer_factory()
        writer.set_num_vertices(nv_total)
        writer.set_num_triangles(nt_total)
        writer.open(path)

        # grid -> world transform (the reference's device-side ScaleBiasFilter,
        # kernels/scale_bias.cl:33-45, applied host-side during the write).
        ext_lo = np.array([e[0] for e in self.grid.extents], np.float32)
        spacing = np.float32(self.grid.spacing)
        reference = np.asarray(self.grid.reference, np.float32)

        aw = AsyncWriter(n_buffers=2,
                         buffer_size=self.STREAM_RECORDS * PlyWriter.TRIANGLE_SIZE)
        aw.start()

        def push(offset, payload: bytes) -> None:
            buf = aw.get(len(payload))
            memoryview(buf)[:len(payload)] = payload
            aw.push(writer._writer, offset, buf, len(payload))

        try:
            vpos = 0
            tpos = 0
            t_verts = self._stats.variable("write.verts")
            t_tris = self._stats.variable("write.tris")
            for rec, remap in zip(recs, remaps):
                tsec = time.monotonic()
                for pos, raw in self._iter_segments(
                        rec.vert_segments, self._verts, self.VREC, 4,
                        self.STREAM_RECORDS):
                    rm = (remap[pos:pos + len(raw)] if remap is not None
                          else np.arange(pos, pos + len(raw), dtype=np.uint32))
                    if use_native:
                        # fill the pool buffer directly (no intermediate
                        # bytes object; the writer backends take buffers)
                        buf = aw.get(len(raw) * 12)
                        n = nat.write_verts_into(
                            raw, rm, ext_lo, spacing, reference, buf)
                        if n >= 0:
                            aw.push(writer._writer,
                                    writer.vertex_byte_offset(vpos), buf, n)
                            vpos += n // 12
                            continue
                        aw._free.put(buf)  # library vanished mid-run
                    keep = rm != 0xFFFFFFFF
                    verts = raw[keep, 0:3].view(np.float32)
                    world = np.ascontiguousarray(
                        (verts + ext_lo) * spacing + reference, dtype="<f4")
                    push(writer.vertex_byte_offset(vpos), world.tobytes())
                    vpos += len(world)
                t_verts.add(time.monotonic() - tsec)
                tsec = time.monotonic()
                for pos, raw in self._iter_segments(
                        rec.tri_segments, self._tris, self.TREC, 3,
                        self.STREAM_RECORDS):
                    if remap is None:
                        # identity: indices are already final; just add the
                        # PLY list-length byte
                        trec = np.empty((len(raw), PlyWriter.TRIANGLE_SIZE),
                                        dtype=np.uint8)
                        trec[:, 0] = 3
                        trec[:, 1:] = (raw.astype("<u4").view(np.uint8)
                                       .reshape(len(raw), 12))
                        push(writer.triangle_byte_offset(tpos), trec.tobytes())
                        tpos += len(raw)
                        if progress is not None:
                            progress += len(raw)
                        continue
                    if use_native:
                        buf = aw.get(len(raw) * PlyWriter.TRIANGLE_SIZE)
                        n = nat.write_tris_into(raw, remap, buf)
                        if n >= 0:
                            aw.push(writer._writer,
                                    writer.triangle_byte_offset(tpos), buf, n)
                            ntk = n // PlyWriter.TRIANGLE_SIZE
                            tpos += ntk
                            if progress is not None:
                                progress += ntk
                            continue
                        aw._free.put(buf)
                    keep = remap[raw[:, 0]] != 0xFFFFFFFF
                    tris = remap[raw[keep].astype(np.int64)]
                    trec = np.empty((len(tris), PlyWriter.TRIANGLE_SIZE),
                                    dtype=np.uint8)
                    trec[:, 0] = 3
                    trec[:, 1:] = (tris.astype("<u4").view(np.uint8)
                                   .reshape(len(tris), 12))
                    push(writer.triangle_byte_offset(tpos), trec.tobytes())
                    tpos += len(tris)
                    if progress is not None:
                        progress += len(tris)
                t_tris.add(time.monotonic() - tsec)
        finally:
            aw.stop()
            writer.close()
        assert vpos == nv_total and tpos == nt_total
        log.info(f"wrote {path}: {nv_total} vertices, {nt_total} triangles")

    # ----------------------------------------------------- checkpoint/resume
    def checkpoint(self, path: str) -> None:
        """Persist collector state for a later write-only run
        (--checkpoint, src/mesher.cpp:854-874)."""
        self._eager_finish()
        self._finalize()
        state = {
            "grid": self.grid,
            "prune": self.prune,
            "clump_parent": np.array(self.clumps.parent),
            "clump_size": np.array(self.clumps.size),
            "clump_nv": np.array(self.clumps.num_vertices),
            "clump_nt": np.array(self.clumps.num_triangles),
            "key_clump": self.key_clump,
            "chunks": self.chunks,
            "vert_path": self._verts.flush_all(),
            "tri_path": self._tris.flush_all(),
            "chunk_cells": self.chunk_cells,
        }
        with open(path, "wb") as f:
            pickle.dump(state, f)

    @classmethod
    def resume(cls, path: str) -> "OOCMesher":
        """Reload a checkpoint (--resume, src/mesher.cpp:876-947), the
        port's or the JAX package's (_CheckpointUnpickler)."""
        with open(path, "rb") as f:
            state = _CheckpointUnpickler(f).load()
        mesher = cls.__new__(cls)
        mesher.grid = state["grid"]
        mesher.prune = state["prune"]
        mesher.clumps = _ClumpSet()
        mesher.clumps.parent = state["clump_parent"]
        mesher.clumps.size = state["clump_size"]
        mesher.clumps.num_vertices = state["clump_nv"]
        mesher.clumps.num_triangles = state["clump_nt"]
        mesher.key_clump = state["key_clump"]
        mesher.chunks = state["chunks"]
        mesher._verts = SpillStore.from_file(state["vert_path"])
        mesher._tris = SpillStore.from_file(state["tri_path"])
        mesher._finalized = True
        mesher._stats = get_registry()
        mesher._eager = None
        mesher.chunk_cells = state.get("chunk_cells")
        return mesher

    def cleanup(self) -> None:
        """Remove temp spill files."""
        self._eager_finish()
        self._finalize()
        self._verts.cleanup()
        self._tris.cleanup()
