"""Array-based union-find with path compression and size-ranked merging.

Replaces src/union_find.h:51-212. Used by the mesher for local/global surface
component ("clump") identification. The numpy batch operations let the hot
per-block pass (merge along every triangle edge) run vectorized rounds instead
of a per-edge Python loop.
"""

from __future__ import annotations

import numpy as np


def _native():
    try:
        from mlsgpu_tpu_torch import _native as nat
        return nat if nat.available() else None
    except Exception:
        return None


class UnionFind:
    """Union-find over n elements with per-root size metadata.

    Subclasses add root-accumulated metadata by overriding _meta_arrays()
    (the reference's node-metadata merge hook, src/union_find.h:51-212).
    Batch operations use the native C++ implementation when available.
    """

    def __init__(self, n: int):
        self._n = int(n)
        self._parent = np.arange(self._n, dtype=np.int64)
        self._size = np.ones(self._n, dtype=np.int64)

    # parent/size are exposed as prefix views over capacity buffers so that
    # add() is amortized O(1) per element (the reference grows its node
    # vector the same way; a per-block np.concatenate would be O(blocks^2)
    # across a multi-thousand-block run).
    @property
    def parent(self) -> np.ndarray:
        return self._parent[:self._n]

    @parent.setter
    def parent(self, arr) -> None:
        self._parent = np.ascontiguousarray(arr, dtype=np.int64)
        self._n = len(self._parent)

    @property
    def size(self) -> np.ndarray:
        return self._size[:self._n]

    @size.setter
    def size(self, arr) -> None:
        self._size = np.ascontiguousarray(arr, dtype=np.int64)

    def __len__(self) -> int:
        return self._n

    def _grow_buffers(self, cap: int, n: int) -> None:
        """Reallocate capacity buffers to `cap`, preserving the first `n`
        elements. Subclasses with metadata arrays extend this."""
        newp = np.empty(cap, np.int64)
        newp[:n] = self._parent[:n]
        self._parent = newp
        news = np.empty(cap, np.int64)
        news[:n] = self._size[:n]
        self._size = news

    def reserve(self, count: int) -> None:
        """Grow capacity for `count` more nodes without committing them
        (a native batch fills the raw buffers, then commit()s)."""
        need = self._n + count
        if need > len(self._parent):
            self._grow_buffers(max(need, 2 * len(self._parent), 64), self._n)

    def commit(self, count: int) -> int:
        """Commit `count` reserved nodes already initialized in the raw
        buffers; returns the index of the first."""
        start = self._n
        self._n += count
        return start

    def add(self, count: int = 1) -> int:
        """Append new singleton elements; returns index of the first new one."""
        start = self._n
        need = start + count
        if need > len(self._parent):
            self._grow_buffers(max(need, 2 * len(self._parent), 64), start)
        self._parent[start:need] = np.arange(start, need, dtype=np.int64)
        self._size[start:need] = 1
        self._n = need
        return start

    def find(self, x: int) -> int:
        parent = self.parent
        root = x
        while parent[root] != root:
            root = parent[root]
        # Path compression
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return int(root)

    def _meta_arrays(self):
        """int64 arrays accumulated into the root on every merge."""
        return []

    def find_many(self, xs: np.ndarray) -> np.ndarray:
        """Vectorized find: repeatedly map through parent until fixpoint,
        then compress."""
        nat = _native()
        if nat is not None:
            out = nat.uf_find_many(self.parent, xs)
            if out is not None:
                return out
        parent = self.parent
        roots = np.asarray(xs, dtype=np.int64)
        while True:
            nxt = parent[roots]
            if np.array_equal(nxt, roots):
                break
            roots = nxt
        parent[np.asarray(xs, dtype=np.int64)] = roots
        return roots

    def on_merge(self, root: int, child: int) -> None:
        """Called after child's tree is attached under root."""
        for m in self._meta_arrays():
            m[root] += m[child]

    def merge(self, a: int, b: int) -> int:
        """Union the sets of a and b; returns the new root."""
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return ra
        if self.size[ra] < self.size[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.size[ra] += self.size[rb]
        self.on_merge(ra, rb)
        return ra

    def merge_pairs(self, a: np.ndarray, b: np.ndarray) -> None:
        """Union many pairs. Vectorized rounds: each round links every root to
        the min root among its pending partners, halving the component count
        per round (O(E * alpha-ish rounds) in practice)."""
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        nat = _native()
        if nat is not None and nat.uf_merge_pairs(
                self.parent, self.size, self._meta_arrays(), a, b):
            return
        while len(a):
            ra = self.find_many(a)
            rb = self.find_many(b)
            keep = ra != rb
            ra, rb = ra[keep], rb[keep]
            if not len(ra):
                break
            lo = np.minimum(ra, rb)
            hi = np.maximum(ra, rb)
            # For each hi root, attach to the smallest lo partner this round.
            order = np.lexsort((lo, hi))
            hi_s, lo_s = hi[order], lo[order]
            first = np.ones(len(hi_s), dtype=bool)
            first[1:] = hi_s[1:] != hi_s[:-1]
            child, root = hi_s[first], lo_s[first]
            # A node must not be both child and root in the same round, or
            # size accumulation order would matter; defer such links.
            is_child = np.zeros(len(self.parent), dtype=bool)
            is_child[child] = True
            ok = ~is_child[root]
            child, root = child[ok], root[ok]
            np.add.at(self.size, root, self.size[child])
            for m in self._meta_arrays():
                np.add.at(m, root, m[child])
            self.parent[child] = root
            a, b = ra, rb  # re-examine remaining links next round

    def component_size(self, x: int) -> int:
        return int(self.size[self.find(x)])

    def roots(self) -> np.ndarray:
        """Root id for every element (fully compressed)."""
        return self.find_many(np.arange(len(self.parent)))
