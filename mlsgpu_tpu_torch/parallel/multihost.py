"""Multi-host distributed reconstruction (the mlsgpu-mpi analogue).

Role mapping from the reference (SURVEY.md §2.9, mlsgpu-mpi.cpp):

- P8 collective blob/bbox pass -> each process streams its partition of the
  input and the blob arrays are all-gathered (every process then derives the
  *identical* bucket decomposition — replacing the shared-FS blob files +
  Allreduce of src/splat_set_mpi.h:83-179).
- P6 bucket scatter -> deterministic static assignment of output chunks to
  processes (spatial sharding), replacing the master/slave pull model
  (mlsgpu-mpi.cpp:202-246). Because external-vertex welding is per chunk and
  chunk borders are duplicated by design, chunk-sharding needs no cross-host
  mesh traffic at all.
- P7/P9 gather + parallel write -> each process runs its own mesher and
  writes its own chunk PLYs (per-host sharded files replace MPI-IO).
- pruning -> component sizes are global: per-process clump summaries
  (key -> root clump, root sizes) are all-gathered and merged identically on
  every process, so all agree on the pruned set (replacing the reference's
  global clump union over gathered keys).
- P10 progress / statistics -> statistics registries are all-gathered and
  merged on rank 0 (mlsgpu-mpi.cpp:302-339).

Transports: `TorchTransport` rides torch.distributed (gloo: the payloads are
pickled host objects) with a TCPStore on rank 0 for the shared counters;
`LocalTransport` is the in-process fake used by tests (the reference tests
the same logic with `mpirun -n 4` on one box, wscript:543-551).

Port of mlsgpu_tpu/parallel/multihost.py: the host logic is that module's,
the transport and the device path are the port's.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mlsgpu_tpu_torch.config import ReconstructConfig
from mlsgpu_tpu_torch.io.splat_set import SplatSource
from mlsgpu_tpu_torch.pipeline import blobs as blobs_mod
from mlsgpu_tpu_torch.pipeline import bucket as bucket_mod
from mlsgpu_tpu_torch.pipeline.blobs import BlobArray, BlobInfo
from mlsgpu_tpu_torch.pipeline.mesher import OOCMesher
from mlsgpu_tpu_torch.utils import logging as log
from mlsgpu_tpu_torch.utils.errors import InvalidOption, MlsError
from mlsgpu_tpu_torch.utils.statistics import get_registry


class Transport:
    """Minimal collective interface over processes."""

    @property
    def rank(self) -> int:
        raise NotImplementedError

    @property
    def size(self) -> int:
        raise NotImplementedError

    def allgather(self, obj) -> List:
        """Gather a picklable object from every process, same order on all."""
        raise NotImplementedError

    def progress_counter(self, name: str = "progress"):
        """A cross-process shared monotonic counter (add/read), or None when
        the transport has no side channel. Backs distributed progress
        (the ProgressMPI delta channel, src/progress_mpi.h:54-88)."""
        return None

    def claim_counter(self, name: str = "workqueue"):
        """A cross-process fetch-and-add counter (`claim() -> int`, each call
        returns a globally unique increasing index), or None when the
        transport has no side channel. Backs the dynamic work queue — the
        analogue of the reference's pull-model scatter (slaves
        MPI_Sendrecv NEED_WORK, master answers; mlsgpu-mpi.cpp:202-246)."""
        return None


class PeerWatchdog:
    """Bounded failure detection for collectives (the role the reference's
    MPI error handler plays: any rank error aborts the whole job,
    mlsgpu-mpi.cpp:541-628).

    Every rank bumps a per-rank heartbeat counter from a daemon thread,
    whether it is computing or blocked. `watch(fn)` runs a blocking
    collective on a worker thread while the caller polls peer heartbeats: a
    peer whose counter stops advancing for `timeout` seconds is declared
    dead and the job aborts (default `os._exit`) instead of hanging in the
    collective forever. Heartbeats distinguish alive-but-busy (fine — a
    peer may compute for hours before reaching the collective) from dead.
    """

    EXIT_CODE = 13

    def __init__(self, rank: int, size: int,
                 beat: Callable[[], None],
                 read_peer: Callable[[int], int],
                 interval: float = 5.0,
                 timeout: Optional[float] = None,
                 abort: Optional[Callable[[int, float], None]] = None):
        self._rank, self._size = rank, size
        self._beat, self._read = beat, read_peer
        self._interval = interval
        self._timeout = (timeout if timeout is not None else
                         float(os.environ.get("MLSGPU_HB_TIMEOUT", 120.0)))
        self._abort = abort if abort is not None else self._default_abort
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._beat_loop,
                                        name="heartbeat", daemon=True)
        self._thread.start()

    def _beat_loop(self) -> None:
        # Beat immediately so peers see liveness before the first interval.
        while True:
            try:
                self._beat()
            except Exception:
                return  # coordinator gone; the job is ending anyway
            if self._stop.wait(self._interval):
                return

    def stop(self) -> None:
        self._stop.set()

    def _default_abort(self, peer: int, stale_s: float) -> None:
        log.error(f"rank {self._rank}: peer rank {peer} heartbeat stale for "
                  f"{stale_s:.0f}s (> {self._timeout:.0f}s) while waiting in "
                  f"a collective; aborting the job (reference MPI error "
                  f"handler semantics, mlsgpu-mpi.cpp:541-628)")
        os._exit(self.EXIT_CODE)

    def watch(self, fn: Callable[[], object]):
        """Run blocking `fn()` on a worker thread; poll peer heartbeats while
        it blocks; abort on a stale peer. Returns fn's result (re-raises its
        exception)."""
        box: Dict[str, object] = {}

        def run():
            try:
                box["result"] = fn()
            except BaseException as e:  # re-raised on the caller thread
                box["error"] = e

        t = threading.Thread(target=run, name="collective", daemon=True)
        t.start()
        start = time.monotonic()
        last_val: Dict[int, int] = {}
        # A peer counts as advancing only when its counter is OBSERVED to
        # change; a failing read (e.g. the coordinator process itself died)
        # therefore also runs the staleness clock instead of masking it.
        last_change: Dict[int, float] = {
            r: start for r in range(self._size) if r != self._rank}
        poll = min(self._interval, 1.0)
        while True:
            t.join(poll)
            if not t.is_alive():
                break
            now = time.monotonic()
            for r in list(last_change):
                try:
                    v = int(self._read(r))
                except Exception:
                    v = None  # unreadable: staleness clock keeps running
                if v is not None and v != last_val.get(r):
                    last_val[r] = v
                    last_change[r] = now
                elif now - last_change[r] > self._timeout:
                    self._abort(r, now - last_change[r])
                    # test-injected aborts return; stop double-reporting
                    last_change[r] = now
        if "error" in box:
            raise box["error"]
        return box.get("result")


class LocalTransport(Transport):
    """In-process fake: N logical ranks running in threads, synchronized by
    a barrier (the test analogue of multiple local MPI ranks)."""

    def __init__(self, rank: int, size: int, shared: Dict):
        self._rank = rank
        self._size = size
        self._shared = shared
        self._round = 0

    @classmethod
    def make(cls, size: int) -> List["LocalTransport"]:
        shared = {"rounds": {}, "barrier": threading.Barrier(size),
                  "lock": threading.Lock()}
        return [cls(r, size, shared) for r in range(size)]

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def size(self) -> int:
        return self._size

    def allgather(self, obj) -> List:
        rounds = self._shared["rounds"]
        with self._shared["lock"]:
            rounds.setdefault(self._round, {})[self._rank] = obj
        self._shared["barrier"].wait()
        out = [rounds[self._round][r] for r in range(self._size)]
        self._shared["barrier"].wait()
        with self._shared["lock"]:
            rounds.pop(self._round, None)
        self._round += 1
        return out

    def progress_counter(self, name: str = "progress"):
        lock = self._shared["lock"]
        counters = self._shared.setdefault("counters", {})

        class _Local:
            def add(self, n: int) -> None:
                with lock:
                    counters[name] = counters.get(name, 0) + int(n)

            def read(self) -> int:
                with lock:
                    return counters.get(name, 0)

        return _Local()

    def claim_counter(self, name: str = "workqueue"):
        lock = self._shared["lock"]
        counters = self._shared.setdefault("counters", {})
        key = f"claim/{name}"

        class _LocalClaim:
            def claim(self) -> int:
                with lock:
                    v = counters.get(key, 0)
                    counters[key] = v + 1
                    return v

        return _LocalClaim()


def _hb_timeout() -> float:
    return float(os.environ.get("MLSGPU_HB_TIMEOUT", 120.0))


class _StoreCounter:
    """One shared integer in rank 0's TCPStore (`add(key, 0)` reads). Each
    role (claims, progress, heartbeat, the watchdog's reads, the process
    group) has a store client of its own, so the thread behind one never
    waits on another's store operation."""

    def __init__(self, client, key: str):
        self._client, self._key = client, key

    def add(self, n: int) -> None:
        if n:
            self._client.add(self._key, int(n))

    def read(self) -> int:
        return int(self._client.add(self._key, 0))

    def claim(self) -> int:
        return int(self._client.add(self._key, 1)) - 1


class TorchTransport(Transport):
    """Cross-host collectives over torch.distributed with the gloo backend
    (`all_gather_object` pickles the payloads, which are host objects; gloo
    also lets several ranks share one GPU, which NCCL refuses). The shared
    counters (work queue, progress, heartbeats) are `TCPStore.add` on the
    store that rank 0 hosts at the coordinator's address."""

    #: gloo's own timeout for one collective. A peer may compute for hours
    #: before it reaches the collective, so the bound on a dead peer is the
    #: watchdog's (MLSGPU_HB_TIMEOUT), not this.
    COLLECTIVE_TIMEOUT_S = 7 * 24 * 3600.0

    def __init__(self, host: str, port: int, rank: int, size: int,
                 master_store=None):
        self._host, self._port = host, int(port)
        self._rank, self._size = int(rank), int(size)
        self._master = master_store  # rank 0 keeps the server alive
        self._group = None
        # Every store client this rank will use is opened now, while the
        # store is known to be there: opening one later, after rank 0 has
        # died, would wait out the whole connect timeout.
        self._claims = self._client()
        self._progress = self._client()
        # Failure detection (reference MPI error handler semantics,
        # mlsgpu-mpi.cpp:541-628): heartbeats over the store; a rank that
        # dies mid-run kills the waiting peers within a bounded time
        # instead of leaving them blocked in allgather forever.
        self._watchdog: Optional[PeerWatchdog] = None
        if self._size > 1:
            timeout = _hb_timeout()
            beat = _StoreCounter(self._client(), f"mlsgpu/hb/{self._rank}")
            reader = self._client()
            self._watchdog = PeerWatchdog(
                self._rank, self._size, lambda: beat.add(1),
                lambda r: int(reader.add(f"mlsgpu/hb/{r}", 0)),
                interval=min(5.0, timeout / 4.0), timeout=timeout)

    def _client(self):
        """A new client of rank 0's store (the server may be this process's
        own)."""
        from datetime import timedelta

        from torch.distributed import TCPStore
        return TCPStore(self._host, self._port, None, False,
                        timeout=timedelta(seconds=_connect_timeout()))

    def connect(self) -> None:
        """Join the process group. First every rank registers in the store
        and waits until all have (bounded by MLSGPU_CONNECT_TIMEOUT: a rank
        that never starts is an error, not a hang); then the group is built
        under the watchdog, so a rank that dies while the others connect is
        noticed within MLSGPU_HB_TIMEOUT."""
        from datetime import timedelta

        import torch.distributed as dist
        joined = _StoreCounter(self._progress, "mlsgpu/joined")
        joined.add(1)
        deadline = time.monotonic() + _connect_timeout()
        while joined.read() < self._size:
            if time.monotonic() > deadline:
                raise MlsError(
                    f"rank {self._rank}: only {joined.read()} of "
                    f"{self._size} processes reached the coordinator "
                    f"{self._host}:{self._port} within "
                    f"{_connect_timeout():.0f}s")
            time.sleep(0.05)
        store = self._master if self._master is not None else self._client()

        def init():
            dist.init_process_group(
                "gloo", store=store, rank=self._rank, world_size=self._size,
                timeout=timedelta(seconds=self.COLLECTIVE_TIMEOUT_S))
        self._watch(init)
        self._group = dist.group.WORLD

    def _watch(self, fn):
        return self._watchdog.watch(fn) if self._watchdog is not None else fn()

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def size(self) -> int:
        return self._size

    def allgather(self, obj) -> List:
        return self._watch(lambda: self._allgather_impl(obj))

    def _allgather_impl(self, obj) -> List:
        import torch.distributed as dist
        out: List = [None] * self._size
        dist.all_gather_object(out, obj, group=self._group)
        return out

    def claim_counter(self, name: str = "workqueue"):
        return _StoreCounter(self._claims, f"mlsgpu/claim/{name}")

    def progress_counter(self, name: str = "progress"):
        """Shared counter in rank 0's store: the delta channel of the
        reference's ProgressMPI."""
        return _StoreCounter(self._progress, f"mlsgpu/{name}")

    def close(self) -> None:
        """Leave the group after every rank has reached this point, so
        rank 0 (and its store) does not go while a peer still needs it."""
        import torch.distributed as dist
        self.allgather(None)
        if self._watchdog is not None:
            self._watchdog.stop()
        if self._group is not None:
            dist.destroy_process_group()
            self._group = None


def _connect_timeout() -> float:
    return float(os.environ.get("MLSGPU_CONNECT_TIMEOUT", 300.0))


def _split_address(coordinator: str) -> Tuple[str, int]:
    host, sep, port = coordinator.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise InvalidOption(f"--coordinator {coordinator!r}: expected "
                            "HOST:PORT")
    return host, int(port)


def init_distributed(coordinator: str, num_processes: int,
                     process_id: int) -> TorchTransport:
    """Start the multi-host runtime (MPI_Init analogue): rank 0 hosts the
    TCPStore at the coordinator's address, every rank connects to it
    (waiting up to MLSGPU_CONNECT_TIMEOUT seconds for it to appear) and
    joins a gloo process group built on that store."""
    from datetime import timedelta

    from torch.distributed import TCPStore
    host, port = _split_address(coordinator or "")
    master = None
    if process_id == 0:
        try:
            master = TCPStore(host, port, num_processes, True,
                              timeout=timedelta(seconds=_connect_timeout()),
                              wait_for_workers=False)
        except RuntimeError as e:
            raise MlsError(f"cannot host the coordinator store at "
                           f"{coordinator}: {e}") from e
    try:
        transport = TorchTransport(host, port, process_id, num_processes,
                                   master_store=master)
    except RuntimeError as e:
        raise MlsError(f"rank {process_id}: no coordinator at {coordinator} "
                       f"within {_connect_timeout():.0f}s: {e}") from e
    transport.connect()
    return transport


class DistributedProgress:
    """Progress aggregation across ranks (the ProgressMPI analogue,
    src/progress_mpi.h:54-88): every rank publishes deltas into the
    transport's shared counter; rank 0 owns the display and a poller thread
    refreshes it from the global count. Degrades to rank-local display when
    the transport has no side channel."""

    def __init__(self, transport: Transport, total: int, show: bool,
                 label: str = "reconstructing", poll_interval: float = 0.5):
        from mlsgpu_tpu_torch.utils.progress import NullProgress, ProgressDisplay
        self._counter = transport.progress_counter()
        self._rank = transport.rank
        self._display = (ProgressDisplay(total, label=label)
                         if show and self._rank == 0 else NullProgress())
        self._local = 0
        self._thread = None
        self._stop = threading.Event()
        if self._counter is not None and self._rank == 0 and show:
            self._thread = threading.Thread(target=self._poll,
                                            args=(poll_interval,),
                                            name="progress-poll", daemon=True)
            self._thread.start()

    def _poll(self, interval: float) -> None:
        shown = 0
        while not self._stop.wait(interval):
            n = self._counter.read()
            if n > shown:
                self._display.add(n - shown)
                shown = n

    def add(self, n: int) -> None:
        self._local += int(n)
        if self._counter is not None:
            self._counter.add(n)
            # rank 0's display is fed by the poller (global count)
        else:
            self._display.add(n)

    def __iadd__(self, n: int) -> "DistributedProgress":
        self.add(n)
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            n = self._counter.read()
            # final draw with whatever the global count reached
            self._display.add(max(n - self._display.current, 0))


def _partition(total: int, rank: int, size: int) -> Tuple[int, int]:
    """Contiguous range partition (reference SplatSet partition(rank,size))."""
    lo = total * rank // size
    hi = total * (rank + 1) // size
    return lo, hi


class _RangeLimitedSource(SplatSource):
    """View of a source restricted to a global-id range (for the partitioned
    blob pass)."""

    def __init__(self, base: SplatSource, lo: int, hi: int):
        self._base = base
        self._lo, self._hi = lo, hi

    def __len__(self) -> int:
        return self._hi - self._lo

    def iter_chunks(self, chunk_size: int = 4 * 1024 * 1024):
        for start in range(self._lo, self._hi, chunk_size):
            stop = min(start + chunk_size, self._hi)
            yield start, self._base.read_ranges([(start, stop)])

    def read_ranges(self, ranges):
        return self._base.read_ranges(ranges)


def distributed_blobs(source: SplatSource, cfg: ReconstructConfig,
                      transport: Transport) -> BlobInfo:
    """Partitioned blob pass + allgather merge; every process ends with the
    identical BlobInfo (P8)."""
    lo, hi = _partition(len(source), transport.rank, transport.size)
    part = _RangeLimitedSource(source, lo, hi)
    local = blobs_mod.compute_blobs(part, cfg.fit_grid, cfg.micro_cells,
                                    mem_budget=cfg.mem_blobs)

    gathered = transport.allgather({
        "blobs": local.blobs,
        "ext": local.grid.extents,
        "nonfinite": local.num_nonfinite,
        "n": local.num_splats,
    })
    blob_arrays = [g["blobs"] for g in gathered]
    blobs = BlobArray(
        start=np.concatenate([b.start for b in blob_arrays]),
        count=np.concatenate([b.count for b in blob_arrays]),
        lo=np.concatenate([b.lo for b in blob_arrays]),
        hi=np.concatenate([b.hi for b in blob_arrays]),
    )
    exts = np.array([g["ext"] for g in gathered])  # (R, 3, 2)
    extents = tuple((int(exts[:, a, 0].min()), int(exts[:, a, 1].max()))
                    for a in range(3))
    from mlsgpu_tpu_torch.core.grid import Grid
    grid = Grid.make((0.0, 0.0, 0.0), cfg.fit_grid, extents)
    micro_lo = blobs.lo.min(axis=0)
    micro_dims = blobs.hi.max(axis=0) - micro_lo + 1
    return BlobInfo(blobs=blobs, grid=grid, micro_lo=micro_lo,
                    micro_dims=micro_dims,
                    num_splats=sum(g["n"] for g in gathered),
                    num_nonfinite=sum(g["nonfinite"] for g in gathered))


def assign_chunks(buckets: Sequence[bucket_mod.Bucket], size: int
                  ) -> List[int]:
    """Deterministic chunk -> rank assignment balancing estimated splats
    (the static replacement for the reference's pull-model scatter)."""
    chunk_loads: Dict[tuple, int] = {}
    for b in buckets:
        chunk_loads[b.chunk_id.coords] = (
            chunk_loads.get(b.chunk_id.coords, 0) + b.num_splats)
    # largest-first greedy onto least-loaded rank (stable order)
    order = sorted(chunk_loads, key=lambda c: (-chunk_loads[c], c))
    rank_load = [0] * size
    owner: Dict[tuple, int] = {}
    for coords in order:
        r = int(np.argmin(rank_load))
        owner[coords] = r
        rank_load[r] += chunk_loads[coords]
    return owner


def _clump_summary(mesher: OOCMesher):
    """(keys, key_root_clump, roots, root_nv) for the prune exchange."""
    keys, clump_ids = mesher.key_clump.items_arrays()
    key_roots = (mesher.clumps.find_many(clump_ids)
                 if len(clump_ids) else np.empty(0, np.int64))
    all_roots = np.unique(mesher.clumps.roots()) if len(mesher.clumps) else \
        np.empty(0, np.int64)
    root_nv = mesher.clumps.num_vertices[all_roots] if len(all_roots) else \
        np.empty(0, np.int64)
    return keys, key_roots, all_roots, root_nv


def global_pruned_roots_multi(meshers: Sequence[OOCMesher], prune: float,
                              transport: Transport) -> List[set]:
    """All-gather clump summaries (each rank may hold several partial
    meshers, e.g. after a rank-count-changing resume) and compute the
    globally-consistent pruned set of local clump roots, per local mesher."""
    summaries = transport.allgather([_clump_summary(m) for m in meshers])

    # Build a union-find over (rank, mesher, root) nodes, merged by shared
    # external-vertex keys.
    node_id: Dict[tuple, int] = {}
    sizes: List[int] = []

    def node(rank, mi, root):
        k = (rank, mi, int(root))
        if k not in node_id:
            node_id[k] = len(sizes)
            sizes.append(0)
        return node_id[k]

    for r, rank_sums in enumerate(summaries):
        for mi, (keys, key_roots, roots, root_nv) in enumerate(rank_sums):
            for root, nv in zip(roots, root_nv):
                sizes[node(r, mi, root)] = int(nv)

    from mlsgpu_tpu_torch.utils.union_find import UnionFind
    uf = UnionFind(len(sizes))
    by_key: Dict[int, int] = {}
    for r, rank_sums in enumerate(summaries):
        for mi, (keys, key_roots, roots, root_nv) in enumerate(rank_sums):
            for k, root in zip(keys, key_roots):
                n = node(r, mi, root)
                prev = by_key.setdefault(int(k), n)
                if prev != n:
                    uf.merge(prev, n)
    # aggregate sizes per merged component
    comp_size: Dict[int, int] = {}
    for nid, sz in enumerate(sizes):
        root = uf.find(nid)
        comp_size[root] = comp_size.get(root, 0) + sz
    total = sum(sizes)
    threshold = prune * total
    my_rank = transport.rank
    pruned: List[set] = [set() for _ in meshers]
    for (r, mi, root), nid in node_id.items():
        if r == my_rank and comp_size[uf.find(nid)] < threshold:
            pruned[mi].add(root)
    return pruned


def global_pruned_roots(mesher: OOCMesher, prune: float,
                        transport: Transport) -> set:
    """Single-mesher form of global_pruned_roots_multi."""
    return global_pruned_roots_multi([mesher], prune, transport)[0]


def reconstruct_distributed(source: SplatSource, cfg: ReconstructConfig,
                            output: str, transport: Transport,
                            device="cuda", writer_factory=None) -> List[str]:
    """One rank of a distributed run: every process computes the same
    buckets, runs its chunks over its devices (taken as a single process
    takes them: pipeline.reconstruct.prepare_run), exchanges prune info,
    writes its own chunk files. Returns this process's output paths."""
    from mlsgpu_tpu_torch.pipeline.reconstruct import (
        block_result_to_input, output_chunk_cells, prepare_run)
    from mlsgpu_tpu_torch.pipeline.streamer import (consume_threaded,
                                                    stream_blocks)

    devices, readback = prepare_run(cfg, device)
    info = distributed_blobs(source, cfg, transport)

    # Fault-injection hook for the real-process failure test (the reference
    # has no runtime recovery either — a rank failure must ABORT the job,
    # not hang it; mlsgpu-mpi.cpp:541-628).
    die = os.environ.get("MLSGPU_TEST_DIE_RANK")
    if die is not None and int(die) == transport.rank:
        log.error("test hook: rank exiting (MLSGPU_TEST_DIE_RANK)")
        os._exit(7)

    chunk_cells = output_chunk_cells(cfg) or cfg.device_block_cells
    buckets = bucket_mod.make_buckets(
        info, cfg.device_block_cells, cfg.micro_cells,
        max_splats=min(cfg.max_device_splats, cfg.mem_bucket_splats // 32),
        chunk_cells=chunk_cells, max_split=cfg.max_split)

    # Work distribution. Dynamic (default): chunks are claimed one at a time
    # from a shared fetch-and-add queue, largest first — the analogue of the
    # reference's pull-model scatter (slaves request work, the master
    # answers, mlsgpu-mpi.cpp:202-246) — so a skewed input self-balances.
    # Static: one-shot greedy assignment (deterministic, needs no side
    # channel).
    claimer = (transport.claim_counter("chunks")
               if cfg.scatter == "dynamic" else None)
    by_chunk: Dict[tuple, List] = {}
    for b in buckets:
        by_chunk.setdefault(b.chunk_id.coords, []).append(b)
    if claimer is not None:
        # Deterministic largest-first claim order: the costliest chunks are
        # claimed while the most spare capacity remains.
        chunk_order = sorted(
            by_chunk, key=lambda c: (-sum(b.num_splats for b in by_chunk[c]),
                                     c))
        log.info(f"rank {transport.rank}: dynamic scatter over "
                 f"{len(chunk_order)} chunks / {len(buckets)} buckets")

        def bucket_iter():
            while True:
                i = claimer.claim()
                if i >= len(chunk_order):
                    return
                yield from by_chunk[chunk_order[i]]
        mine_iter = bucket_iter()
    else:
        owner = assign_chunks(buckets, transport.size)
        mine = [b for b in buckets
                if owner[b.chunk_id.coords] == transport.rank]
        log.info(f"rank {transport.rank}: {len(mine)}/{len(buckets)} buckets")
        mine_iter = iter(mine)

    mesher = OOCMesher(info.grid, prune=cfg.fit_prune,
                       reorder_budget=cfg.mem_reorder)
    mesher.chunk_cells = chunk_cells
    progress = DistributedProgress(transport,
                                   total=sum(b.num_splats for b in buckets),
                                   show=cfg.progress)
    local_splats = 0

    def consume(bucket, result):
        nonlocal local_splats
        mesher.add(block_result_to_input(result, bucket))
        progress.add(bucket.num_splats)
        local_splats += bucket.num_splats

    try:
        consume_threaded(
            stream_blocks(source, info, mine_iter, cfg, devices, readback),
            consume)
    finally:
        progress.close()

    # Balance quality is measured, not assumed: gather actual per-rank
    # loads and record max/mean imbalance on rank 0.
    loads = transport.allgather(local_splats)
    stats = get_registry()
    stats.counter("distributed.rankSplats").add(local_splats)
    if transport.rank == 0:
        mean = max(sum(loads) / max(len(loads), 1), 1e-9)
        imbalance = max(loads) / mean
        stats.variable("distributed.imbalance").add(imbalance)
        log.info(f"rank loads {loads}: imbalance {imbalance:.2f}x (max/mean)")

    if cfg.checkpoint:
        # Per-rank checkpoint (the reference's distributed --checkpoint;
        # resume deals the shards onto whatever rank count it runs with).
        mesher.checkpoint(_rank_checkpoint_path(cfg.checkpoint, transport))
        transport.allgather(None)  # barrier: all ranks checkpointed
        _merge_stats(transport)
        return []

    pruned = global_pruned_roots(mesher, cfg.fit_prune, transport)
    outputs = mesher.write(output, writer_factory=writer_factory,
                           split_size=cfg.output_split_size or 1,
                           pruned_override=pruned)
    mesher.cleanup()
    _merge_stats(transport)
    return outputs


def _rank_checkpoint_path(path: str, transport: Transport) -> str:
    return f"{path}.rank{transport.rank:04d}"


def _merge_stats(transport: Transport) -> None:
    """Statistics merge on rank 0 (doStatistics, mlsgpu-mpi.cpp:302-339)."""
    stats = get_registry()
    all_stats = transport.allgather(stats.to_dict())
    if transport.rank == 0:
        for d in all_stats[1:]:
            other = type(stats)()
            other.load_dict(d)
            stats.merge(other)


def _checkpoint_shards(checkpoint_path: str) -> List[str]:
    import glob
    import re
    # {rank:04d} pads to 4 digits but ranks >= 10000 produce longer
    # suffixes; accept any length and sort numerically by rank so shard
    # order is stable past rank 9999.
    files = [(int(m.group(1)), f) for f in glob.glob(checkpoint_path + ".rank*")
             if (m := re.fullmatch(r".*\.rank(\d{4,})", f))]
    return [f for _, f in sorted(files)]


def resume_distributed(checkpoint_path: str, cfg: ReconstructConfig,
                       output: str, transport: Transport,
                       writer_factory=None) -> List[str]:
    """Write-only distributed run from per-rank checkpoints (--resume with
    --num-processes). The resume rank count may differ from the checkpoint
    rank count (reference runResume, mlsgpu-mpi.cpp:349-372 /
    src/mesher.cpp:876-947): the K checkpoint shards are dealt round-robin
    onto the R current ranks, each rank resumes its shards as independent
    partial meshers (their chunk sets are disjoint by construction), and the
    prune exchange runs over all shards globally."""
    shards = _checkpoint_shards(checkpoint_path)
    if not shards:
        raise FileNotFoundError(
            f"no checkpoint shards matching {checkpoint_path}.rank*")
    mine = [f for i, f in enumerate(shards)
            if i % transport.size == transport.rank]
    log.info(f"rank {transport.rank}: resuming {len(mine)}/{len(shards)} "
             f"checkpoint shards")
    meshers = [OOCMesher.resume(f) for f in mine]
    prune = meshers[0].prune if meshers else 0.0
    pruned = global_pruned_roots_multi(meshers, prune, transport)
    outputs: List[str] = []
    for m, p in zip(meshers, pruned):
        outputs.extend(m.write(output, writer_factory=writer_factory,
                               split_size=cfg.output_split_size or 1,
                               pruned_override=p))
        m.cleanup()
    _merge_stats(transport)
    return outputs
