"""On-card smoke run of the PyTorch/CUDA port (mlsgpu_tpu_torch).

    python3 chip_smoke.py            # all phases, one CUDA device
    python3 chip_smoke.py --through 3  # stop after phase 3 (quick kernel check)
    python3 chip_smoke.py --through 12 # skip the out-of-core phase and 14-16
    python3 chip_smoke.py --only 14    # phases 1-2, 14 and 5 (its digest)

Phases, each printing one line of findings (phase 6 runs last); any failure
raises, exits non-zero and prints no result line:
  1. toolchain and card (torch, CUDA, nvcc, triton, nvidia-smi);
  2. build the kernels from mlsgpu_tpu_torch/csrc with nvcc (sm_90a): ptxas'
     registers and spills, the seam kernels' attributes (local memory,
     registers) and the local memory reserve they cost a process;
  3. at main-path shapes (the densest 256^3-corner bucket of the 2M-splat
     bench cloud), first the binning kernels (csrc/binning.cu: the key
     pass, the radix sort's histogram and pass kernels, the entry gather,
     the tile segments' bounds and gather) against their plain versions,
     every output bit for bit (the sort's keys and permutation also
     against torch.sort(stable=True)), each kernel's call host-paced and
     on the device, the kernel alone (from the kernel events of a profiler
     trace: the bounds and histogram kernels' only time, as they run
     inside the segments' and the sort's calls), its plain version, the
     PyTorch call that computes the same where there is one, its bound
     (binning_bound), the sort whole beside torch.sort, and the stage's
     launches and syncs through the kernels and through the plain versions
     (binning_vs_plain); then the field kernel vs its plain PyTorch
     version on that bucket, sphere
     and plane fits, two boundary factors; NaN-pattern agreement > 0.9995 and
     |kernel - plain| < 1e-3 where both are defined; CUDA-event times of
     the call (the tile order kernels and the field kernel) host-paced and
     on the device alone, of the order kernels alone and of their plain
     version, and of the field kernel alone from a profiler trace; the
     bound on these inputs (kernel_bound) and the call's share of it;
     then torch's CUDA division, reciprocal, square root and scalar
     products against IEEE float32 (numpy), which the seam kernels' fit
     relies on (rounding_probe), and on the same bucket the seam passes
     (csrc/seam_moments.cu: the face kernel, and the skeleton kernel at
     the bucket's skeleton points, each the whole pass in one launch)
     against their plain versions, sphere and plane fits (seam_vs_plain):
     the moments mode's moments and hits value for value and the pass's
     field bit for bit, with the default candidate buffer and with
     SMALL_BUFFER (several windows a row); the pass host-paced and on the
     device alone, the kernel alone (profiler) at both buffers, the plain
     pass at 32 rows (64 points) a chunk, the pass's bound (seam_bound),
     and the launches and host syncs of a pass (at most
     SEAM_PASS_LAUNCHES and none: checked) and of the plain one (a traced
     pass summarized by utils/step_profile); then face passes on two
     streams of the card at once, each field bit for bit the plain pass's
     (face_passes_on_two_streams); then the bucket's block field (binning
     to skeleton, block.block_field) through the codes path's kernels
     (csrc/marching.cu: classify, scan, emit) against the plain
     generate_codes + pack_codes, the image and the counts bit for bit,
     the call host-paced, each kernel alone (profiler), the card's busy
     time, the launches and syncs of a traced call (the three kernels and
     at most one sync: checked) beside the plain stage's, the plain stage
     host-paced, each kernel's bound and the stage's (marching_bound)
     (marching_vs_plain); then the same field through the packed and raw
     readbacks' kernels (classify and scan, csrc/marching.cu's mesh
     emission, csrc/mesh.cu's weld sort over the keys' top digits, group
     kernel and pack) against the plain generate_mesh -> weld ->
     pack_readback: the unwelded and welded
     arrays, the counts, raw's triangles and the image bit for bit (also
     on fields of dense tiles at 256^3 and 301^3, every cell of a tile
     occupied with 13 vertices: dense_tile_field), the
     packed stage host-paced, each kernel alone (profiler), the card's
     busy time, the launches and syncs of a traced stage (the kernels and
     at most two syncs: checked) beside the plain chain's, the plain chain
     host-paced, torch.unique and torch.sort of the compact keys, each
     kernel's bound (the compact keys at their sort width, and as int64
     keys), the weld whole's and the stage's (mesh_bound)
     (mesh_vs_plain);
  4. the seam contract on the card, through the seam kernels: shared-face
     and T-junction corners of adjacent blocks bitwise equal, also where a
     face patch straddles the blocks' in-plane edge; both seam passes
     against their plain versions on the three T-junction blocks, the
     fields bit for bit;
  5. end to end through `mlsgpu_tpu_torch.cli.main` on the 2M-splat bench
     cloud (tools/cloud.py make_cloud) written as a PLY, `--readback codes`
     (the host rebuild; `auto` is packed on a card): manifold output,
     kernel launches >= blocks; then `--readback packed` and `raw` on it
     (every block through the mesh kernels): manifold, the codes run's
     vertex, triangle, boundary-edge and component counts, and whether
     each mesh is the codes run's bit for bit;
  7. on the 250k-splat bench cloud, `--readback codes`, `packed` and `raw`:
     packed and raw give the codes run's vertex, triangle and boundary-edge
     counts, manifold; the seconds of all three modes;
  8. `--statistics-device` on that cloud (codes, then packed): the mesh
     bitwise phase 7's, and every `device.<stage>.time`, its mean and each
     block's (stage_samples);
  9. on the densest 512^3-corner dispatch (`--levels 7`, 64^3 tiles, 7
     levels): the block's field (one launch of each binning, field and
     seam kernel, none of the marching or mesh kernels) and the marching
     and mesh kernels against their plain versions on it as in phase 3
     (the tiled rule's candidate tiles in the counts; 31-bit weld keys),
     then the binning kernels as in phase
     3, the kernel against its plain version as in phase 3 (sphere fit,
     the run's boundary factor), the seam kernels as in phase 3, then
     tiled against dense classification of the block's field: the codes
     images bitwise equal; all four times;
 10. `DeviceScaleBias(scale=2, bias)` through `reconstruct(device_filter=)`
     on a small cloud: each block's filtered vertices equal its unfiltered
     ones transformed on the host within 1e-5 of a cell; manifold;
 11. chunked output: the 2M cloud through `cli.main --split-size 16M`, then
     tools/verify_chunks: a sample of chunks manifold, every cut plane that
     carries surface compared (checked > 0), no near-twin crack
     (TWIN_PPM_MAX = 0); per-chunk vertex and triangle counts;
 12. two ranks on the one card: two processes of the CLI with
     `--coordinator 127.0.0.1:<port> --num-processes 2 --device cuda
     --split-size 16M` (dynamic scatter): both exit 0, their files are
     disjoint and together are phase 11's chunks, the same counts and the
     same vertex and triangle arrays bit for bit (so phase 11's
     verification holds for them), every rank launched the kernel at least
     once per block it ran and imported no jax; the seconds of one cold
     process and of the two ranks; then a pair on the 250k cloud with rank
     1 killed after the blob pass (MLSGPU_TEST_DIE_RANK=1,
     MLSGPU_HB_TIMEOUT=10): rank 1 exits 7 and rank 0 exits non-zero within
     DEAD_RANK_BOUND_S;
 13. out of core (run right after phase 4, while the process is still
     small, so that its peak RSS is its own): tools/bench_ooc in process at
     OOC_SPLATS splats with budgets that make the blob store and the mesher
     spill: return code and RSS, the spill counters non-zero, the mem.*
     peaks within their budgets, its chunks verified as in phase 11;
     Msplats/s and peak RSS;
 14. queues and cards through the CLI on the 2M cloud, each run as users
     run it: `python -m mlsgpu_tpu_torch --statistics` as a process of its
     own (tools/bench_queues.run_cli), its statistics read back from its
     output: on `--device cuda:0` `--device-threads 1` (no worker
     process), then `2` and `4` (that many worker processes on the one
     card, forked from one worker server: pipeline/worker_start.py) and,
     with more than one card visible, `--device cuda --num-devices 0`
     (every card, a worker process each), all with `--readback codes`:
     each mesh's digest is phase 5's
     (the vertex and triangle arrays phase 5 checked manifold), 50 kernel
     launches of the field, face and binning kernels (counted in the
     worker processes and carried to the run's `mls.launches`,
     `seam.faceLaunches`, `binning.keyLaunches`, ...), every worker's
     block counter above 0, one process
     per worker, and no process of the run's session alive once it has
     exited; for each, the wall and the run's phases, the worker start
     split into its stages (the server's interpreter, torch and the step's
     modules, each worker's fork, CUDA context and kernel library) beside
     workers.readyWait, and the parent's host time per block by stage
     (loader read and conversion, shared-memory copy, proxy wait, a
     worker's wait for a slot and for a block, decode, mesher), what paces
     pass 1 (the mesher thread's busy share, the producer's wait share,
     the workers' slot wait) and the decode stage's threads (one per
     worker, at most half the cores: checked), beside phase 12's
     two-process ratio; then one and two queues (and every card) on a
     BIG_SPLATS cloud, each mesh the one-queue run's; the device memory of
     an idle worker process (its CUDA context and the kernel library),
     from torch.cuda.mem_get_info and nvidia-smi, against
     workers.WORKER_CONTEXT_BYTES; and `--num-devices` of one more card
     than is visible exits non-zero with the option error;
 15. parallel/sharded.py on the card: two seam-adjacent blocks through
     `data_parallel_block_step` over [cuda:0, cuda:0] (and over two cards
     where there are two): counts and codes image bitwise the block step's
     alone on the default stream; their fields, computed at once on two
     streams, bitwise equal on the shared face and bitwise the
     one-stream fields; the kernel launched on a non-default stream while
     the default stream sleeps, held against its plain version (phase 3's
     bar) at the densest 256^3 bucket; `distributed_cell_bounds` on the 2M
     cloud split over the mesh against numpy (rtol 1e-6, equal count);
 16. the measuring tools at their default size, a few repetitions:
     tools/bench_d2h, bench_micro and bench_micro2, their lines printed;
     bench_micro's face pass at 32 and 256 rows per chunk beside the same
     pass with its sums over each row's whole list (the per-row tree it
     had before its per-corner sort, kept in the tool for timing only);
  6. neither jax, the JAX package `mlsgpu_tpu` nor the repo-root bench.py in
     sys.modules (checked after every phase); at the end, no process that
     this one started is left.
Kernel launches (the field, face, skeleton, six binning, three marching
and five mesh kernels') are counted per main-path run (every counter set
to 0 just before it and read just after; the comparisons of phases 3, 4
and 9 excluded); each run must launch the field, face and binning
kernels once a block, the skeleton kernel where its blocks have skeleton
points, the classify and scan kernels once a block, and, by its readback
mode, the emit kernel once a codes block with an occupied cell, none in a
packed or raw run, and the mesh emission, the weld's kernels and the pack
kernel once a packed or raw block with vertices, none in a codes run
(check_launches); a kernel record's
`launches` is the sum over the runs in this process (phase 12's ranks
count their own and print them); its `max_abs_err` is the largest of
phases 3 (and 4) and 9; its `ms` is the call's (for a seam kernel, the
pass's; for a marching kernel, the kernel alone) host-paced time at the
densest 256^3 bucket, `device_ms` on the device alone (and `kernel_ms` a
seam, binning, marching or mesh kernel alone).
The second-last lines are the kernel JSON record and the card's name and
power limit; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from mlsgpu_tpu_torch import cli  # noqa: E402
from mlsgpu_tpu_torch.config import (ReconstructConfig,  # noqa: E402
                                     parse_capacity)
from mlsgpu_tpu_torch.device import set_precision  # noqa: E402
from mlsgpu_tpu_torch.io import ply  # noqa: E402
from mlsgpu_tpu_torch.io.splat_set import SequenceSource  # noqa: E402
from mlsgpu_tpu_torch.ops import (binning, binning_cuda,  # noqa: E402
                                  block, kernel_gate, marching,
                                  marching_cuda, mesh_cuda, mls, mls_cuda,
                                  seam_cuda, weld)
from mlsgpu_tpu_torch.ops import launches as launch_counts  # noqa: E402
from mlsgpu_tpu_torch.pipeline import bucket as bucket_mod  # noqa: E402
from mlsgpu_tpu_torch.pipeline import mesh_filter  # noqa: E402
from mlsgpu_tpu_torch.parallel import sharded  # noqa: E402
from mlsgpu_tpu_torch.pipeline import reconstruct as port_rec  # noqa: E402
from mlsgpu_tpu_torch.pipeline import resources  # noqa: E402
from mlsgpu_tpu_torch.pipeline import streamer  # noqa: E402
from mlsgpu_tpu_torch.pipeline.streamer import load_bucket  # noqa: E402
from mlsgpu_tpu_torch.pipeline import workers as workers_mod  # noqa: E402
from mlsgpu_tpu_torch.tools import (bench_d2h, bench_micro,  # noqa: E402
                                    bench_micro2, bench_ooc, bench_queues,
                                    cloud, verify_chunks)
from mlsgpu_tpu_torch.tools.bench_binning import (  # noqa: E402
    event_ms, kernel_event_ms, kernel_ms, segment_queries, trace_events)
from mlsgpu_tpu_torch.tools.bench_queues import bench_args  # noqa: E402
from mlsgpu_tpu_torch.utils import misc, step_profile  # noqa: E402
from mlsgpu_tpu_torch.utils.manifold import check_manifold  # noqa: E402
from mlsgpu_tpu_torch.utils.statistics import (Variable,  # noqa: E402
                                                get_registry)

N_SPLATS = 2_000_000
N_SMALL = 250_000    # the cloud of phases 7 and 8 and of the dead-rank pair
# Phase 14's second cloud: long enough a run (~3x the 2M one) for worker
# processes to pay back their start (~9 s each on the H100's host)
BIG_SPLATS = 6_000_000
LEVELS, SUB = 6, 3   # the bench configuration: 256^3-corner dispatches
# Phases 11 and 12: chunks of 255 cells per axis (one block), ~25 files. At
# 64M (510 cells) the 2M cloud falls into 4 files, one with two thirds of
# the mesh: the chunk grid is anchored where the buckets are.
SPLIT_SIZE = "16M"
# 6M: the depth of this phase was cut from 10M when phases 14-16 came, to
# keep the script near half its time limit on a slow host; the blob store
# and the mesher still spill under these budgets.
OOC_SPLATS = 6_000_000
# Near-twin cracks (the two copies of one cut-plane vertex a few ulps apart)
# tolerated per million on-plane vertices compared: none. The face pass
# sums each corner over exactly the splats that reach it, in stream order
# (ops/mls.py), so every block computes a shared corner bit for bit; the
# JAX package, whose sums run over a block-dependent candidate list, still
# shows them (tests/test_torch_tools.py). Any other mismatch fails too.
TWIN_PPM_MAX = 0.0
DEAD_RANK_BOUND_S = 120
TILED_LEVELS = 7     # 512^3-corner dispatches: tiled classification
GAMMAS = (1.0, 0.5)  # --fit-boundary-limit values; boundary factor = 1 - g^2
REPS = 7
# The H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): FP32
# outside the tensor cores, and the HBM3 rate.
FP32_PEAK = 67e12      # FLOP/s
HBM_RATE = 3.35e12     # bytes/s
SLEEP_CYCLES = 4_000_000  # ~2 ms of the card's clock: longer than any
#                           host enqueue of one timed kernel call
# The seam kernels' shrunken candidate buffer (their default is
# seam_cuda.max_buffer()): most occupied face rows of the densest buckets
# then take several identity windows, so the kernels' path for rows that
# overflow the buffer runs at main-path shapes too.
SMALL_BUFFER = 16
# The most launches a traced seam pass may issue (the kernel and, for the
# skeleton pass, its points' conversion), and it may not synchronise.
SEAM_PASS_LAUNCHES = 3
# FP32 operations of the seam kernels' fit a corner (csrc/seam_moments.cu
# fit: the re-centring 26 with |c|^2; sphere_fit 85; plane_fit 45).
FIT_OPS = {"sphere": 111, "plane": 71}
# The kernels of the main path, by the names their wrappers count them
# under (ops/launches.py), in the order of the kernel record.
KERNELS = tuple(launch_counts.KERNELS)
# The binning kernels: (record name, kernel functions, what it replaces).
# The segments' row times both of their kernels (one C call launches the
# bounds kernel and the gather); the bounds kernel also has a row alone.
# The sort's C call launches its histogram kernel and a pass kernel a
# digit: the histogram has a row alone, the passes' row times them all.
BINNING_KERNELS = (
    ("bin_keys", ("bin_keys_kernel",), "mlsgpu_tpu/ops/binning.py:76"),
    ("bin_sort_histogram", ("bin_sort_histogram_kernel",),
     "mlsgpu_tpu/ops/binning.py:151"),
    ("bin_sort_pass", ("bin_sort_pass_kernel",),
     "mlsgpu_tpu/ops/binning.py:151"),
    ("bin_entries", ("bin_entries_kernel",), "mlsgpu_tpu/ops/binning.py:76"),
    ("tile_bounds", ("tile_bounds_kernel",), "mlsgpu_tpu/ops/binning.py:161"),
    ("tile_segments", ("tile_bounds_kernel", "tile_segments_kernel"),
     "mlsgpu_tpu/ops/binning.py:161"))
# The codes path's kernels: (record name, kernel function, what it
# replaces: the JAX package's dense classification (its tiled one is
# :202), generate(emit="codes")'s counts and emission, and _pack_codes).
MARCHING_KERNELS = (
    ("march_classify", "march_classify_kernel",
     "mlsgpu_tpu/ops/marching.py:119"),
    ("march_scan", "march_scan_kernel", "mlsgpu_tpu/ops/marching.py:302"),
    ("march_emit", "march_emit_kernel", "mlsgpu_tpu/ops/block.py:322"))
MARCHING = tuple(name for name, _, _ in MARCHING_KERNELS)
# The packed and raw readbacks' kernels after classify and scan: (record
# name, kernel function, what it replaces: generate(emit="mesh")'s
# emission, the weld's sort over the keys' top digits and its group
# kernel, _pack_readback).
MESH_KERNELS = (
    ("march_emit_mesh", "march_emit_mesh_kernel",
     "mlsgpu_tpu/ops/marching.py:302"),
    ("weld_sort_histogram", "weld_sort_histogram_kernel",
     "mlsgpu_tpu/ops/weld.py:34"),
    ("weld_sort_pass", "weld_sort_pass_kernel", "mlsgpu_tpu/ops/weld.py:34"),
    ("weld_group", "weld_group_kernel", "mlsgpu_tpu/ops/weld.py:34"),
    ("pack_readback", "pack_readback_kernel",
     "mlsgpu_tpu/ops/block.py:205"))
MESH = tuple(name for name, _, _ in MESH_KERNELS)


def reset_launches() -> None:
    """Every kernel's launch count to 0, just before a main-path run."""
    launch_counts.reset()


def read_launches() -> dict:
    """Every kernel's launches since reset_launches, by KERNELS name."""
    return launch_counts.counts()


def check_launches(name: str, got: dict, blocks: int,
                   skeleton_blocks: int, codes_blocks: int,
                   mesh_blocks: int = 0) -> dict:
    """A main-path run of `blocks` blocks, `skeleton_blocks` of them with
    skeleton points, `codes_blocks` read back in codes mode and
    `mesh_blocks` packed or raw, went through its kernels: the field, face
    and binning kernels at least once per block (and at all), the skeleton
    kernel at least once per block with skeleton points, the classify and
    scan kernels at least once per codes or mesh block; the emit kernel at
    least once and at most once per codes block (not for a block without
    an occupied cell); the mesh emission, the weld's histogram and group
    kernel and the pack kernel at least once and at most once per mesh
    block, as many of each (a block with vertices runs them all, the pack
    kernel for the image or raw's triangles), and a pass kernel or more
    per weld; a run without codes blocks launches no emit kernel, one
    without mesh blocks none of the mesh kernels."""
    need = dict.fromkeys(KERNELS, max(blocks, 1))
    need["seam_skeleton"] = skeleton_blocks
    need.update(march_classify=codes_blocks + mesh_blocks,
                march_scan=codes_blocks + mesh_blocks,
                march_emit=min(codes_blocks, 1),
                **dict.fromkeys(MESH, min(mesh_blocks, 1)))
    welds = got["weld_group"]
    if any(got[k] < need[k] for k in KERNELS) or \
            got["march_emit"] > codes_blocks or \
            got["march_emit_mesh"] > mesh_blocks or \
            any(got[k] != welds for k in ("march_emit_mesh",
                                          "weld_sort_histogram",
                                          "pack_readback")) or \
            got["weld_sort_pass"] < welds or \
            (codes_blocks == 0 and got["march_emit"]) or \
            (mesh_blocks == 0 and any(got[k] for k in MESH)):
        raise AssertionError(f"{name}: launches {got} for {blocks} blocks, "
                             f"{codes_blocks} in codes mode, {mesh_blocks} "
                             "packed or raw")
    return got


def codes_blocks(reg) -> int:
    """The blocks a run read back in codes mode (its statistics)."""
    return reg.counter("readback.mode.codes").get()


def mesh_blocks(reg) -> int:
    """The blocks a run read back packed or raw (its statistics)."""
    return (reg.counter("readback.mode.packed").get()
            + reg.counter("readback.mode.raw").get())


def sphere_cloud(center, radius, n, splat_radius, rng) -> np.ndarray:
    """Splats on an analytic sphere with outward normals (the fixture of
    tests/oracle.py, which is not importable as `tests` on every machine)."""
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    out = np.empty((n, 8), np.float32)
    out[:, 0:3] = np.asarray(center, np.float64) + radius * v
    out[:, 3] = splat_radius
    out[:, 4:7] = v
    out[:, 7] = 1.0 / splat_radius ** 2
    return out


T0 = time.monotonic()


def phase(n: int, msg: str) -> None:
    print(f"[phase {n} @{time.monotonic() - T0:.1f}s] {msg}", flush=True)


FORBIDDEN = ("jax", "jaxlib", "mlsgpu_tpu", "bench")


def check_isolated(after: str) -> None:
    """Neither jax nor the JAX package may have been imported."""
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in FORBIDDEN)
    if bad:
        raise AssertionError(f"imported after {after}: {bad[:5]}")


def _cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace")
    except OSError:
        return "?"


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int = REPS, device_only: bool = False) -> float:
    """Median CUDA-event time of fn(), host-paced or (device_only) with
    the host's enqueue hidden: tools/bench_binning.event_ms."""
    return event_ms(fn, reps, device_only)


def phase1_toolchain() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no card")
    nvcc = mls_cuda.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, check=True).stdout.strip()
    try:
        import triton
        triton_ver = triton.__version__
    except ImportError as e:
        triton_ver = f"not importable ({e})"
    info = {"torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": nvcc_ver.splitlines()[-1], "triton": triton_ver,
            "device": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(),
            "nvidia_smi": nvidia_smi(),
            "python": sys.version.split()[0]}
    phase(1, f"toolchain {json.dumps(info)}")
    return info


def phase2_build() -> None:
    t0 = time.monotonic()
    mls_cuda.build(force=True)
    mls_cuda.load()
    ptxas = [ln.strip() for ln in mls_cuda.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    dev = torch.device("cuda", 0)
    attrs = seam_cuda.kernel_attributes(dev)
    phase(2, f"built {os.path.relpath(mls_cuda.library_path(), ROOT)} in "
             f"{time.monotonic() - t0:.2f}s (nvcc {mls_cuda.build_seconds:.2f}s); "
             f"ptxas: {' | '.join(ptxas)}; seam kernels {json.dumps(attrs)}, "
             f"local memory reserve {resources.seam_local_reserve(dev)} "
             f"bytes a process")


def rounding_probe(dev) -> dict:
    """torch's CUDA ops that the plain fit uses, against IEEE float32
    (numpy on the host): 1.0 / x (reciprocal), x / y, sqrt, the sphere
    fit's (4 * FLT_EPSILON) * hits * |x| and a float scalar times a
    tensor. The seam kernels' fit is written with correctly rounded
    operations (__fdiv_rn, __fsqrt_rn, ...); it equals the plain fit only
    if these agree. Returns the mismatches of each (all 0, or it raises)."""
    rng = np.random.default_rng(5)
    f32 = np.float32
    n = 1 << 20
    x = (rng.normal(size=n) * np.exp2(rng.integers(-30, 30, n))).astype(f32)
    y = (rng.normal(size=n) * np.exp2(rng.integers(-30, 30, n))).astype(f32)
    h = rng.integers(0, 200, n).astype(np.int32)
    tx, ty, th = (torch.as_tensor(v, device=dev) for v in (x, y, h))
    with np.errstate(all="ignore"):
        pairs = {
            "reciprocal": (1.0 / tx, f32(1.0) / x),
            "div": (tx / ty, x / y),
            "sqrt": (torch.sqrt(torch.abs(tx)), np.sqrt(np.abs(x))),
            "guard": ((4 * 1.1920929e-07) * th * torch.abs(ty),
                      (f32(4 * 1.1920929e-07) * h.astype(f32)) * np.abs(y)),
            "scalar_mul": (0.75 * tx, f32(0.75) * x)}
    out = {}
    for name, (got, ref) in pairs.items():
        got = got.cpu().numpy()
        same = (got.view(np.uint32) == ref.view(np.uint32)) | (
            np.isnan(got) & np.isnan(ref))
        out[name] = int((~same).sum())
    phase(3, f"torch's CUDA rounding against IEEE float32 on {n} values "
             f"each (mismatches): {json.dumps(out)}")
    if any(out.values()):
        raise AssertionError(f"torch's CUDA ops are not IEEE-rounded: {out}")
    return out


def bench_setup():
    splats, sr = cloud.make_cloud(N_SPLATS)
    cfg = cloud.bench_config(sr, LEVELS)
    return splats, cfg.fit_grid, cfg


def kernel_bound(binned, starts, lens, origin, tpa) -> dict:
    """The least time the card could take for the field of these inputs:
    the larger of its FP32 operations over the FP32 peak and its bytes over
    the memory rate (entries and segments read once, the field written
    once). Operations, counted on these inputs by mls.candidate_work: 13
    per tile candidate (re-centring, |x|^2, n.x), 21 per candidate and
    8x4x4 corner box (the box test), 9 per corner-candidate pair within
    reach of its box (the distance and cutoff; the pairs out of reach need
    none) and 21 more per pair within the radius (weight and sums)."""
    pairs, reached, hits = mls.candidate_work(binned.entry_data, starts, lens,
                                              origin, tpa)
    flops = 13 * pairs // 512 + 21 * pairs // 128 + 9 * reached + 21 * hits
    nbytes = (binned.entry_data.numel() * 4 + 2 * starts.numel() * 4
              + (8 * tpa) ** 3 * 4)
    t_ops, t_bytes = flops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return {"pairs": pairs, "reached": reached, "hits": hits, "flops": flops,
            "bytes": nbytes, "ops_ms": t_ops, "bytes_ms": t_bytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def kernel_vs_plain(n, binned, starts, lens, origin, tpa, fit, bf,
                    reps=REPS, bound=None) -> dict:
    """The kernel against its plain version on one bucket's binned entries:
    kernel_gate's bar (NaN agreement > 0.9995, |d| < 1e-3), both CUDA-event
    times and the kernel's share of its bound (computed here unless given).
    Its launches are comparisons: not counted by callers, who reset the
    counter after it."""
    args = (binned.entry_data, starts, lens, origin, tpa, fit, bf)
    got = mls_cuda.launch(*args)
    ref = mls.eval_field(*args)
    torch.cuda.synchronize()
    summary = kernel_gate.compare_fields(ref, got)
    del got, ref
    kernel_gate.check(summary, min_defined=10_000)
    call = lambda: mls_cuda.launch(*args)  # noqa: E731
    host_paced_ms = cuda_ms(call, reps)
    device_ms = cuda_ms(call, reps, device_only=True)
    alone_ms = kernel_ms(call, "mls_field_kernel", reps)
    order_ms = cuda_ms(lambda: mls_cuda.tile_order(lens), reps,
                       device_only=True)
    # the order's plain version (sum, argsort, count): what the two order
    # kernels replace
    argsort_ms = cuda_ms(lambda: mls_cuda.tile_order_plain(lens), reps,
                         device_only=True)
    p_ms = cuda_ms(lambda: mls.eval_field(*args), reps)
    bound = bound or kernel_bound(binned, starts, lens, origin, tpa)
    share = bound["bound_ms"] / device_ms
    alone = "not measured" if alone_ms is None else f"{alone_ms:.4f} ms"
    phase(n, f"{fit} bf={bf:g} at {tpa}^3 tiles, {starts.shape[1]} levels: "
             f"agreement {summary['pattern_agreement']:.6f}, max|d| "
             f"{summary['max_abs_err']:.3e}, defined "
             f"{summary['defined_corners']}; call {host_paced_ms:.4f} ms "
             f"host-paced, {device_ms:.4f} ms on the device, of which the "
             f"tile order kernels {order_ms:.4f} ms (their plain version "
             f"{argsort_ms:.4f} ms); field kernel alone {alone} (profiler); "
             f"plain {p_ms:.3f} ms; bound {bound['bound_ms']:.4f} ms "
             f"({bound['bound_by']}: {bound['flops']} operations, "
             f"{bound['ops_ms']:.4f} ms, from {bound['pairs']} pairs, "
             f"{bound['reached']} within reach, {bound['hits']} hits; "
             f"{bound['bytes']} bytes, {bound['bytes_ms']:.4f} ms); the "
             f"device time at {100 * share:.1f}% of it, the host-paced "
             f"{100 * bound['bound_ms'] / host_paced_ms:.1f}%")
    return dict(fit=fit, boundary_factor=bf, host_paced_ms=host_paced_ms,
                device_ms=device_ms, kernel_alone_ms=alone_ms,
                order_ms=order_ms, order_plain_ms=argsort_ms,
                plain_ms=p_ms, share_of_bound=share, bound=bound, **summary)


def pass_profile(fn, reps: int = 3) -> dict:
    """Kernel launches and host syncs of one call of fn (means over
    `reps`), and its wall and device-busy ms, from a torch.profiler trace
    of the calls, each summarized as a block step (utils/step_profile.py:
    a sync is a cuda*Synchronize or a synchronous cudaMemcpy)."""
    import torch.profiler as tp
    fn()
    torch.cuda.synchronize()
    with tp.profile(activities=[tp.ProfilerActivity.CPU,
                                tp.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            with tp.record_function(step_profile.STEP):
                fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="chip_smoke.trace.") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            summary = step_profile.summarize(json.load(f))
    return {k: summary.get(k) for k in ("launches", "sync_calls", "wall_ms",
                                        "device_busy_ms")}


def _equal_values(got, ref, label) -> None:
    """got == ref value for value (signed zeros equal) or both NaN."""
    same = (got == ref) | (torch.isnan(got) & torch.isnan(ref))
    if got.shape != ref.shape or not bool(same.all()):
        raise AssertionError(f"{label}: {int((~same).sum())} of "
                             f"{same.numel()} values differ")


def _same_bits(got, ref, label) -> None:
    """NaN where ref is NaN, every other value the same bits (the sign of
    a zero too)."""
    nan = torch.isnan(ref)
    same = torch.where(nan, torch.isnan(got),
                       got.view(torch.int32) == ref.view(torch.int32))
    if got.shape != ref.shape or not bool(same.all()):
        raise AssertionError(f"{label}: {int((~same).sum())} of "
                             f"{same.numel()} values differ in their bits")


def seam_bound(work, per_listed: int, corners: int, fit: str) -> dict:
    """The least time the card could take for a seam pass (the face or
    skeleton kernel: moments, fit and write) on these inputs: the larger
    of its FP32 operations over the FP32 peak and its bytes over the
    memory rate. `work` = (listed, kept, written, fitted) from
    mls.face_work / skeleton_work; bytes: each listed candidate's filter
    columns and identity (24) read once, each kept candidate's row (32)
    read once, each field corner the pass writes (4) written once;
    operations: `per_listed` for each listed candidate's filter (18 for a
    face row's rectangle test, 10 for a point's), 13 for each kept
    candidate's frame and features, 45 for each (corner, kept candidate)
    pair of `corners` a row (distance 9, weight 5, terms 8, the tree's
    adds 9 amortised, the rest the hit count and selects), and FIT_OPS
    for each written corner with enough hits to fit (the rest are NaN
    without a fit)."""
    listed, kept, written, fitted = work
    flops = (per_listed * listed + 13 * kept + 45 * corners * kept
             + FIT_OPS[fit] * fitted)
    nbytes = 24 * listed + 32 * kept + 4 * written
    t_ops, t_bytes = flops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return {"listed": listed, "kept": kept, "written": written,
            "fitted": fitted, "flops": flops, "bytes": nbytes,
            "ops_ms": t_ops, "bytes_ms": t_bytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def seam_vs_plain(n, binned, starts, lens, origin, region, points, tpa, fit,
                  bf, field, reps=REPS, timed=True) -> list:
    """The face pass, and the skeleton pass where `points` (the block's
    skeleton points) are given, through their kernels against their plain
    versions on one block's binned entries, `field` the field kernel's:
    the moments mode's moments and hits equal value for value and the
    pass's field bit for bit, with the default buffer and with
    SMALL_BUFFER. With `timed`: the pass (one kernel launch) host-paced and
    on the device alone, the kernel alone (profiler) at both buffers, the
    plain pass at 32 rows (64 points) a chunk, the pass's bound on these
    inputs, and the launches and host syncs of a pass (checked: at most
    SEAM_PASS_LAUNCHES, none) and of the plain one. Its launches are
    comparisons: not counted by callers, who reset the counters after it.
    Returns a row per kernel."""
    e, v, dev = binned.entry_data, binned.entry_vals, field.device
    rows_np = mls.face_rows(origin, region, tpa)
    rows = torch.as_tensor(rows_np, device=dev)
    plain_args = (e, v, starts, lens)
    passes = [("seam_face", "face", rows_np.shape[0], 64,
               lambda f, buf: seam_cuda.canonical_face_field(
                   f, e, v, starts, lens, origin, region, tpa, fit, bf,
                   buffer=buf),
               lambda f: mls.canonical_face_field(
                   f, e, v, starts, lens, origin, region, tpa, fit, bf),
               lambda buf: seam_cuda.face_moments(
                   *plain_args, origin, region, tpa, buf),
               lambda: mls.face_moments(*plain_args, rows),
               lambda: mls.face_work(*plain_args, rows, origin, region,
                                     tpa), 18)]
    if points is not None and points.shape[0]:
        pts, _, tid, inside = mls.skeleton_points(points, origin, tpa,
                                                  field.shape[0])
        passes.append(
            ("seam_skeleton", "skeleton", pts.shape[0], 1,
             lambda f, buf: seam_cuda.skeleton_point_field(
                 f, e, v, starts, lens, origin, points, tpa, fit, bf,
                 buffer=buf),
             lambda f: mls.skeleton_point_field(
                 f, e, v, starts, lens, origin, points, tpa, fit, bf),
             lambda buf: seam_cuda.skeleton_moments(
                 *plain_args, origin, points, tpa, buf),
             lambda: mls.skeleton_moments(*plain_args, pts, tid, inside),
             lambda: mls.skeleton_work(*plain_args, pts, tid, inside), 10))
    out = []
    for name, kind, items, corners, run, plain, kmom, pmom, work, per in \
            passes:
        ref_m, ref_h = pmom()
        ref_f = plain(field.clone())
        for buf in (None, SMALL_BUFFER):
            m, h = kmom(buf)
            _equal_values(m, ref_m, f"{kind} moments, buffer {buf}")
            if not torch.equal(h, ref_h):
                raise AssertionError(f"{kind} hits differ, buffer {buf}")
            got = run(field.clone(), buf)
            _same_bits(got, ref_f, f"{kind} pass field, buffer {buf}")
        summary = kernel_gate.compare_fields(ref_f, got)
        del m, h, got
        row = {"name": name, "fit": fit, "boundary_factor": bf,
               "items": items, "defined": summary["defined_corners"],
               "max_abs_err": summary["max_abs_err"],
               "bitwise_the_plain_pass": True}
        if timed:
            scratch = field.clone()
            call = lambda: run(scratch, None)  # noqa: E731
            row["host_paced_ms"] = cuda_ms(call, reps)
            row["device_ms"] = cuda_ms(call, reps, device_only=True)
            row["kernel_ms"] = kernel_ms(call, f"seam_{kind}_kernel", reps)
            row["kernel_small_buffer_ms"] = kernel_ms(
                lambda: run(scratch, SMALL_BUFFER), f"seam_{kind}_kernel",
                reps)
            row["plain_ms"] = cuda_ms(lambda: plain(scratch), reps)
            row["pass"] = pass_profile(call)
            row["plain_pass"] = pass_profile(lambda: plain(scratch), 1)
            row["bound"] = seam_bound(work(), per, corners, fit)
            del scratch
            k_ms = row["kernel_ms"]
            row["share_of_bound"] = (None if k_ms is None else
                                     row["bound"]["bound_ms"] / k_ms)
            traced = row["pass"]
            if (traced["launches"] > SEAM_PASS_LAUNCHES
                    or traced["sync_calls"] != 0):
                raise AssertionError(f"{kind} pass: {traced['launches']} "
                                     f"launches, {traced['sync_calls']} "
                                     "syncs a pass")
        phase(n, f"{kind} pass vs plain, {fit} bf={bf:g}, {items} "
                 f"{'rows' if corners > 1 else 'points'}: moments and hits "
                 f"equal value for value, the pass's field bit for bit, at "
                 f"buffers {seam_cuda.max_buffer()} and {SMALL_BUFFER}; "
                 f"{json.dumps(row)}")
        out.append(row)
    return out


def face_passes_on_two_streams(n, binned, starts, lens, origin, region, tpa,
                               field, rounds=4, timeout=60.0) -> dict:
    """Face passes on two streams of one card at once, `rounds` each,
    interleaved: both finish (events polled until `timeout`: no CTA of a
    pass waits on another, so passes sharing the card in any proportion
    make progress) and every field is the plain pass's bit for bit. Its
    launches are comparisons, as seam_vs_plain's."""
    dev = field.device
    face = (binned.entry_data, binned.entry_vals, starts, lens, origin,
            region, tpa, "sphere", 0.0)
    ref = mls.canonical_face_field(field.clone(), *face)
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    outs = [[field.clone() for _ in range(rounds)] for _ in streams]
    torch.cuda.synchronize(dev)
    t0 = time.monotonic()
    for i in range(rounds):
        for st, fs in zip(streams, outs):
            with torch.cuda.stream(st):
                seam_cuda.canonical_face_field(fs[i], *face)
    done = [torch.cuda.Event() for _ in streams]
    for ev, st in zip(done, streams):
        ev.record(st)
    while not all(ev.query() for ev in done):
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"face passes on two streams did not "
                                 f"finish in {timeout} s")
        time.sleep(0.001)
    seconds = time.monotonic() - t0
    for fs in outs:
        for f in fs:
            _same_bits(f, ref, "face pass on two streams")
    out = {"streams": 2, "rounds": rounds, "seconds": seconds,
           "bitwise_the_plain_pass": True}
    phase(n, f"face passes on two streams of one card at once, {tpa}^3 "
             f"tiles: {json.dumps(out)}")
    return out


def segment_key_sectors(sorted_keys, starts, lens) -> int:
    """The 32-byte sectors of the sorted keys that tile_segments must read
    on these inputs: a lower bound at position p is known from the keys at
    p - 1 and p alone, so for each distinct segment boundary (a start or an
    end) the sectors of those two keys, counted once however many (tile,
    level) pairs share them."""
    m = sorted_keys.numel()
    if m == 0:
        return 0
    ends = torch.cat([starts.reshape(-1), (starts + lens).reshape(-1)])
    ends = ends.long().unique()
    pos = torch.cat([ends - 1, ends]).clamp(0, m - 1)
    return int(torch.unique(pos // 4).numel())   # 4 int64 keys a sector


def sort_passes_floor(n: int, passes: int, in_bytes: int, key_bytes: int,
                      out_bytes: int) -> dict:
    """The radix sort's passes' floor on these inputs: every pass reads and
    writes every key and index at its width over the memory rate. The
    first pass reads `in_bytes` a key (the input keys; the index is the
    key's place), a pass between reads and writes a `key_bytes` key and an
    int32 index, the last writes `out_bytes` a key. Beside the sort's
    bound, which counts its input and output once, it is what the passes
    must move as they are built."""
    between = key_bytes + 4
    nbytes = sum(n * ((in_bytes if p == 0 else between)
                      + (out_bytes if p == passes - 1 else between))
                 for p in range(passes))
    return {"bytes": nbytes, "ms": nbytes / HBM_RATE * 1e3}


def binning_bound(name: str, n: int, tiles: int, levels: int,
                  key_sectors: int = 0, nodes: int = 0,
                  passes: int = 0) -> dict:
    """The least time the card could take for a binning kernel's work on
    these inputs: the larger of its bytes over the memory rate (each input
    read once, each output written once) and its FP32 operations over the
    FP32 peak. Keys (n splats): x, y, z, r and the valid byte in, 8 int64
    keys out; 56 FP32 operations (px -+ r 6, r^2 c 2, the 6 slab terms'
    clamp, difference and square 24, the 8 corners' two adds and compare
    24). The sort ("bin_sort", and its passes' row "bin_sort_pass", which
    together make the sort from the histogram): the 8n int64 keys in, the
    sorted int64 keys and the int64 permutation out, 24 bytes an entry; its
    histogram kernel: the keys in, `passes` x 256 int32 counts out; no
    FP32 operation. Entries (8n): the permutation in and each splat row
    once, the row index and the entry row out; one reciprocal and one
    product an entry.
    Segments (both of their kernels): the `key_sectors` 32-byte sectors of
    the sorted keys that hold a segment boundary (segment_key_sectors) in,
    starts and lens out; no FP32 operation (the searches are integer
    compares, which the table has no rate for). Bounds (the first of the
    segments' kernels): the same key sectors in, the `nodes` + 1 int32
    bounds out. Integer work (the Morton interleave, the shifts) is not
    counted. The sort's rows also give the passes' floor
    (sort_passes_floor: int64 keys in, 32-bit keys and int32 indices
    between passes, int64 keys and permutation out) where `passes` is
    given."""
    if name == "bin_keys":
        nbytes, flops = n * (16 + 1 + 64), 56 * n
    elif name in ("bin_sort", "bin_sort_pass"):
        nbytes, flops = 8 * n * 24, 0
    elif name == "bin_sort_histogram":
        nbytes, flops = 8 * n * 8 + 4 * 256 * passes, 0
    elif name == "bin_entries":
        nbytes, flops = 8 * n * (8 + 8 + 32) + 32 * n, 2 * 8 * n
    elif name == "tile_bounds":
        nbytes, flops = 32 * key_sectors + 4 * (nodes + 1), 0
    else:
        nbytes, flops = 32 * key_sectors + 2 * 4 * tiles * levels, 0
    t_ops, t_bytes = flops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    out = {"bytes": nbytes, "flops": flops, "ops_ms": t_ops,
           "bytes_ms": t_bytes, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops > t_bytes else "bytes"}
    if name in ("bin_sort", "bin_sort_pass") and passes:
        out["passes_floor"] = sort_passes_floor(8 * n, passes, 8, 4, 16)
    return out


def _max_abs(got, ref) -> float:
    """Largest |got - ref| over the values that differ (NaN beside NaN
    does not)."""
    same = got == ref
    if got.is_floating_point():
        same |= torch.isnan(got) & torch.isnan(ref)
    d = torch.where(same, 0.0, (got.double() - ref.double()).abs())
    return float(d.max()) if d.numel() else 0.0


def binning_vs_plain(n, sp, va, origin, min_s, max_s, reps=REPS) -> list:
    """The binning kernels (csrc/binning.cu through ops/binning_cuda.py)
    against their plain versions (ops/binning.py) on one block's splats:
    keys, the sort's keys and permutation (against torch.sort(stable=True)
    and binning.radix_sort), entry_vals, entry_data, the segments' bounds
    table (binning.node_bounds), segment starts and lens bit for bit (NaN
    payloads too). Then, for each kernel, its wrapper call host-paced and
    on the device alone, the kernel alone (profiler; the segments' row
    both of their kernels, the sort passes' row all its passes of a call;
    the bounds and the sort's histogram kernels have no call of their own,
    so their rows have the kernel alone and no call times), its plain
    version, the one PyTorch call that computes the same (entries: the row
    index `mls_form[vals]`; segments: torch.searchsorted on prebuilt
    queries; bounds: torch.searchsorted of every node key; the sort:
    torch.sort(stable=True); keys: none) and its bound (binning_bound);
    the sort whole (its call, its kernels, torch.sort, its bound and
    share, its launches and syncs beside torch.sort's); and the whole
    stage (keys, sort, entries, segments) traced through the kernels and
    through the plain versions: its launches and host syncs
    (pass_profile). Its launches are comparisons: not counted by callers,
    who reset the counters after it. Returns a row per kernel."""
    tpa = 1 << (max_s - 3)
    levels = max_s - min_s + 1
    nsp = sp.shape[0]
    passes = len(binning.sort_digits(min_s, max_s))
    keys = binning_cuda.splat_keys(sp, va, origin, min_s, max_s)
    ref_keys = binning.splat_keys(sp, va, origin, min_s, max_s)
    sorted_keys, perm = binning_cuda.sort_keys(keys, min_s, max_s)
    lib_keys, lib_perm = torch.sort(keys, stable=True)
    plain_keys, plain_perm = binning.radix_sort(keys, min_s, max_s)
    data, vals = binning_cuda.entry_rows(sp, perm)
    ref_data, ref_vals = binning.entry_rows(sp, perm)
    starts, lens, bounds = binning_cuda.segments_and_bounds(
        sorted_keys, min_s, max_s, tpa)
    ref_s, ref_l = binning.tile_segments(sorted_keys, min_s, max_s, tpa)
    ref_b = binning.node_bounds(sorted_keys, min_s, max_s)
    torch.cuda.synchronize()
    sort_err = max(_max_abs(sorted_keys, plain_keys),
                   _max_abs(perm, plain_perm))
    errs = {"bin_keys": _max_abs(keys, ref_keys),
            "bin_sort_histogram": sort_err, "bin_sort_pass": sort_err,
            "bin_entries": max(_max_abs(vals, ref_vals),
                               _max_abs(data, ref_data)),
            "tile_bounds": _max_abs(bounds, ref_b),
            "tile_segments": max(_max_abs(starts, ref_s),
                                 _max_abs(lens, ref_l))}
    for label, got, ref in (("keys", keys, ref_keys),
                            ("sorted keys", sorted_keys, lib_keys),
                            ("permutation", perm, lib_perm),
                            ("sorted keys (radix_sort)", sorted_keys,
                             plain_keys),
                            ("permutation (radix_sort)", perm, plain_perm),
                            ("entry_vals", vals, ref_vals),
                            ("entry_data", data.view(torch.int32),
                             ref_data.view(torch.int32)),
                            ("bounds", bounds, ref_b),
                            ("starts", starts, ref_s), ("lens", lens, ref_l)):
        if got.shape != ref.shape or not torch.equal(got, ref):
            raise AssertionError(f"binning kernels: {label} differ from the "
                                 "plain version's")
    del lib_keys, lib_perm, plain_keys, plain_perm
    # the PyTorch calls that compute the same: the row index of a prebuilt
    # mls_form, searchsorted on tile_segments' prebuilt queries,
    # searchsorted of every node key, and torch.sort
    mls_form = sp.clone()
    mls_form[:, 3] = 1.0 / (sp[:, 3] * sp[:, 3])
    queries = segment_queries(min_s, max_s, tpa, sp.device)
    nodes = binning.node_count(min_s, max_s)
    node_keys = torch.arange(nodes + 1, dtype=torch.int64, device=sp.device)
    segments = (lambda: binning_cuda.tile_segments(sorted_keys, min_s, max_s,
                                                   tpa))
    sort = (lambda: binning_cuda.sort_keys(keys, min_s, max_s))
    plain_sort = (lambda: binning.radix_sort(keys, min_s, max_s))
    library_sort = (lambda: torch.sort(keys, stable=True))
    calls = {
        "bin_keys": (lambda: binning_cuda.splat_keys(sp, va, origin, min_s,
                                                     max_s),
                     lambda: binning.splat_keys(sp, va, origin, min_s, max_s),
                     None),
        "bin_sort_histogram": (sort, plain_sort, None),
        "bin_sort_pass": (sort, plain_sort, library_sort),
        "bin_entries": (lambda: binning_cuda.entry_rows(sp, perm),
                        lambda: binning.entry_rows(sp, perm),
                        lambda: mls_form[vals]),
        "tile_bounds": (segments,
                        lambda: binning.node_bounds(sorted_keys, min_s,
                                                    max_s),
                        lambda: torch.searchsorted(sorted_keys, node_keys)),
        "tile_segments": (segments,
                          lambda: binning.tile_segments(sorted_keys, min_s,
                                                        max_s, tpa),
                          lambda: torch.searchsorted(sorted_keys, queries))}
    sectors = segment_key_sectors(sorted_keys, ref_s, ref_l)
    rows = []
    for name, kernels, _ in BINNING_KERNELS:
        call, plain, library = calls[name]
        # the bounds and histogram kernels run only inside another call
        alone = name in ("tile_bounds", "bin_sort_histogram")
        row = {"name": name, "splats": nsp, "entries": 8 * nsp,
               "tiles": tpa ** 3, "levels": levels, "nodes": nodes,
               "max_abs_err": errs[name], "bitwise_the_plain_version": True,
               "host_paced_ms": None if alone else cuda_ms(call, reps),
               "device_ms": None if alone
               else cuda_ms(call, reps, device_only=True),
               "kernel_ms": kernel_ms(
                   call, kernels, reps,
                   passes if name == "bin_sort_pass" else 1),
               "plain_ms": cuda_ms(plain, reps),
               "library_ms": None if library is None
               else cuda_ms(library, reps, device_only=True),
               "key_sectors": sectors,
               "bound": binning_bound(name, nsp, tpa ** 3, levels, sectors,
                                      nodes, passes)}
        if name == "bin_sort_pass":
            row["launches_a_call"] = passes
        k_ms = row["kernel_ms"] or row["device_ms"]
        row["share_of_bound"] = (None if k_ms is None
                                 else row["bound"]["bound_ms"] / k_ms)
        rows.append(row)
    by_name = {r["name"]: r for r in rows}
    parts = [by_name["bin_sort_histogram"]["kernel_ms"],
             by_name["bin_sort_pass"]["kernel_ms"]]
    sort_bound = binning_bound("bin_sort", nsp, tpa ** 3, levels,
                               passes=passes)
    sort_row = {
        "passes": passes, "launches_a_call": 1 + passes,
        "call_host_paced_ms": by_name["bin_sort_pass"]["host_paced_ms"],
        "call_device_ms": by_name["bin_sort_pass"]["device_ms"],
        "kernels_ms": None if None in parts else sum(parts),
        "torch_sort_ms": by_name["bin_sort_pass"]["library_ms"],
        "bound_ms": sort_bound["bound_ms"], "bound_bytes": sort_bound["bytes"],
        "passes_floor": sort_bound["passes_floor"],
        "traced": pass_profile(sort), "torch_sort_traced":
        pass_profile(library_sort)}
    k_ms = sort_row["kernels_ms"] or sort_row["call_device_ms"]
    sort_row["share_of_bound"] = sort_bound["bound_ms"] / k_ms

    def stage(path):
        b = path.bin_splats(sp, va, origin, min_s, max_s)
        return path.tile_segments(b.entry_keys, min_s, max_s, tpa)

    stage_ms = {"kernels": cuda_ms(lambda: stage(binning_cuda), reps),
                "plain": cuda_ms(lambda: stage(binning), reps)}
    traced = {"kernels": pass_profile(lambda: stage(binning_cuda)),
              "plain": pass_profile(lambda: stage(binning), 1)}
    for row in rows:
        row.update(sort=sort_row, stage_ms=stage_ms, stage=traced)
    phase(n, f"binning kernels vs plain at {tpa}^3 tiles, {levels} levels, "
             f"{nsp} splats: keys, the sort's keys and permutation (torch."
             f"sort's and radix_sort's), entry_vals, entry_data, the bounds "
             f"of {nodes + 1} node keys, starts and lens bit for bit; the "
             f"sort {json.dumps(sort_row)}; the stage host-paced "
             f"{json.dumps(stage_ms)}, traced (launches, syncs) "
             f"{json.dumps(traced)}")
    for row in rows:
        phase(n, f"{row['name']}: " + json.dumps(
            {k: v for k, v in row.items()
             if k not in ("sort", "stage_ms", "stage")}))
    return rows


def marching_bound(name: str, b: int, march_tiles: int, read_tiles: int,
                   vertices: int, words: int) -> dict:
    """The least time the card could take for a marching kernel's work on
    these inputs (a (b, b, b) field, `march_tiles` tiles with an occupied
    cell, `read_tiles` tiles in the row segments that hold one, `vertices`
    vertices, an image of `words` words): the larger of its bytes over the
    memory rate (each input read once, each output written once) and its
    FP32 operations over the FP32 peak. Classify: the field in, an 8-byte
    record a tile and a 16-byte record a row segment out; 16 operations a
    cell (8 sign tests, 8 finite tests). Scan: the segment records in, the
    tile records of the segments with an occupied tile (the others it
    never reads), a 16-byte row a listed tile and the totals out; no FP32
    operation. Emit: the rows and the listed tiles' 8^3 corners in, the
    image out; 16 operations a cell of a listed tile and 6 a vertex (t16's
    subtraction, division, product, rounding and clamp). "stage": the
    three together, the field read once and the image written once."""
    g = -(-(b - 1) // marching.TILE)
    tiles, cells = g ** 3, (b - 1) ** 3
    segments = g * g * -(-g // marching_cuda.ROW_TILES)
    listed = march_tiles * marching.TILE ** 3
    if name == "march_classify":
        nbytes, flops = 4 * b ** 3 + 8 * tiles + 16 * segments, 16 * cells
    elif name == "march_scan":
        nbytes = (16 * segments + 8 * read_tiles + 16 * march_tiles
                  + 8 * len(marching_cuda.TOTALS))
        flops = 0
    elif name == "march_emit":
        nbytes = 16 * march_tiles + 4 * listed + 4 * words
        flops = 16 * listed + 6 * vertices
    else:
        nbytes, flops = 4 * b ** 3 + 4 * words, 16 * cells + 6 * vertices
    t_ops, t_bytes = flops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return {"bytes": nbytes, "flops": flops, "ops_ms": t_ops,
            "bytes_ms": t_bytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def segment_tiles(marched: marching_cuda.Marched) -> int:
    """The tiles of the classify pass's row segments that hold a listed
    tile: the tile records the scan reads."""
    b = marched.field.shape[0]
    g = -(-(b - 1) // marching.TILE)
    per = marching_cuda.ROW_TILES
    t = marched.tile_list[:marched.march_tiles, 0].long()
    first = torch.unique(t - t % g % per)  # each such segment's first tile
    return int(torch.clamp(g - first % g, max=per).sum())


def marching_vs_plain(n, field, region, n_occ, reps=REPS) -> list:
    """The codes path's kernels (csrc/marching.cu through
    ops/marching_cuda.py) against the plain block.pack_codes(
    marching.generate_codes(...)) on one block's field: the image and the
    counts bit for bit, n_occ copied back with the totals. Then the call
    host-paced, its two C calls on the device alone (classify and scan;
    emit), each kernel alone (one profiler trace's kernel events),
    the call's card busy time, launches and host syncs (pass_profile;
    checked: the three kernels and at most one sync) beside the plain
    stage's, the plain stage host-paced, each kernel's bound and the
    stage's (marching_bound). Its launches are comparisons: not counted by
    callers, who reset the counters after it. Returns a row per kernel."""
    b = field.shape[0]
    img, counts = marching_cuda.codes_image(field, region)
    cm = marching.generate_codes(field, region)
    want = block.pack_codes(cm)
    torch.cuda.synchronize()
    if img.shape != want.shape or not torch.equal(img, want):
        raise AssertionError("marching kernels: the codes image differs from "
                             "the plain version's")
    plain_counts = marching_cuda.MarchCounts(
        cm.num_cells, cm.num_vertices, cm.num_indices, cm.num_tiles)
    if counts != plain_counts:
        raise AssertionError(f"marching kernels: counts {counts}, plain "
                             f"{plain_counts}")
    err = _max_abs(img, want)
    marched = marching_cuda.classify(field, region, n_occ)
    if marched.counts != plain_counts or marched.n_occ != int(n_occ):
        raise AssertionError(f"marching kernels: {marched.counts}, n_occ "
                             f"{marched.n_occ}; plain {plain_counts}, "
                             f"{int(n_occ)}")
    march_tiles, read_tiles = marched.march_tiles, segment_tiles(marched)
    words = int(img.numel())
    del img, want
    call = lambda: marching_cuda.codes_image(field, region)  # noqa: E731
    plain = lambda: block.pack_codes(  # noqa: E731
        marching.generate_codes(field, region))
    host_ms = cuda_ms(call, reps)
    plain_ms = cuda_ms(plain, reps)
    # the two C calls on the device alone (no sync inside either): the
    # classify and scan kernels, and the emit kernel
    calls_ms = {
        "classify_scan": cuda_ms(
            lambda: marching_cuda.launch_classify(field, region), reps,
            device_only=True),
        "emit": cuda_ms(lambda: marching_cuda.emit(marched), reps,
                        device_only=True)}
    events = trace_events(call, reps)
    alone = {name: kernel_event_ms(events, (fn,), reps)
             for name, fn, _ in MARCHING_KERNELS}
    traced = {"kernels": pass_profile(call), "plain": pass_profile(plain, 1)}
    if traced["kernels"]["launches"] != 3 or \
            traced["kernels"]["sync_calls"] > 1:
        raise AssertionError(f"marching kernels: {traced['kernels']} a call")
    stage_bound = marching_bound("stage", b, march_tiles, read_tiles,
                                 cm.num_vertices, words)
    rows = []
    for name, _, _ in MARCHING_KERNELS:
        bound = marching_bound(name, b, march_tiles, read_tiles,
                               cm.num_vertices, words)
        k_ms = alone[name]
        rows.append({
            "name": name, "corners": b, "cells": cm.num_cells,
            "vertices": cm.num_vertices, "indices": cm.num_indices,
            "candidate_tiles": cm.num_tiles, "march_tiles": march_tiles,
            "segment_tiles": read_tiles,
            "image_words": words, "max_abs_err": err,
            "bitwise_the_plain_image": True, "host_paced_ms": host_ms,
            "device_ms": traced["kernels"]["device_busy_ms"],
            "call_device_ms": calls_ms[
                "emit" if name == "march_emit" else "classify_scan"],
            "kernel_ms": k_ms, "plain_ms": plain_ms, "library_ms": None,
            "bound": bound,
            "share_of_bound": None if k_ms is None
            else bound["bound_ms"] / k_ms})
    known = [r["kernel_ms"] for r in rows if r["kernel_ms"] is not None]
    stage = {"host_paced_ms": host_ms, "plain_ms": plain_ms,
             "calls_device_ms": calls_ms,
             "kernels_ms": sum(known) if len(known) == len(rows) else None,
             "bound": stage_bound, "traced": traced}
    phase(n, f"marching kernels vs plain at {b}^3 corners, region {region}: "
             f"image and counts bit for bit ({cm.num_cells} cells, "
             f"{cm.num_vertices} vertices, {march_tiles} tiles listed, "
             f"{cm.num_tiles} candidate tiles); stage {json.dumps(stage)}")
    for row in rows:
        phase(n, f"{row['name']}: " + json.dumps(row))
        row["stage"] = stage
    return rows


def mesh_bound(name: str, b: int, march_tiles: int, n: int, nw: int,
               ni: int, words: int, passes: int,
               key_bytes: Optional[int] = None) -> dict:
    """The least time the card could take for a mesh readback kernel's
    work on these inputs (a (b, b, b) field, `march_tiles` listed tiles,
    n unwelded and nw welded vertices, ni triangle indices, an image of
    `words` words, a sort of `passes` passes): the larger of its bytes
    over the memory rate (each input read once, each output written once)
    and its FP32 operations over the FP32 peak. The compact keys between
    the emission and the weld take `key_bytes` each (by default their sort
    width, mesh_cuda.sort_key_bytes: 4 at 28 and 31 bits; 8 gives the
    yardstick of int64 keys, 28 bytes a vertex out of the emission, as the
    bound was counted before the keys took 4). Emission: the list rows and the
    listed tiles' 8^3 corners in; a vertex's 3 floats, 2 key halves and
    compact key and an int32 an index out; 16 operations a cell of a
    listed tile, 8 a vertex (t's subtraction and division, three products
    and sums). The sort's histogram: the keys in, `passes` x 256 int32
    counts out. The sort ("weld_sort_pass", its passes, which with the
    histogram make the sort over the top digits): the keys in, the
    top-sorted keys (their sort width) and int32 indices out. The group
    kernel: those in, a welded vertex's 3 floats and 2 key halves in and
    out, an int32 remap a vertex and the 3 totals out. The weld whole
    ("weld", whatever implements it): the keys in, 20 bytes a welded
    vertex in and 20 out, the remap out. Pack: a welded vertex's 3 floats
    and 2 key halves, the int32 triangle indices and the remap in, the
    image out; 5 operations a vertex (3 fractions, 1 - t, t's product).
    "stage": the field in and the image out, the operations of all. No
    integer work is counted. The sort's passes' row also gives the passes'
    floor (sort_passes_floor: the keys in at their width, the sort keys
    and int32 indices between passes and out)."""
    listed = march_tiles * marching.TILE ** 3
    kb = mesh_cuda.sort_key_bytes(mesh_cuda.key_bits(mesh_cuda.axis_bits(b)))
    ib = kb if key_bytes is None else key_bytes
    if name == "march_emit_mesh":
        nbytes = 16 * march_tiles + 4 * listed + (20 + ib) * n + 4 * ni
        flops = 16 * listed + 8 * n
    elif name == "weld_sort_histogram":
        nbytes, flops = ib * n + 4 * 256 * passes, 0
    elif name == "weld_sort_pass":
        nbytes, flops = ib * n + (kb + 4) * n, 0
    elif name == "weld_group":
        nbytes, flops = (kb + 4) * n + 2 * 20 * nw + 4 * n + 24, 0
    elif name == "weld":
        nbytes, flops = ib * n + 2 * 20 * nw + 4 * n, 0
    elif name == "pack_readback":
        nbytes, flops = 20 * nw + 4 * ni + 4 * n + 4 * words, 5 * nw
    else:
        nbytes = 4 * b ** 3 + 4 * words
        flops = 16 * (b - 1) ** 3 + 8 * n + 5 * nw
    t_ops, t_bytes = flops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    out = {"bytes": nbytes, "flops": flops, "ops_ms": t_ops,
           "bytes_ms": t_bytes, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops > t_bytes else "bytes"}
    if name == "weld_sort_pass":
        out["passes_floor"] = sort_passes_floor(n, passes, ib, kb, kb + 4)
    return out


def mesh_chain_vs_plain(label, field, region, origin, levels, n_occ=None):
    """The packed and raw readbacks' kernels on one field against the
    plain chain marching.generate_mesh -> weld.weld -> block.pack_readback:
    the unwelded vertices, keys and triangles, the welded vertices, keys
    and counts, raw's triangles and the packed image bit for bit (n_occ
    copied back with the totals where given). Returns the card's mesh,
    weld and image format, the image's words and the largest |difference|
    (0: bit for bit)."""
    mesh = mesh_cuda.generate_mesh(field, region, origin, n_occ)
    welded = mesh_cuda.weld(mesh)
    fmt = block.pack_format(levels, SUB, welded.num_vertices)
    img = mesh_cuda.pack_readback(welded, origin, fmt)
    raw = mesh_cuda.welded_mesh(welded)
    pm = marching.generate_mesh(field, region, origin)
    pw = weld.weld(pm.vertices, pm.key_hi, pm.key_lo, pm.triangles)
    want = block.pack_readback(pw, origin, fmt)
    torch.cuda.synchronize()
    if n_occ is not None and mesh.n_occ != int(n_occ):
        raise AssertionError(f"mesh kernels ({label}): n_occ {mesh.n_occ}, "
                             f"plain {int(n_occ)}")
    counts = (mesh.num_cells, mesh.num_vertices, mesh.num_indices,
              mesh.num_tiles, welded.num_vertices, welded.first_external)
    plain_counts = (pm.num_cells, pm.num_vertices, pm.num_indices,
                    pm.num_tiles, pw.num_vertices, pw.first_external)
    if counts != plain_counts:
        raise AssertionError(f"mesh kernels ({label}): counts {counts}, "
                             f"plain {plain_counts}")
    u32 = lambda t: t.long() & 0xFFFFFFFF  # noqa: E731
    _same_bits(mesh.vertices, pm.vertices, f"mesh kernels ({label}): "
               "vertices")
    _same_bits(welded.vertices, pw.vertices, f"mesh kernels ({label}): "
               "welded vertices")
    for got, ref, what in (
            (u32(mesh.key_hi), pm.key_hi, "key_hi"),
            (u32(mesh.key_lo), pm.key_lo, "key_lo"),
            (mesh.triangles.long(), pm.triangles, "triangles"),
            (u32(welded.key_hi), pw.key_hi, "welded key_hi"),
            (u32(welded.key_lo), pw.key_lo, "welded key_lo"),
            (raw.triangles.long(), pw.triangles, "welded triangles"),
            (img, want, f"the {fmt.index_mode} image")):
        if got.shape != ref.shape or not torch.equal(got, ref):
            raise AssertionError(f"mesh kernels ({label}): {what} differ "
                                 "from the plain chain's")
    err = max(_max_abs(mesh.vertices, pm.vertices),
              _max_abs(welded.vertices, pw.vertices), _max_abs(img, want))
    return mesh, welded, fmt, int(img.numel()), err


def dense_tile_field(b, dev, seed=0):
    """A (b, b, b) field of positive values but for boxes whose sign
    alternates corner by corner, so that every cell of their tiles is
    occupied with the most vertices and triangles a cell has (13 and 12:
    the mesh emission's owner maps at their worst): whole tiles at 256^3,
    and at an odd b (corner rows not 16-byte aligned) tiles cut by the
    field's end too. Its region and origin."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    f = 0.5 + torch.rand((b, b, b), generator=gen, device=dev)
    g = torch.arange(b, device=dev)
    alt = 1.0 - 2.0 * ((g[:, None, None] + g[None, :, None]
                        + g[None, None, :]) % 2).float()
    boxes = [(slice(8, 25), slice(16, 33), slice(40, 57))]
    if b % 2:
        boxes.append((slice(b - 21, b), slice(b - 13, b), slice(b - 30, b)))
    for box in boxes:
        f[box] *= alt[box]
    return f, (b - 1, b - 1, b - 2), (3, 70, 1000)


def mesh_vs_plain(n, field, region, origin, n_occ, levels, reps=REPS,
                  dense=()) -> list:
    """The packed and raw readbacks' kernels (ops/mesh_cuda.py: classify
    and scan, the mesh emission, the weld's sort over the keys' top digits
    and its group kernel, the pack kernel) against the plain chain on one
    block's field, bit for bit (mesh_chain_vs_plain), and on the dense-tile
    fields of each size in `dense` (dense_tile_field). Then on the block's
    field the packed stage (mesh_cuda.mesh_image) host-paced, each kernel
    alone (one profiler trace's kernel events; the pass kernel's summed
    over its passes), the stage's card busy time, launches and host syncs
    (pass_profile; checked: the kernels alone and at most two syncs)
    beside the plain chain's, the plain chain host-paced, the library
    yardsticks on the compact keys (torch.unique(sorted=True,
    return_inverse=True) and torch.sort(stable=True)), each kernel's bound
    and the stage's (mesh_bound), each kernel's share also of its bound
    with int64 keys from the emission (mesh_bound's key_bytes=8), and the
    weld's kernels together against the bound of the weld whole. Its
    launches are comparisons: callers reset the counters after it.
    Returns a row per kernel."""
    b = field.shape[0]
    for size in dense:
        dfield, dregion, dorigin = dense_tile_field(size, field.device)
        dmesh, dwelded, dfmt, _, _ = mesh_chain_vs_plain(
            f"dense tiles {size}^3", dfield, dregion, dorigin, levels)
        phase(n, f"mesh kernels vs plain on dense tiles at {size}^3 "
                 f"corners: bit for bit ({dmesh.num_cells} cells, "
                 f"{dmesh.num_vertices} vertices welded to "
                 f"{dwelded.num_vertices}, {dmesh.num_indices} indices, "
                 f"the {dfmt.index_mode} image)")
        del dfield, dmesh, dwelded
    mesh, welded, fmt, words, err = mesh_chain_vs_plain(
        f"{b}^3", field, region, origin, levels, n_occ)
    nv, nw, ni = mesh.num_vertices, welded.num_vertices, mesh.num_indices
    passes = mesh_cuda.sort_passes(mesh_cuda.key_bits(mesh.axis_bits))
    marched = marching_cuda.classify(
        field, region, max_corners=marching_cuda.MESH_MAX_CORNERS)
    march_tiles = marched.march_tiles
    keys = mesh.sort_keys
    del marched
    call = lambda: mesh_cuda.mesh_image(  # noqa: E731
        field, region, origin, levels, SUB)

    def plain():
        m = marching.generate_mesh(field, region, origin)
        w = weld.weld(m.vertices, m.key_hi, m.key_lo, m.triangles)
        return block.pack_readback(w, origin, block.pack_format(
            levels, SUB, w.num_vertices))

    host_ms = cuda_ms(call, reps)
    plain_ms = cuda_ms(plain, reps)
    library = {
        "unique_ms": cuda_ms(lambda: torch.unique(
            keys, sorted=True, return_inverse=True), reps),
        "torch_sort_ms": cuda_ms(lambda: torch.sort(keys, stable=True),
                                 reps)}
    events = trace_events(call, reps)
    alone = {name: kernel_event_ms(events, (fn,), reps,
                                   passes if name == "weld_sort_pass" else 1)
             for name, fn, _ in MESH_KERNELS}
    traced = {"kernels": pass_profile(call), "plain": pass_profile(plain, 1)}
    # classify, scan, emission, histogram, a pass a top digit, the group
    # kernel, pack: 9 at 256^3 and 512^3 (3 passes at 28 and 31 bits)
    if traced["kernels"]["launches"] != 6 + passes or \
            traced["kernels"]["sync_calls"] > 2:
        raise AssertionError(f"mesh kernels: {traced['kernels']} a call")
    sizes = (b, march_tiles, nv, nw, ni, words, passes)
    stage_bound = mesh_bound("stage", *sizes)
    rows = []
    for name, _, _ in MESH_KERNELS:
        bound = mesh_bound(name, *sizes)
        wide = mesh_bound(name, *sizes, key_bytes=8)
        k_ms = alone[name]
        rows.append({
            "name": name, "corners": b, "cells": mesh.num_cells,
            "vertices": nv, "welded": nw, "first_external":
            welded.first_external, "indices": ni, "march_tiles": march_tiles,
            "key_bits": mesh_cuda.key_bits(mesh.axis_bits),
            "key_bytes": keys.element_size(),
            "sort_passes": passes, "index_mode": fmt.index_mode,
            "vertex_words": fmt.vertex_words, "image_words": words,
            "max_abs_err": err, "bitwise_the_plain_chain": True,
            "host_paced_ms": host_ms,
            "device_ms": traced["kernels"]["device_busy_ms"],
            "kernel_ms": k_ms, "plain_ms": plain_ms,
            "library_ms": (library["unique_ms"]
                           if name.startswith("weld") else None),
            "bound": bound,
            "share_of_bound": None if k_ms is None
            else bound["bound_ms"] / k_ms,
            "int64_key_bound_ms": wide["bound_ms"],
            "share_of_int64_key_bound": None if k_ms is None
            else wide["bound_ms"] / k_ms})
    known = [r["kernel_ms"] for r in rows if r["kernel_ms"] is not None]
    welds = [r["kernel_ms"] for r in rows if r["name"].startswith("weld")]
    weld_ms = None if None in welds else sum(welds)
    weld_bound = mesh_bound("weld", *sizes)
    stage = {"host_paced_ms": host_ms, "plain_ms": plain_ms,
             "kernels_ms": sum(known) if len(known) == len(rows) else None,
             "library": library, "bound": stage_bound, "traced": traced,
             "weld": {"kernels_ms": weld_ms, "bound": weld_bound,
                      "share_of_bound": None if weld_ms is None
                      else weld_bound["bound_ms"] / weld_ms,
                      "int64_key_bound_ms": mesh_bound(
                          "weld", *sizes, key_bytes=8)["bound_ms"]}}
    phase(n, f"mesh kernels vs plain at {b}^3 corners, region {region}: "
             f"unwelded, welded, raw and the {fmt.index_mode} image bit for "
             f"bit ({nv} vertices welded to {nw}, {ni} indices, "
             f"{march_tiles} tiles listed, {passes} sort passes, "
             f"{keys.element_size()}-byte keys); stage {json.dumps(stage)}")
    for row in rows:
        phase(n, f"{row['name']}: " + json.dumps(row))
        row["stage"] = stage
    return rows


def phase3_kernel_vs_plain(src, info, b, dev) -> list:
    """`b`: the densest of the buckets the main path streams."""
    grid_form, valid = load_bucket(src, info, b)
    min_s, max_s = SUB, LEVELS + SUB - 1
    tpa = 1 << (max_s - 3)
    origin = tuple(int(v) for v in b.cell_lo)
    sp = torch.as_tensor(grid_form, device=dev)
    va = torch.as_tensor(valid, device=dev)
    bins = binning_vs_plain(3, sp, va, origin, min_s, max_s)
    binned = binning.bin_splats(sp, va, origin, min_s, max_s)
    starts, lens = binning.tile_segments(binned.entry_keys, min_s, max_s, tpa)
    n_occ = int((lens.sum(1) > 0).sum())
    max_tile = int(lens.sum(1).max())
    bound = kernel_bound(binned, starts, lens, origin, tpa)
    rows = []
    for fit in ("sphere", "plane"):
        for gamma in GAMMAS:
            rows.append(kernel_vs_plain(3, binned, starts, lens, origin, tpa,
                                        fit, 1.0 - gamma * gamma,
                                        bound=bound))
    field = mls_cuda.launch(binned.entry_data, starts, lens, origin, tpa,
                            "sphere", 0.0)
    region = tuple(int(v) for v in b.cell_hi - b.cell_lo)
    points = torch.as_tensor(b.skeleton, device=dev)
    rounding_probe(dev)
    seams = seam_vs_plain(3, binned, starts, lens, origin, region, points,
                          tpa, "sphere", 0.0, field)
    seams += seam_vs_plain(3, binned, starts, lens, origin, region, points,
                           tpa, "plane", 1.0 - GAMMAS[1] ** 2, field,
                           timed=False)
    face_passes_on_two_streams(3, binned, starts, lens, origin, region, tpa,
                               field)
    del field
    # the block's field, binning to skeleton, as the block step marches it
    bfield, field_occ = block.block_field(sp, va, region, origin, 0.0,
                                          points, levels=LEVELS,
                                          subsampling=SUB)
    marches = marching_vs_plain(3, bfield, region, field_occ)
    meshes = mesh_vs_plain(3, bfield, region, origin, field_occ, LEVELS,
                           dense=(256, 301))
    del bfield
    phase(3, f"bucket {b.num_splats} splats, {binned.entry_data.shape[0]} "
             f"entries, {tpa}^3 tiles, {n_occ} occupied, max tile total "
             f"{max_tile}, {len(b.skeleton)} skeleton points: OK")
    return rows, seams, bins, marches, meshes


def _seam_block(splats, lo, hi, dev, points=None):
    pts = None if points is None else torch.as_tensor(points, device=dev)
    field, _ = block.block_field(
        torch.as_tensor(splats, device=dev),
        torch.ones(len(splats), dtype=torch.bool, device=dev),
        tuple(int(v) for v in np.subtract(hi, lo)), tuple(int(v) for v in lo),
        0.0, pts, levels=3, subsampling=3)
    return field.cpu().numpy()


def _bitwise_equal(pa, pb, min_defined, label):
    na, nb = np.isnan(pa), np.isnan(pb)
    if not np.array_equal(na, nb):
        raise AssertionError(f"{label}: NaN patterns differ")
    if int((~na).sum()) < min_defined:
        raise AssertionError(f"{label}: only {int((~na).sum())} defined")
    if not np.array_equal(pa[~na].view(np.uint32), pb[~nb].view(np.uint32)):
        raise AssertionError(f"{label}: shared corners differ bitwise")
    return int((~na).sum())


def phase4_seams(dev) -> list:
    b = 1 << (3 + 3 - 1)  # 32-corner blocks
    checked = []
    for plane in (28, 24):  # 28 % 8 != 0: misaligned origin
        rng = np.random.default_rng(42)
        splats = sphere_cloud([plane, 14.0, 14.0], 9.0, 6000, 1.2, rng)
        fa = _seam_block(splats, (0, 0, 0), (plane, b - 1, b - 1), dev)
        fb = _seam_block(splats, (plane, 0, 0), (plane + b - 1, b - 1, b - 1),
                         dev)
        checked.append(_bitwise_equal(fa[:, :, plane], fb[:, :, 0], 100,
                                      f"face x={plane}"))
    # in-plane origin y = 3: the face patch y in [0, 7] straddles both
    # blocks' edge, and a splat in mid-stream reaches it only at y < 3 and
    # reaches only A's tiles (tests/test_torch_faces.py's case)
    rng = np.random.default_rng(42)
    splats = sphere_cloud([28.0, 14.0, 12.0], 9.0, 6000, 1.2, rng)
    extra = splats[:1].copy()
    extra[0, 0:4] = [25.1, 0.8, 12.0, 3.0]
    splats = np.concatenate([splats[:3000], extra, splats[3000:]])
    fa = _seam_block(splats, (0, 3, 0), (28, 3 + b - 1, b - 1), dev)
    fb = _seam_block(splats, (28, 3, 0), (28 + b - 1, 3 + b - 1, b - 1), dev)
    checked.append(_bitwise_equal(fa[:, :, 28], fb[:, :, 0], 100,
                                  "face x=28, y from 3"))
    rng = np.random.default_rng(3)
    splats = sphere_cloud([12.0, 12.0, 16.0], 7.0, 9000, 1.2, rng)
    mk = [bucket_mod.Bucket(chunk_id=None, cell_lo=np.array(lo, np.int64),
                            cell_hi=np.array(hi, np.int64),
                            blob_ids=np.empty(0, np.int64), num_splats=1)
          for lo, hi in (((0, 0, 0), (16, 16, 31)), ((16, 0, 0), (31, 16, 31)),
                         ((0, 16, 0), (31, 31, 31)))]
    bucket_mod.skeleton_points(mk)
    rows = []
    for k in mk:  # both seam kernels against their plain versions
        origin = tuple(int(v) for v in k.cell_lo)
        region = tuple(int(v) for v in k.cell_hi - k.cell_lo)
        binned = binning.bin_splats(torch.as_tensor(splats, device=dev),
                                    torch.ones(len(splats), dtype=torch.bool,
                                               device=dev), origin, 3, 5)
        starts, lens = binning.tile_segments(binned.entry_keys, 3, 5, 4)
        field = mls_cuda.launch(binned.entry_data, starts, lens, origin, 4,
                                "sphere", 0.0)
        rows += seam_vs_plain(4, binned, starts, lens, origin, region,
                              torch.as_tensor(k.skeleton, device=dev), 4,
                              "sphere", 0.0, field, timed=False)
    fa, fc, fb = (_seam_block(splats, k.cell_lo, k.cell_hi, dev, k.skeleton)
                  for k in mk)
    checked.append(_bitwise_equal(fa[:, 16, 0:17], fb[:, 0, 0:17], 20, "A|B"))
    checked.append(_bitwise_equal(fc[:, 16, 0:16], fb[:, 0, 16:32], 20, "C|B"))
    checked.append(_bitwise_equal(fa[:, 0:17, 16], fc[:, 0:17, 0], 20, "A|C"))
    phase(4, f"seam contract on the card (through the seam kernels): "
             f"{sum(checked)} shared corners bitwise equal over "
             f"{len(checked)} planes: OK")
    return rows


def cli_run(cloud, name, extra=(), manifold=True, topology_of=None) -> dict:
    """One run of `cli.main` on the bench cloud, cloud = (PLY path, grid
    spacing); kernel launches counted from 0 for this run alone. Returns
    the run's numbers, statistics and digests of its mesh and of its
    triangles; `manifold` runs the manifold check (~2 min at 2M), whose
    verdict depends on the triangles and the vertex count alone, so a run
    whose both equal those of `topology_of` (an earlier result) takes
    that result's counts instead."""
    inp, spacing = cloud
    out = os.path.join(os.path.dirname(inp), f"{name}.ply")
    reg = get_registry()
    reg.clear()
    reset_launches()
    t0 = time.monotonic()
    rc = cli.main([*bench_args(spacing), *extra, "-o", out, inp])
    elapsed = time.monotonic() - t0
    launches = read_launches()
    if rc != 0:
        raise RuntimeError(f"cli.main {' '.join(extra)} returned {rc}")
    verts, tris = ply.read_mesh(out)
    os.remove(out)
    blocks = reg.counter("bucket.count").get()
    check_launches(name, launches, blocks,
                   reg.counter("bucket.skeletonBlocks").get(),
                   codes_blocks(reg), mesh_blocks(reg))
    res = {"seconds": elapsed, "vertices": len(verts),
           "triangles": len(tris), "blocks": blocks,
           "kernel_launches": launches, "stats": reg.to_dict(),
           "digest": hashlib.sha256(verts.tobytes() + tris.tobytes())
           .hexdigest(),
           "tri_digest": hashlib.sha256(tris.tobytes()).hexdigest()}
    if manifold and topology_of is not None and \
            topology_of["tri_digest"] == res["tri_digest"] and \
            topology_of["vertices"] == res["vertices"]:
        res.update(boundary_edges=topology_of["boundary_edges"],
                   components=topology_of["components"],
                   manifold_as="the triangles of an earlier run, bit for bit")
    elif manifold:
        rep = check_manifold(verts, tris)
        if not rep.is_manifold:
            raise AssertionError(f"{name}: output not manifold: "
                                 f"{rep.reason}")
        res.update(boundary_edges=rep.num_boundary_edges,
                   components=rep.num_components)
    return res


def _same_mesh(res, ref, name):
    keys = ("vertices", "triangles", "boundary_edges", "components")
    if any(res[k] != ref[k] for k in keys):
        raise AssertionError(f"{name}: {[res[k] for k in keys]} != codes "
                             f"run's {[ref[k] for k in keys]}")


def phase5_end_to_end(cloud, info) -> dict:
    res = cli_run(cloud, "codes", ["--readback", "codes"])
    stats = res.pop("stats")
    elapsed = res["seconds"]
    ncells = int(np.prod(info.grid.shape_cells))
    res.update({"msplats_per_s": N_SPLATS / elapsed / 1e6,
                "mcells_per_s": ncells / elapsed / 1e6,
                "readback_bytes": stats["readback.bytes"]["total"],
                "pass0_s": stats["pass0.time"]["sum"],
                "pass1_s": stats["pass1.time"]["sum"],
                "write_s": stats["write.time"]["sum"],
                "device_s": stats["device.time"]["sum"]})
    phase(5, f"end to end: {json.dumps(res)}")
    return res


def phase5_mesh_readbacks(cloud, codes) -> dict:
    """The 2M cloud through the CLI with --readback packed and raw (the
    mesh kernels on every block): manifold, with the codes run's vertex,
    triangle, boundary-edge and component counts (a run whose triangles
    are the run's before it bit for bit takes that run's check: raw
    packed's, packed codes'); whether each mesh is the codes run's bit for
    bit (its digest) and its triangles are (tri_digest)."""
    runs = {}
    for mode in ("packed", "raw"):
        # the manifold check only where the triangles are new: raw welds
        # as packed does
        res = cli_run(cloud, f"cli_{mode}", ["--readback", mode],
                      topology_of=runs.get("packed", codes))
        stats = res.pop("stats")
        if stats.get(f"readback.mode.{mode}", {}).get("total") != \
                res["blocks"]:
            raise AssertionError(f"{mode}: not every block read back {mode}")
        _same_mesh(res, codes, mode)
        res["digest_is_codes"] = res["digest"] == codes["digest"]
        res["triangles_are_codes"] = res["tri_digest"] == codes["tri_digest"]
        res["device_s"] = stats["device.time"]["sum"]
        runs[mode] = res
        phase(5, f"--readback {mode}: {json.dumps(res)}")
    return runs


def phase7_readbacks(cloud) -> dict:
    """The three readback modes on the N_SMALL cloud; packed and raw must
    give the codes run's mesh counts."""
    runs, seconds = {}, {}
    for mode in ("codes", "packed", "raw"):
        res = cli_run(cloud, mode, ["--readback", mode])
        if res["stats"].get(f"readback.mode.{mode}", {}).get("total") != \
                res["blocks"]:
            raise AssertionError(f"{mode}: not every block read back {mode}")
        _same_mesh(res, runs.get("codes", res), mode)
        seconds[mode] = res["seconds"]
        runs[mode] = res
        phase(7, f"--readback {mode}: {res['vertices']} vertices, "
                 f"{res['triangles']} triangles, {res['boundary_edges']} "
                 f"boundary edges, manifold, {res['kernel_launches']} "
                 f"launches, readback {res['stats']['readback.bytes']['total']}"
                 f" bytes, device.time "
                 f"{res['stats']['device.time']['sum']:.3f} s: OK")
    phase(7, f"end-to-end seconds by readback at {N_SMALL} splats: "
             f"{json.dumps(seconds)}")
    return runs


@contextlib.contextmanager
def stage_samples():
    """Every `device.<stage>.time` sample recorded in this process while
    the context is open, in ms, in the order the blocks recorded them, by
    stage: a run with one worker runs its block steps here, in the
    streamer's thread (ops/block.py StageTimer)."""
    samples = {}
    add = Variable.add

    def record(self, value):
        name = self.name
        if name.startswith("device.") and name.endswith(".time") and \
                name != "device.time":
            samples.setdefault(name[len("device."):-len(".time")],
                               []).append(1e3 * value)
        return add(self, value)

    Variable.add = record
    try:
        yield samples
    finally:
        Variable.add = add


def phase8_statistics_device(cloud, plain) -> list:
    """--statistics-device in the codes and packed modes: the mesh must be
    bitwise the plain run's of the same mode (whose counts phases 5 and 7
    checked), so no second manifold check is needed. Each stage's time is
    printed block by block (stage_samples) beside its mean."""
    runs = []
    for mode in ("codes", "packed"):
        with stage_samples() as samples:
            res = cli_run(cloud, f"stats_{mode}",
                          ["--statistics-device", "--readback", mode],
                          manifold=False)
        if res["digest"] != plain[mode]["digest"]:
            raise AssertionError(f"--statistics-device {mode}: the mesh "
                                 "differs from the plain run's")
        stages = {k[len("device."):-len(".time")]:
                  {"sum_s": v["sum"], "n": v["n"],
                   "mean_ms": 1e3 * v["sum"] / max(v["n"], 1)}
                  for k, v in sorted(res["stats"].items())
                  if k.startswith("device.") and k.endswith(".time")
                  and k != "device.time"}
        want = ["binning", "segments", "mls", "faces", "skeleton",
                "marching", "pack"] + (["weld"] if mode == "packed" else [])
        missing = [s for s in want if s not in stages]
        if missing:
            raise AssertionError(f"--statistics-device: no {missing}")
        for k, v in stages.items():
            if len(samples.get(k, ())) != v["n"]:
                raise AssertionError(f"--statistics-device {mode}: {k} has "
                                     f"{len(samples.get(k, ()))} samples "
                                     f"here of {v['n']}")
            v["block_ms"] = samples[k]
        res["stages"] = stages
        runs.append(res)
        phase(8, f"--statistics-device --readback {mode}: "
                 f"{res['seconds']:.3f} s, mesh bitwise the plain run's "
                 f"({res['vertices']} vertices); stages "
                 f"{json.dumps(stages)}")
    return runs


def phase9_tiled_vs_dense(splats, spacing, dev) -> dict:
    cfg = ReconstructConfig(fit_grid=spacing, fit_smooth=1.0,
                            levels=TILED_LEVELS, subsampling=SUB,
                            max_device_splats=4 << 20, tile_candidates=384,
                            progress=False)
    src = SequenceSource(splats)
    info, _, b = cloud.densest_bucket(src, cfg)
    grid_form, valid = load_bucket(src, info, b)
    region = tuple(int(v) for v in b.cell_hi - b.cell_lo)
    origin = tuple(int(v) for v in b.cell_lo)
    bf = float(cfg.boundary_factor)
    sp = torch.as_tensor(grid_form, device=dev)
    va = torch.as_tensor(valid, device=dev)
    points = (torch.as_tensor(b.skeleton, device=dev) if len(b.skeleton)
              else None)
    # the block's field first (one launch of each kernel before the
    # marching kernels, the sort's pass kernel one a digit), and the
    # marching kernels on it before the other
    # comparisons' profiler traces (after many, a trace can lose kernel
    # events)
    reset_launches()
    field, n_occ = block.block_field(sp, va, region, origin, bf, points,
                                     levels=cfg.device_levels,
                                     subsampling=SUB)
    launches = read_launches()
    if field.shape[0] != 1 << (TILED_LEVELS + SUB - 1) or \
            launches != dict(dict.fromkeys(KERNELS, 1),
                             seam_skeleton=int(points is not None),
                             bin_sort_pass=len(binning.sort_digits(
                                 SUB, TILED_LEVELS + SUB - 1)),
                             **dict.fromkeys(MARCHING + MESH, 0)):
        raise AssertionError(f"dispatch {tuple(field.shape)}, {launches} "
                             "launches")
    marches = marching_vs_plain(9, field, region, n_occ, reps=3)
    meshes = mesh_vs_plain(9, field, region, origin, n_occ, TILED_LEVELS,
                           reps=3)
    # the binning, field and seam kernels against their plain versions at
    # this dispatch's shapes
    min_s, max_s = SUB, TILED_LEVELS + SUB - 1
    tpa = 1 << (max_s - 3)
    bins = binning_vs_plain(9, sp, va, origin, min_s, max_s, reps=3)
    binned = binning.bin_splats(sp, va, origin, min_s, max_s)
    starts, lens = binning.tile_segments(binned.entry_keys, min_s, max_s, tpa)
    row = kernel_vs_plain(9, binned, starts, lens, origin, tpa,
                          cfg.fit_shape, bf, reps=3)
    field0 = mls_cuda.launch(binned.entry_data, starts, lens, origin, tpa,
                             cfg.fit_shape, bf)
    seams = seam_vs_plain(9, binned, starts, lens, origin, region, points,
                          tpa, cfg.fit_shape, bf, field0, reps=3)
    del binned, starts, lens, field0
    images = {}
    for tiled in (True, False):
        cm = marching.generate_codes(field, region, tiled=tiled)
        images[tiled] = (block.pack_codes(cm).cpu(), cm.num_tiles,
                         cm.num_cells)
    if not torch.equal(images[True][0], images[False][0]):
        raise AssertionError("tiled and dense codes images differ")
    ms = {name: cuda_ms(lambda t=tiled: marching.generate_codes(
        field, region, tiled=t)) for name, tiled in (("tiled", True),
                                                      ("dense", False))}
    res = {"corners": field.shape[0], "splats": b.num_splats,
           "cells": images[True][2], "candidate_tiles": images[True][1],
           "tiles": (field.shape[0] // 8) ** 3,
           "image_words": int(images[True][0].shape[0]),
           "tiled_ms": ms["tiled"], "dense_ms": ms["dense"],
           "kernel_launches": launches, "kernel_row": row}
    phase(9, f"tiled vs dense classification, densest 512^3 dispatch: "
             f"codes images bitwise equal; {json.dumps(res)}")
    res["seam_rows"] = seams
    res["binning_rows"] = bins
    res["marching_rows"] = marches
    res["mesh_rows"] = meshes
    return res


class _Recorder:
    """Host filter that keeps each block's global grid vertices."""

    def __init__(self):
        self.blocks = []

    def __call__(self, vertices, triangles):
        self.blocks.append(vertices.copy())
        return vertices, triangles


def phase10_device_filter(workdir) -> dict:
    rng = np.random.default_rng(8)
    splats = sphere_cloud([0.7, -0.3, 0.2], 3.0, 20000, 0.25, rng)
    cfg = ReconstructConfig(fit_grid=0.1, fit_smooth=1.0, levels=4,
                            subsampling=SUB, leaf_cells=8, readback="raw",
                            progress=False)
    scale, bias = 2.0, (1.5, -2.0, 0.25)
    chain = mesh_filter.DeviceFilterChain(
        [mesh_filter.DeviceScaleBias(scale=scale, bias=bias)])
    out, launches = {}, dict.fromkeys(KERNELS, 0)
    for name, dfilter in (("plain", None), ("filtered", chain)):
        rec = _Recorder()
        path = os.path.join(workdir, f"{name}.ply")
        reg = get_registry()
        reg.clear()
        reset_launches()
        port_rec.reconstruct(SequenceSource(splats), cfg, path, device="cuda",
                             filters=rec, device_filter=dfilter)
        got = check_launches(name, read_launches(), len(rec.blocks),
                             reg.counter("bucket.skeletonBlocks").get(),
                             codes_blocks(reg), mesh_blocks(reg))
        launches = {k: launches[k] + got[k] for k in KERNELS}
        verts, tris = ply.read_mesh(path)
        out[name] = (verts, tris, rec.blocks)
    (v1, t1, b1), (v2, t2, b2) = out["plain"], out["filtered"]
    if not np.array_equal(t1, t2) or len(b1) != len(b2) or len(b1) < 2:
        raise AssertionError("filtered run has another topology")
    err = max(float(np.abs(g2 - (scale * g1.astype(np.float64)
                                 + np.asarray(bias))).max(initial=0.0))
              for g1, g2 in zip(b1, b2))
    if err > 1e-5:
        raise AssertionError(f"filtered vertices off by {err} cells")
    rep = check_manifold(v2, t2)
    if not rep.is_manifold:
        raise AssertionError(f"filtered output not manifold: {rep.reason}")
    res = {"blocks": len(b1), "vertices": len(v2), "triangles": len(t2),
           "boundary_edges": rep.num_boundary_edges,
           "max_err_cells": err, "kernel_launches": launches}
    phase(10, f"DeviceScaleBias(scale={scale}, bias={bias}): "
              f"{json.dumps(res)}: OK")
    return res


_PAIR_LOG = re.compile(
    r"^pair .*: (\d+) on-plane verts, .*?(OK|(\d+) CRACKS)$")


def verify_output(n: int, base: str, sample: int = 10) -> dict:
    """tools/verify_chunks on the chunk files of `base`. Raises unless every
    sampled chunk is manifold, continuity really ran (checked > 0: verify
    alone says ok when it compared nothing), every mismatched pair is a
    pair of near-twin cracks, those stay under TWIN_PPM_MAX of the
    on-plane vertices compared (none), and verify says ok. Returns verify's
    dict with `twins` and `on_plane` added."""
    on_plane, twins, cracked_pairs = 0, 0, 0

    def log(line: str) -> None:
        nonlocal on_plane, twins, cracked_pairs
        m = _PAIR_LOG.match(line)
        if m:
            on_plane += int(m.group(1))
            if m.group(3):
                twins += int(m.group(3))
                cracked_pairs += 1

    res = verify_chunks.verify(base, sample=sample, log=log)
    cont = res.get("continuity", {})
    res.update(twins=twins, on_plane=on_plane)
    if res["manifold"]["failures"] or not res["manifold"]["sampled"]:
        raise AssertionError(f"phase {n}: chunks not manifold: {res}")
    if not cont.get("checked"):
        raise AssertionError(f"phase {n}: continuity compared nothing: {res}")
    if cont["mismatched_pairs"] != cracked_pairs:
        raise AssertionError(f"phase {n}: a cut cross-section is missing "
                             f"from one side: {res}")
    if twins * 1e6 > TWIN_PPM_MAX * on_plane:
        raise AssertionError(f"phase {n}: {twins} near-twin cracks in "
                             f"{on_plane} on-plane vertices: {res}")
    if not res["ok"]:
        raise AssertionError(f"phase {n}: verify failed: {res}")
    return res


def chunk_counts(base: str) -> dict:
    """{chunk coords: (vertices, triangles)} from the headers of the chunk
    files of `base`."""
    out = {}
    for coords, path in verify_chunks.discover_chunks(base).items():
        with open(path, "rb") as f:
            h = ply.parse_header(f.read(65536), need_splat_fields=False)
        out[coords] = (h.vertex_count, h.triangle_count)
    return out


def chunk_digests(base: str) -> dict:
    """{chunk coords: sha256 of the chunk's vertex and triangle arrays}."""
    out = {}
    for coords, path in verify_chunks.discover_chunks(base).items():
        verts, tris = ply.read_mesh(path)
        out[coords] = hashlib.sha256(verts.tobytes()
                                     + tris.tobytes()).hexdigest()
    return out


def phase11_chunked(cloud_ply, workdir) -> dict:
    inp, spacing = cloud_ply
    base = os.path.join(workdir, "chunked.ply")
    reg = get_registry()
    reg.clear()
    reset_launches()
    t0 = time.monotonic()
    rc = cli.main([*bench_args(spacing), "--split-size", SPLIT_SIZE, "-o",
                   base, inp])
    seconds = time.monotonic() - t0
    launches = read_launches()
    blocks = reg.counter("bucket.count").get()
    if rc != 0:
        raise AssertionError(f"chunked run: rc {rc}")
    check_launches("chunked run", launches, blocks,
                   reg.counter("bucket.skeletonBlocks").get(),
                   codes_blocks(reg), mesh_blocks(reg))
    counts = chunk_counts(base)
    if len(counts) < 2:
        raise AssertionError(f"--split-size {SPLIT_SIZE}: {len(counts)} file")
    t1 = time.monotonic()
    res = verify_output(11, base, sample=3)
    out = {"seconds": seconds, "verify_seconds": time.monotonic() - t1,
           "files": len(counts), "blocks": blocks, "kernel_launches": launches,
           "vertices": sum(v for v, _ in counts.values()),
           "triangles": sum(t for _, t in counts.values()),
           "chunks": {"_".join(map(str, c)): vt
                      for c, vt in sorted(counts.items())},
           "continuity": res["continuity"], "twins": res["twins"],
           "on_plane": res["on_plane"], "counts": counts,
           "digests": chunk_digests(base)}
    for path in verify_chunks.discover_chunks(base).values():
        os.remove(path)
    phase(11, "chunked output verified: " + json.dumps(
        {k: v for k, v in out.items() if k not in ("digests", "counts")}))
    return out


# One rank of phase 12: the port's CLI, then one line with what this rank
# did (read before rank 0 merges every rank's statistics into its own).
_RANK = """
import json, sys
from mlsgpu_tpu_torch import cli
from mlsgpu_tpu_torch.ops import launches
from mlsgpu_tpu_torch.parallel import multihost
from mlsgpu_tpu_torch.utils.statistics import get_registry
own = {}
merge = multihost._merge_stats
def snapshot(transport):
    reg = get_registry()
    own.update(blocks=reg.counter("mesher.blocks").get(),
               codes=reg.counter("readback.mode.codes").get(),
               mesh=reg.counter("readback.mode.packed").get()
               + reg.counter("readback.mode.raw").get(),
               splats=reg.counter("distributed.rankSplats").get(),
               device_s=reg.to_dict().get("device.time", {}).get("sum", 0.0))
    return merge(transport)
multihost._merge_stats = snapshot
rc = cli.main(sys.argv[1:])
reg = get_registry().to_dict()
imb = reg.get("distributed.imbalance")
own.update(rc=rc, launches=launches.counts(),
           run_s=reg.get("run.time", {}).get("sum"),
           imbalance=imb["sum"] / imb["n"] if imb else None,
           forbidden=sorted(m for m in sys.modules if m.split(".")[0]
                            in ("jax", "jaxlib", "mlsgpu_tpu", "bench")))
print("RANK " + json.dumps(own), flush=True)
sys.exit(rc)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(n_ranks, args, env_extra=None, timeout=600):
    """n_ranks processes of the CLI on one coordinator port; per rank
    (returncode, the rank's own record or None, stderr tail), and the
    seconds until the last one ended. Every process is stopped on the way
    out; a port taken before rank 0 binds it is tried again."""
    env = dict(os.environ, PYTHONPATH=ROOT, MLSGPU_CONNECT_TIMEOUT="120")
    env.update(env_extra or {})
    for _ in range(3):
        port = _free_port()
        t0 = time.monotonic()
        procs = [subprocess.Popen(
            [sys.executable, "-c", _RANK, "--coordinator",
             f"127.0.0.1:{port}", "--num-processes", str(n_ranks),
             "--process-id", str(r), *args], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(n_ranks)]
        out = []
        try:
            for p in procs:
                so, se = p.communicate(
                    timeout=max(timeout - (time.monotonic() - t0), 1))
                rec = [ln[5:] for ln in so.splitlines()
                       if ln.startswith("RANK ")]
                out.append((p.returncode,
                            json.loads(rec[-1]) if rec else None, se[-3000:]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        seconds = time.monotonic() - t0
        if not any("cannot host the coordinator store" in e
                   for _, _, e in out):
            return out, seconds
    raise RuntimeError("no free coordinator port in three tries")


def phase12_two_ranks(cloud_ply, small_ply, workdir, single) -> dict:
    inp, spacing = cloud_ply
    base = os.path.join(workdir, "ranks.ply")
    args = [*bench_args(spacing), "--split-size", SPLIT_SIZE, "--device",
            "cuda", "--statistics", "-o", base, inp]
    # one cold process of the CLI, for a like-for-like wall time (phase 11
    # ran in this warm process); `run` seconds are the CLI's own, from its
    # start of work to its last file, without the interpreter's start-up
    t0 = time.monotonic()
    one = subprocess.run(
        [sys.executable, "-m", "mlsgpu_tpu_torch", *bench_args(spacing),
         "--split-size", SPLIT_SIZE, "-o",
         os.path.join(workdir, "one.ply"), inp],
        env=dict(os.environ, PYTHONPATH=ROOT), cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    one_s = time.monotonic() - t0
    if one.returncode != 0:
        raise AssertionError(f"one process: rc {one.returncode}: "
                             f"{one.stderr[-2000:]}")
    one_run = re.search(r"reconstructed \d+ file\(s\) in ([0-9.]+)s",
                        one.stderr)
    for path in verify_chunks.discover_chunks(
            os.path.join(workdir, "one.ply")).values():
        os.remove(path)

    ranks, two_s = run_ranks(2, args)
    for r, (rc, rec, err) in enumerate(ranks):
        if rc != 0 or rec is None:
            raise AssertionError(f"rank {r}: rc {rc}: {err}")
        if rec["forbidden"]:
            raise AssertionError(f"rank {r} imported {rec['forbidden']}")
        # every bucket of the 2M cloud has skeleton points
        check_launches(f"rank {r}", rec["launches"], rec["blocks"],
                       rec["blocks"], rec["codes"], rec["mesh"])
    if sum(rec["blocks"] for _, rec, _ in ranks) != single["blocks"]:
        raise AssertionError(f"ranks ran {[r[1]['blocks'] for r in ranks]} "
                             f"blocks of {single['blocks']}")
    # The ranks' files hold phase 11's meshes bit for bit, so what phase 11
    # verified (manifold chunks, continuity, its twin count) holds for them.
    counts = chunk_counts(base)
    if counts != single["counts"] or chunk_digests(base) != single["digests"]:
        raise AssertionError(f"two ranks wrote {counts}, one process "
                             f"{single['counts']} (or other bytes)")
    for path in verify_chunks.discover_chunks(base).values():
        os.remove(path)

    # a rank that dies must end the job: bounded, and not with exit code 0
    # (on the small cloud: the survivor runs every chunk alone first)
    dead, dead_s = run_ranks(
        2, [*bench_args(small_ply[1]), "--split-size", "4M", "--device",
            "cuda", "-o", os.path.join(workdir, "dead.ply"), small_ply[0]],
        env_extra={"MLSGPU_TEST_DIE_RANK": "1", "MLSGPU_HB_TIMEOUT": "10"},
        timeout=DEAD_RANK_BOUND_S + 30)
    if dead[1][0] != 7 or dead[0][0] in (0, None) or \
            dead_s > DEAD_RANK_BOUND_S:
        raise AssertionError(f"dead rank: exit codes {[d[0] for d in dead]} "
                             f"after {dead_s:.1f} s: {dead[0][2]}")
    out = {"one_process_seconds": one_s, "two_ranks_seconds": two_s,
           "one_process_run_seconds": float(one_run.group(1)) if one_run
           else None,
           "rank_run_seconds": [rec["run_s"] for _, rec, _ in ranks],
           "in_process_seconds": single["seconds"],
           "rank_splats": [rec["splats"] for _, rec, _ in ranks],
           "rank_blocks": [rec["blocks"] for _, rec, _ in ranks],
           "rank_launches": [rec["launches"] for _, rec, _ in ranks],
           "rank_device_s": [rec["device_s"] for _, rec, _ in ranks],
           "imbalance": ranks[0][1]["imbalance"],
           "files": len(counts), "files_bitwise_phase_11": True,
           "dead_rank": {"exit_codes": [d[0] for d in dead],
                         "seconds": dead_s}}
    phase(12, "two ranks on one card: " + json.dumps(out))
    return out


def reset_peak_rss() -> bool:
    """Restart the kernel's record of this process's peak resident set
    (Linux: "5" into /proc/self/clear_refs), so that a later reading is the
    peak since now; False where that is not allowed."""
    try:
        with open("/proc/self/clear_refs", "w") as f:
            f.write("5")
        return True
    except OSError:
        return False


def phase13_out_of_core(workdir) -> dict:
    budgets = {"--mem-blobs": "1M", "--mem-load-splats": "128M",
               "--mem-host-splats": "256M", "--mem-mesh": "64M",
               "--mem-reorder": "64M"}
    base = os.path.join(workdir, "ooc", "out.ply")
    reg = get_registry()
    reg.clear()
    reset_launches()
    captured = io.StringIO()
    rss_before = bench_ooc.peak_rss_bytes()
    rss_reset = reset_peak_rss()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(captured):
        rc = bench_ooc.main(
            ["--splats", str(OOC_SPLATS), "--out", base, "--device", "cuda",
             "--split-size", "64M", "--rss-budget", "24G", "--verify", "0",
             *[x for kv in budgets.items() for x in kv]])
    seconds = time.monotonic() - t0
    launches = read_launches()
    res = json.loads(captured.getvalue().splitlines()[-1])
    stats = reg.to_dict()
    blocks = reg.counter("bucket.count").get()
    if rc != 0 or not res["rss_ok"]:
        raise AssertionError(f"bench_ooc: rc {rc}: {res}")
    check_launches("bench_ooc", launches, blocks,
                   reg.counter("bucket.skeletonBlocks").get(),
                   codes_blocks(reg), mesh_blocks(reg))
    spilled = {k: reg.counter(k).get()
               for k in ("blobs.spilled", "spill.flushBytes")}
    if not all(spilled.values()):
        raise AssertionError(f"nothing spilled: {spilled}")
    peaks = {}
    for name, opt in (("mem.loadQueue", "--mem-load-splats"),
                      ("mem.hostSplats", "--mem-host-splats"),
                      ("mem.meshWindow", "--mem-mesh")):
        peaks[name] = reg.peak(name).peak
        if not 0 < peaks[name] <= parse_capacity(budgets[opt]):
            raise AssertionError(f"{name} peak {peaks[name]} against "
                                 f"{opt} {budgets[opt]}")
    t1 = time.monotonic()
    ver = verify_output(13, base, sample=3)
    out = {"splats": OOC_SPLATS, "seconds": seconds,
           "elapsed_s": res["elapsed_s"],
           "msplats_per_s": res["msplats_per_s"],
           "peak_rss_gb": res["peak_rss_gb"],
           # whether the peak is this phase's own, or the process's so far
           "peak_rss_reset": rss_reset,
           "peak_rss_before_gb": round(rss_before / 1e9, 2),
           "files": res["output_files"],
           "blocks": blocks, "kernel_launches": launches, **spilled,
           "peaks": peaks, "budgets": budgets,
           "pass0_s": stats["pass0.time"]["sum"],
           "pass1_s": stats["pass1.time"]["sum"],
           "device_s": stats["device.time"]["sum"],
           "verify_seconds": time.monotonic() - t1,
           "continuity": ver["continuity"], "twins": ver["twins"],
           "on_plane": ver["on_plane"]}
    shutil.rmtree(os.path.dirname(base))
    phase(13, "out of core: " + json.dumps(out))
    return out


def _worker_stats(stats: dict) -> dict:
    """{worker: (blocks, seconds of its block steps)} from a run's
    statistics (`device.blocks.<card>.<queue>`, `device.workerTime...`)."""
    return {k[len("device.blocks."):]:
            (v["total"],
             stats.get("device.workerTime." + k[len("device.blocks."):],
                       {}).get("sum", 0.0))
            for k, v in sorted(stats.items())
            if k.startswith("device.blocks.")}


def smi_used_mib(index: int = 0) -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,"
         "nounits", "-i", str(index)], capture_output=True, text=True,
        check=True).stdout.strip())


def worker_context(n: int = 2) -> dict:
    """Device memory of `n` idle worker processes on card 0, each with its
    CUDA context and the kernel library loaded (ready for a block), per
    process: the drop of the card's free memory (torch.cuda.mem_get_info)
    and the rise of nvidia-smi's used memory."""
    dev = torch.device("cuda", 0)
    torch.cuda.synchronize()
    free0, used0 = torch.cuda.mem_get_info(dev)[0], smi_used_mib()
    procs = workers_mod.start_workers([(dev, 0, q) for q in range(n)],
                                      block.block_step, {}, True)
    try:
        cancel = threading.Event()
        for p in procs:
            if not p.wait_ready(cancel):
                raise AssertionError(f"{p.name} did not start")
        time.sleep(1.0)
        free1, used1 = torch.cuda.mem_get_info(dev)[0], smi_used_mib()
    finally:
        workers_mod.stop_workers(procs)
    out = {"processes": n,
           "bytes_per_process_mem_get_info": (free0 - free1) / n,
           "mib_per_process_nvidia_smi": (used1 - used0) / n,
           "estimate_bytes": workers_mod.WORKER_CONTEXT_BYTES}
    if out["bytes_per_process_mem_get_info"] > out["estimate_bytes"]:
        raise AssertionError(f"a worker process holds more than "
                             f"WORKER_CONTEXT_BYTES: {out}")
    return out


def _queue_runs(cloud, runs, digest=None) -> dict:
    """`runs` = [(name, CLI options, workers)], each as users run it: a
    `python -m mlsgpu_tpu_torch --statistics` process of its own on
    `cloud` (tools/bench_queues.run_cli), its statistics read back from its
    output. Each mesh's digest is `digest` (the first run's when None),
    launches equal blocks (the skeleton kernel's the blocks with skeleton
    points, the emit kernel's at most the blocks, at least one), every
    worker ran a block, more than one worker
    are as many processes, and no process of the run outlives it. Returns
    each run's numbers by name."""
    out = {}
    for name, extra, workers in runs:
        res = bench_queues.run_cli(ROOT, cloud[0], cloud[1], extra)
        digest = digest or res["digest"]
        if res["digest"] != digest:
            raise AssertionError(f"{name}: the mesh differs from the "
                                 "reference run's")
        need = dict.fromkeys(KERNELS, res["blocks"])
        need["seam_skeleton"] = res["skeleton_blocks"]
        # the sort's pass kernel once a digit
        need["bin_sort_pass"] = res["blocks"] * len(binning.sort_digits(
            SUB, LEVELS + SUB - 1))
        # a block without an occupied cell has no emit launch; a codes
        # run launches no mesh kernel
        need["march_emit"] = res["launches"]["march_emit"]
        need.update(dict.fromkeys(MESH, 0))
        if res["launches"] != need or \
                not 0 < need["march_emit"] <= res["blocks"]:
            raise AssertionError(
                f"{name}: launches {res['launches']}, {res['blocks']} "
                f"blocks, {res['skeleton_blocks']} with skeleton points")
        per_worker = res["workers"]
        if len(per_worker) != workers or \
                not all(n > 0 for n in per_worker.values()) or \
                sum(per_worker.values()) != res["blocks"]:
            raise AssertionError(f"{name}: blocks per worker {per_worker}")
        if res["spawned"] != (workers if workers > 1 else 0):
            raise AssertionError(f"{name}: {res['spawned']} worker "
                                 f"processes for {workers} worker(s)")
        if res["left_running"]:
            raise AssertionError(f"{name}: processes of the run left "
                                 f"running: {res['left_running']}")
        if res["pace"]["decode_threads"] != streamer.decode_threads(workers):
            raise AssertionError(f"{name}: {res['pace']['decode_threads']} "
                                 f"decode threads for {workers} worker(s)")
        out[name] = dict(res, seconds=res["wall_s"],
                         digest_is_reference=True)
        del out[name]["digest"]
        phase(14, f"{name} ({' '.join(extra)}): {json.dumps(out[name])}")
    return out


def _ratios(out: dict, key: str) -> dict:
    first = next(iter(out.values()))[key]
    return {k: v[key] / first for k, v in out.items()}


def phase14_queues_and_cards(bench, codes, two_ranks) -> dict:
    """`bench`: the 2M cloud (PLY path, grid spacing); `codes`: phase 5's
    result (the digest every 2M run must repeat); `two_ranks`: phase 12's
    (its two-process ratio is printed beside), or None when phase 12 did
    not run. Then one and two queues (and every card) at BIG_SPLATS, where
    a run is long enough for the workers' start to be paid back."""
    cards = torch.cuda.device_count()
    context = worker_context()
    phase(14, f"idle worker process on the card: {json.dumps(context)}")
    # the codes readback, as phase 5's run whose digest each must repeat
    one_card = ["--readback", "codes", "--device", "cuda:0",
                "--device-threads"]
    every_card = [(f"{cards} cards", ["--readback", "codes", "--device",
                                      "cuda", "--num-devices", "0"],
                   cards)] if cards > 1 else []
    out = _queue_runs(bench, [("1 queue", [*one_card, "1"], 1),
                              ("2 queues", [*one_card, "2"], 2),
                              ("4 queues", [*one_card, "4"], 4),
                              *every_card], codes["digest"])
    splats, sr = cloud.make_cloud(BIG_SPLATS)
    big_ply = os.path.join(os.path.dirname(bench[0]), "big_cloud.ply")
    ply.write_splats_ply(big_ply, splats)
    del splats
    big = _queue_runs((big_ply, cloud.bench_config(sr, LEVELS).fit_grid),
                      [("1 queue", [*one_card, "1"], 1),
                       ("2 queues", [*one_card, "2"], 2), *every_card])
    os.remove(big_ply)
    # more cards than are visible: an option error, never a run on fewer
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main([*bench_args(bench[1]), "--num-devices", str(cards + 1),
                       "-o", os.path.join(os.path.dirname(bench[0]),
                                          "never.ply"), bench[0]])
    if rc == 0 or f"only {cards} card(s) visible" not in err.getvalue():
        raise AssertionError(f"--num-devices {cards + 1} on {cards} card(s): "
                             f"rc {rc}: {err.getvalue()[-500:]}")
    summary = {
        "cards_visible": cards,
        "kernel_launches": {k: sum(v["launches"][k] for v in
                                   [*out.values(), *big.values()])
                            for k in KERNELS},
        "start": {k: v["start"] for k, v in out.items()},
        f"start_{BIG_SPLATS}": {k: v["start"] for k, v in big.items()},
        "per_block": {k: v["per_block"] for k, v in out.items()},
        # what paces pass 1: the mesher thread's busy and the producer's
        # wait shares, the workers' slot wait, the decode stage's threads
        "pace": {k: v["pace"] for k, v in out.items()},
        f"pace_{BIG_SPLATS}": {k: v["pace"] for k, v in big.items()},
        f"per_block_{BIG_SPLATS}": {k: v["per_block"]
                                    for k, v in big.items()},
        "phase5_seconds": codes["seconds"], "phase5_pass1_s": codes["pass1_s"],
        "phase5_device_s": codes["device_s"],
        "wall_ratio_to_1_queue": _ratios(out, "seconds"),
        "pass1_ratio_to_1_queue": _ratios(out, "pass1_s"),
        "run_ratio_to_1_queue": _ratios(out, "run_s"),
        f"{BIG_SPLATS}_wall_ratio_to_1_queue": _ratios(big, "seconds"),
        f"{BIG_SPLATS}_pass1_ratio_to_1_queue": _ratios(big, "pass1_s"),
        "processes_spawned": {k: v["spawned"] for k, v in out.items()},
        "ready_wait_s": {k: v["ready_wait_s"] for k, v in out.items()},
        "worker_context": context,
        "two_processes_wall_ratio": (
            two_ranks["two_ranks_seconds"] / two_ranks["one_process_seconds"]
            if two_ranks else None),
        "two_processes_run_ratio": (
            max(two_ranks["rank_run_seconds"])
            / two_ranks["one_process_run_seconds"]
            if two_ranks and two_ranks["one_process_run_seconds"] else None),
        "too_many_cards_rc": rc}
    phase(14, f"queues and cards: {json.dumps(summary)}: OK")
    return {"runs": out, f"runs_{BIG_SPLATS}": big, **summary}


def phase15_sharded(pts, src, info, densest, dev) -> dict:
    """`pts`: the 2M bench cloud; `densest`: its densest bucket."""
    cards = torch.cuda.device_count()
    meshes = [[dev, dev]]
    if cards > 1:
        meshes.append([torch.device("cuda", 0), torch.device("cuda", 1)])
    # two seam-adjacent blocks of phase 4's cloud (x = 28: misaligned)
    b, plane = 1 << (3 + 3 - 1), 28
    splats = sphere_cloud([plane, 14.0, 14.0], 9.0, 6000, 1.2,
                          np.random.default_rng(42))
    regions = [(plane, b - 1, b - 1), (b - 1, b - 1, b - 1)]
    origins = [(0, 0, 0), (plane, 0, 0)]
    stacked = np.stack([splats, splats])
    valid = np.ones(stacked.shape[:2], bool)
    kw = dict(levels=3, subsampling=3)
    alone = [block.block_step(
        torch.as_tensor(splats, device=dev),
        torch.ones(len(splats), dtype=torch.bool, device=dev),
        regions[i], origins[i], 0.0, readback="codes", **kw)
        for i in range(2)]
    fields_alone = [_seam_block(splats, origins[i],
                                np.add(origins[i], regions[i]), dev)
                    for i in range(2)]
    launches, corners = dict.fromkeys(KERNELS, 0), 0
    for mesh in meshes:
        reset_launches()
        got = sharded.data_parallel_block_step(
            mesh, stacked, valid, regions, origins, 0.0, readback="codes",
            **kw)
        step = read_launches()
        if step != dict(dict.fromkeys(KERNELS, 2), seam_skeleton=0,
                        bin_sort_pass=2 * len(binning.sort_digits(3, 5)),
                        **dict.fromkeys(MESH, 0)):
            raise AssertionError(f"sharded step: {step} launches")
        launches = {k: launches[k] + step[k] for k in KERNELS}
        for i, (res, ref) in enumerate(zip(got, alone)):
            if res.packed.device != mesh[i] or res.num_cells < 100 or \
                    not np.array_equal(res.counts, ref.counts) or \
                    not torch.equal(res.packed.cpu(), ref.packed.cpu()):
                raise AssertionError(f"sharded block {i} over {mesh} is not "
                                     "the block step's alone")
        # the two fields, computed at the same time on two streams
        fields = sharded.run_per_entry(mesh, lambda i, d: block.block_field(
            torch.as_tensor(splats, device=d),
            torch.ones(len(splats), dtype=torch.bool, device=d),
            regions[i], origins[i], 0.0, None, **kw)[0])
        fa, fb = (f.cpu().numpy() for f in fields)
        corners += _bitwise_equal(fa[:, :, plane], fb[:, :, 0], 100,
                                  f"face x={plane} over {mesh}")
        for i, f in enumerate((fa, fb)):
            _bitwise_equal(f, fields_alone[i], 1000,
                           f"block {i} over {mesh} against one stream")

    # the kernel on a non-default stream, while the default stream sleeps
    grid_form, bvalid = load_bucket(src, info, densest)
    min_s, max_s = SUB, LEVELS + SUB - 1
    tpa = 1 << (max_s - 3)
    origin = tuple(int(v) for v in densest.cell_lo)
    binned = binning.bin_splats(torch.as_tensor(grid_form, device=dev),
                                torch.as_tensor(bvalid, device=dev),
                                origin, min_s, max_s)
    starts, lens = binning.tile_segments(binned.entry_keys, min_s, max_s, tpa)
    args = (binned.entry_data, starts, lens, origin, tpa, "sphere", 0.0)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(dev)
    torch.cuda._sleep(200 * SLEEP_CYCLES)   # ~0.4 s on the default stream
    asleep = torch.cuda.Event()
    asleep.record()
    with torch.cuda.stream(side):
        got = mls_cuda.launch(*args)
        got_host = got.cpu()                # on `side`; returns when done
    if asleep.query():
        raise AssertionError("the default stream's sleep ended before the "
                             "side stream's kernel: cannot tell the streams "
                             "apart")
    torch.cuda.synchronize()
    ref = mls.eval_field(*args)
    summary = kernel_gate.compare_fields(ref, got_host.to(dev))
    kernel_gate.check(summary, min_defined=10_000)
    del got, ref, binned, starts, lens

    # distributed_cell_bounds on the bench cloud, split over the mesh
    bounds = {}
    for mesh in meshes:
        d = len(mesh)
        n = len(pts) // d
        pos = pts[:n * d, 0:3].reshape(d, n, 3)
        rad = pts[:n * d, 3].reshape(d, n)
        ok = np.ones((d, n), bool)
        ok[:, ::7] = False
        lo, hi, cnt = sharded.distributed_cell_bounds(mesh, pos, rad, ok)
        sel = ok.reshape(-1)
        p, r = pos.reshape(-1, 3)[sel], rad.reshape(-1)[sel][:, None]
        np.testing.assert_allclose(lo.cpu().numpy(), (p - r).min(0),
                                   rtol=1e-6)
        np.testing.assert_allclose(hi.cpu().numpy(), (p + r).max(0),
                                   rtol=1e-6)
        if int(cnt) != int(sel.sum()) or lo.device != mesh[0]:
            raise AssertionError(f"cell bounds over {mesh}: count {int(cnt)}")
        bounds[str(mesh)] = int(cnt)
    res = {"cards_visible": cards, "meshes": [str(m) for m in meshes],
           "kernel_launches": launches, "shared_corners_bitwise": corners,
           "side_stream_agreement": summary["pattern_agreement"],
           "side_stream_max_abs_err": summary["max_abs_err"],
           "cell_bounds_counts": bounds}
    phase(15, f"sharded calls on the card: {json.dumps(res)}: OK")
    return res


def phase16_tools() -> dict:
    """The measuring tools in process, their lines printed as they are."""
    seconds = {}
    for tool, argv in ((bench_d2h, ["--reps", "5"]),
                       (bench_micro, ["--reps", "3"]),
                       (bench_micro2, ["--reps", "3"])):
        name = tool.__name__.rsplit(".", 1)[-1]
        captured = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(captured):
            rc = tool.main(argv)
        seconds[name] = time.monotonic() - t0
        lines = captured.getvalue().splitlines()
        if rc != 0 or len(lines) < 8:
            raise AssertionError(f"tools/{name}: rc {rc}, {len(lines)} lines")
        for line in lines:
            json.loads(line)
            phase(16, f"{name} {line}")
    phase(16, f"tools ran: {json.dumps(seconds)}: OK")
    return seconds


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--through", type=int, default=16,
                   help="run phases 1..N (6, the jax check, runs last) "
                        "[%(default)s]")
    p.add_argument("--only", default=None, metavar="N,M,...",
                   help="run phases 1-2, these and what they need (7 for "
                        "8, 11 for 12, 5 for 14): a several-card call runs "
                        "the phases that need its cards alone")
    args = p.parse_args(argv)
    only = asked = None
    if args.only:
        only = {int(n) for n in args.only.split(",")}
        asked = set(only)
        for later, first in ((8, 7), (12, 11), (14, 5)):
            if later in only:
                only.add(first)

    def want(n: int) -> bool:
        return n in only if only else args.through >= n

    check_isolated("the imports")
    phase1_toolchain()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    set_precision()
    phase2_build()
    check_isolated("phase 2")
    if not only and args.through < 3:
        return 0
    splats, spacing, cfg = bench_setup()
    src = SequenceSource(splats)
    info, _, densest = cloud.densest_bucket(src, cfg)
    launches, rows, seams, bins, marches, meshes = [], [], [], [], [], []
    if want(3):
        rows, seams, bins, marches, meshes = phase3_kernel_vs_plain(
            src, info, densest, dev)
        check_isolated("phase 3")
    if want(4):
        seams += phase4_seams(dev)
        check_isolated("phase 4")
    with tempfile.TemporaryDirectory(prefix="chip_smoke.") as workdir:
        if want(13):
            launches.append(
                phase13_out_of_core(workdir)["kernel_launches"])
            check_isolated("phase 13")
        inp = os.path.join(workdir, "bench_cloud.ply")
        ply.write_splats_ply(inp, splats)
        bench_cloud = (inp, spacing)
        ranks = None
        if want(5):
            codes = phase5_end_to_end(bench_cloud, info)
            check_isolated("phase 5")
            launches.append(codes["kernel_launches"])
            if not asked or 5 in asked:   # not when 14 alone needs it
                launches += [r["kernel_launches"] for r in
                             phase5_mesh_readbacks(bench_cloud,
                                                   codes).values()]
                check_isolated("phase 5")
        if want(7) or want(8) or want(12):
            small, small_sr = cloud.make_cloud(N_SMALL)
            small_ply = os.path.join(workdir, "small_cloud.ply")
            ply.write_splats_ply(small_ply, small)
            small_cloud = (small_ply, float(small_sr / 3.0))
            del small
        if want(7):
            plain = phase7_readbacks(small_cloud)
            check_isolated("phase 7")
            launches += [plain[m]["kernel_launches"]
                         for m in ("codes", "packed", "raw")]
        if want(8):
            launches += [r["kernel_launches"] for r in
                         phase8_statistics_device(small_cloud, plain)]
            check_isolated("phase 8")
        if want(9):
            tiled = phase9_tiled_vs_dense(splats, spacing, dev)
            check_isolated("phase 9")
            launches.append(tiled["kernel_launches"])
            rows.append(tiled["kernel_row"])
            seams += tiled["seam_rows"]
            bins += tiled["binning_rows"]
            marches += tiled["marching_rows"]
            meshes += tiled["mesh_rows"]
        if want(10):
            launches.append(phase10_device_filter(workdir)["kernel_launches"])
            check_isolated("phase 10")
        if want(11):
            chunked = phase11_chunked(bench_cloud, workdir)
            check_isolated("phase 11")
            launches.append(chunked["kernel_launches"])
        if want(12):
            ranks = phase12_two_ranks(bench_cloud, small_cloud, workdir,
                                      chunked)
            check_isolated("phase 12")
        if want(14):
            launches.append(phase14_queues_and_cards(
                bench_cloud, codes, ranks)["kernel_launches"])
            check_isolated("phase 14")
        if want(15):
            launches.append(phase15_sharded(
                splats, src, info, densest, dev)["kernel_launches"])
            check_isolated("phase 15")
        if want(16):
            phase16_tools()
            check_isolated("phase 16")
    check_isolated("every phase")
    phase(6, "neither jax, mlsgpu_tpu nor bench in sys.modules after any "
             "phase: OK")
    left = {pid: _cmdline(pid) for pid in misc.child_pids()}
    if left:
        raise AssertionError(f"processes left running: {left}")
    phase(6, "no process started by this one is left: OK")

    if rows:  # no kernel record from --only without phase 3
        print_kernel_record(rows, seams, bins, marches, meshes, launches)
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def print_kernel_record(rows, seams, bins, marches, meshes,
                        launches) -> None:
    """The kernel record: each kernel's launches summed over the main-path
    runs of this process, its largest error against its plain version, and
    its times and bound at the densest 256^3 bucket (phase 3) on the
    default path (sphere fit, boundary factor 0)."""
    main_row = rows[0]
    total = {k: sum(run[k] for run in launches) for k in KERNELS}
    record = [{
        "name": "mls_field", "route": "cuda",
        "source": "mlsgpu_tpu_torch/csrc/mls_field.cu",
        "replaces": "mlsgpu_tpu/ops/mls_pallas.py:43",
        "launches": total["mls_field"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["host_paced_ms"],
        "device_ms": main_row["device_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound"]["bound_ms"],
        "bound_by": main_row["bound"]["bound_by"],
        # no single PyTorch call computes the field
        "library_ms": None}]
    for name, replaces in (("seam_face", "mlsgpu_tpu/ops/mls.py:188"),
                           ("seam_skeleton", "mlsgpu_tpu/ops/mls.py:492")):
        mine = [r for r in seams if r["name"] == name]
        if not mine:
            continue
        timed = next(r for r in mine if "host_paced_ms" in r)
        record.append({
            "name": name, "route": "cuda",
            "source": "mlsgpu_tpu_torch/csrc/seam_moments.cu",
            "replaces": replaces, "launches": total[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            # the pass (preparation, kernel, fit, write) host-paced, on
            # the device alone, and the kernel alone
            "ms": timed["host_paced_ms"], "device_ms": timed["device_ms"],
            "kernel_ms": timed["kernel_ms"],
            "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound"]["bound_ms"],
            "bound_by": timed["bound"]["bound_by"],
            # no single PyTorch call computes the pass
            "library_ms": None})
    for name, _, replaces in BINNING_KERNELS:
        mine = [r for r in bins if r["name"] == name]
        if not mine:
            continue
        first = mine[0]   # phase 3's: the densest 256^3 bucket
        record.append({
            "name": name, "route": "cuda",
            "source": "mlsgpu_tpu_torch/csrc/binning.cu",
            "replaces": replaces, "launches": total[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            # the wrapper's call host-paced, on the device alone, and the
            # kernel alone; the bounds kernel has no call of its own (its
            # call is the segments'), so its ms is the kernel alone
            "ms": (first["kernel_ms"] if first["host_paced_ms"] is None
                   else first["host_paced_ms"]),
            "device_ms": first["device_ms"],
            "kernel_ms": first["kernel_ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound"]["bound_ms"],
            "bound_by": first["bound"]["bound_by"],
            # keys: no single PyTorch call computes them
            "library_ms": first["library_ms"]})
        if name.startswith("bin_sort"):
            # the sort whole, and the stage's traced launches and syncs
            record[-1]["sort"] = {k: first["sort"][k] for k in (
                "launches_a_call", "call_device_ms", "kernels_ms",
                "torch_sort_ms", "bound_ms", "share_of_bound")}
            record[-1]["stage_launches_syncs"] = {
                path: [t["launches"], t["sync_calls"]]
                for path, t in first["stage"].items()}
    for name, _, replaces in MARCHING_KERNELS:
        mine = [r for r in marches if r["name"] == name]
        if not mine:
            continue
        first = mine[0]   # phase 3's: the densest 256^3 bucket
        record.append({
            "name": name, "route": "cuda",
            "source": "mlsgpu_tpu_torch/csrc/marching.cu",
            "replaces": replaces, "launches": total[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            # the kernel alone (profiler), or its C call on the device
            # (classify and scan together) where the trace lost its
            # events; the whole call (classify, scan, the totals' copy and
            # sync, emit) host-paced and the card's busy time in it
            "ms": (first["call_device_ms"] if first["kernel_ms"] is None
                   else first["kernel_ms"]),
            "kernel_ms": first["kernel_ms"],
            "call_device_ms": first["call_device_ms"],
            "call_ms": first["host_paced_ms"],
            "device_ms": first["device_ms"],
            # the plain stage (generate_codes + pack_codes)
            "plain_ms": first["plain_ms"],
            "bound_ms": first["bound"]["bound_ms"],
            "bound_by": first["bound"]["bound_by"],
            # no single PyTorch call computes them
            "library_ms": None})
    for name, _, replaces in MESH_KERNELS:
        mine = [r for r in meshes if r["name"] == name]
        if not mine:
            continue
        first = mine[0]   # phase 3's: the densest 256^3 bucket
        record.append({
            "name": name, "route": "cuda",
            "source": ("mlsgpu_tpu_torch/csrc/marching.cu"
                       if name == "march_emit_mesh"
                       else "mlsgpu_tpu_torch/csrc/mesh.cu"),
            "replaces": replaces, "launches": total[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            # the kernel alone (profiler; the pass kernel's over its
            # passes), or the packed stage on the card where the trace
            # lost its events; the whole stage (classify to pack, its two
            # syncs) host-paced and the card's busy time in it
            "ms": (first["device_ms"] if first["kernel_ms"] is None
                   else first["kernel_ms"]),
            "kernel_ms": first["kernel_ms"],
            "call_ms": first["host_paced_ms"],
            "device_ms": first["device_ms"],
            # the plain chain (generate_mesh, weld, pack_readback)
            "plain_ms": first["plain_ms"],
            "bound_ms": first["bound"]["bound_ms"],
            "bound_by": first["bound"]["bound_by"],
            # the weld's kernels: torch.unique(sorted=True,
            # return_inverse=True) of the compact keys (torch.sort's in
            # the stage record); no single call emits or packs
            "library_ms": first["library_ms"],
            "stage_launches_syncs": {
                path: [t["launches"], t["sync_calls"]]
                for path, t in first["stage"]["traced"].items()}})
        if name.startswith("weld"):
            # the weld's kernels together against the weld whole's bound
            whole = first["stage"]["weld"]
            record[-1]["weld"] = {
                "kernels_ms": whole["kernels_ms"],
                "bound_ms": whole["bound"]["bound_ms"],
                "share_of_bound": whole["share_of_bound"]}
    print(json.dumps({"kernels": record}))


if __name__ == "__main__":
    sys.exit(main())
