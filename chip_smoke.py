"""On-card smoke run of the PyTorch/CUDA port (mlsgpu_tpu_torch).

    python3 chip_smoke.py            # all phases, one CUDA device
    python3 chip_smoke.py --through 3  # stop after phase 3 (quick kernel check)
    python3 chip_smoke.py --through 12 # skip the out-of-core phase and 14-16
    python3 chip_smoke.py --only 14    # phases 1-2, 14 and 5 (its digest)

Phases, each printing one line of findings (phase 6 runs last); any failure
raises, exits non-zero and prints no result line:
  1. toolchain and card (torch, CUDA, nvcc, triton, nvidia-smi);
  2. build the MLS field kernel from mlsgpu_tpu_torch/csrc with nvcc (sm_90a);
  3. kernel vs its plain PyTorch version on the card at main-path shapes
     (the densest 256^3-corner bucket of the 2M-splat bench cloud), sphere
     and plane fits, two boundary factors; NaN-pattern agreement > 0.9995 and
     |kernel - plain| < 1e-3 where both are defined; CUDA-event times of
     the call (the tile order kernels and the field kernel) host-paced and
     on the device alone, of the order kernels alone and of their plain
     version, and of the field kernel alone from a profiler trace; the
     bound on these inputs (kernel_bound) and the call's share of it;
     then on the same bucket the seam kernels (csrc/seam_moments.cu: the
     face kernel, and the skeleton kernel at the bucket's skeleton points)
     against their plain versions, sphere and plane fits (seam_vs_plain):
     moments and hits value for value and the pass's field equal, with
     the default candidate buffer and with SMALL_BUFFER (many rounds a
     row); the pass host-paced and on the device alone, the kernel alone
     (profiler) at both buffers, the plain pass at 32 rows (64 points) a
     chunk, the bound (seam_bound), and the launches and host syncs of a
     pass and of the plain one (a traced pass summarized by
     utils/step_profile);
  4. the seam contract on the card, through the seam kernels: shared-face
     and T-junction corners of adjacent blocks bitwise equal, also where a
     face patch straddles the blocks' in-plane edge; both seam kernels
     against their plain versions on the three T-junction blocks;
  5. end to end through `mlsgpu_tpu_torch.cli.main` on the 2M-splat bench
     cloud (tools/cloud.py make_cloud) written as a PLY: manifold output,
     kernel launches >= blocks;
  7. on the 250k-splat bench cloud, `--readback codes`, `packed` and `raw`:
     packed and raw give the codes run's vertex, triangle and boundary-edge
     counts, manifold; the seconds of all three modes;
  8. `--statistics-device` on that cloud (codes, then packed): the mesh
     bitwise phase 7's, and every `device.<stage>.time`;
  9. on the densest 512^3-corner dispatch (`--levels 7`, 64^3 tiles, 7
     levels): the kernel against its plain version as in phase 3 (sphere
     fit, the run's boundary factor), the seam kernels as in phase 3, the
     block's field (one launch of each kernel), then tiled against dense
     classification of the block's field: the codes images bitwise equal;
     all four times;
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
     (every card, a worker process each): each mesh's digest is phase 5's
     (the vertex and triangle arrays phase 5 checked manifold), 50 kernel
     launches (counted in the worker processes and carried to the run's
     `mls.launches`), every worker's block counter above 0, one process
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
Kernel launches (the field, face and skeleton kernels') are counted per
main-path run (every counter set to 0 just before it and read just after;
the comparisons of phases 3, 4 and 9 excluded); each run must launch the
field and face kernels once a block and the skeleton kernel where its
blocks have skeleton points (check_launches), and a kernel record's
`launches` is the sum over the runs in this process (phase 12's ranks
count their own and print them); its `max_abs_err` is the largest of
phases 3 (and 4) and 9; its `ms` is the call's (for a seam kernel, the
pass's) host-paced time at the densest 256^3 bucket, `device_ms` on the
device alone (and `kernel_ms` a seam kernel alone).
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
from mlsgpu_tpu_torch.ops import (binning, block, kernel_gate,  # noqa: E402
                                  marching, mls, mls_cuda, seam_cuda)
from mlsgpu_tpu_torch.pipeline import bucket as bucket_mod  # noqa: E402
from mlsgpu_tpu_torch.pipeline import mesh_filter  # noqa: E402
from mlsgpu_tpu_torch.parallel import sharded  # noqa: E402
from mlsgpu_tpu_torch.pipeline import reconstruct as port_rec  # noqa: E402
from mlsgpu_tpu_torch.pipeline import streamer  # noqa: E402
from mlsgpu_tpu_torch.pipeline.streamer import load_bucket  # noqa: E402
from mlsgpu_tpu_torch.pipeline import workers as workers_mod  # noqa: E402
from mlsgpu_tpu_torch.tools import (bench_d2h, bench_micro,  # noqa: E402
                                    bench_micro2, bench_ooc, bench_queues,
                                    cloud, verify_chunks)
from mlsgpu_tpu_torch.tools.bench_queues import bench_args  # noqa: E402
from mlsgpu_tpu_torch.utils import misc, step_profile  # noqa: E402
from mlsgpu_tpu_torch.utils.manifold import check_manifold  # noqa: E402
from mlsgpu_tpu_torch.utils.statistics import get_registry  # noqa: E402

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
PASS_SLEEP_CYCLES = 40_000_000  # ~20 ms: longer than the host enqueue of
#                                 a seam pass (~170 launches)
# The seam kernels' shrunken candidate buffer (their default is
# seam_cuda.max_buffer()), which also caps the terms a corner holds at
# once: most occupied face rows of the densest buckets then run several
# rounds and their densest corners several residue classes, so both paths
# run at main-path shapes.
SMALL_BUFFER = 16
# The kernels of the main path, in the order of the kernel record and of
# seam_cuda.launch_counts().
KERNELS = ("mls_field", "seam_face", "seam_skeleton")


def reset_launches() -> None:
    """Every kernel's launch count to 0, just before a main-path run."""
    mls_cuda.launches = 0
    seam_cuda.face_launches = 0
    seam_cuda.skeleton_launches = 0


def read_launches() -> dict:
    """Every kernel's launches since reset_launches, by KERNELS name."""
    return dict(zip(KERNELS, seam_cuda.launch_counts()))


def check_launches(name: str, got: dict, blocks: int,
                   skeleton_blocks: int) -> dict:
    """A main-path run of `blocks` blocks, `skeleton_blocks` of them with
    skeleton points, went through its kernels: the field and face kernels
    at least once per block (and at all), the skeleton kernel at least
    once per block with skeleton points."""
    need = {"mls_field": max(blocks, 1), "seam_face": max(blocks, 1),
            "seam_skeleton": skeleton_blocks}
    if any(got[k] < need[k] for k in KERNELS):
        raise AssertionError(f"{name}: launches {got} for {blocks} blocks")
    return got


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


def cuda_ms(fn, reps: int = REPS, device_only: bool = False,
            sleep_cycles: int = SLEEP_CYCLES) -> float:
    """Median CUDA-event time of fn() after one warm-up call. By default
    the events also see the host: work the card finishes faster than the
    host can queue it is timed at the host's pace. device_only: the card
    first sleeps `sleep_cycles` while the host queues fn's work, so the
    events time the device's work alone."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_device_ms(fn, name: str = "mls_field_kernel", reps: int = REPS):
    """Mean device time of the kernels whose name contains `name` over
    `reps` calls of fn, from a torch.profiler trace; None when the trace
    shows no device time for them."""
    import torch.profiler as tp
    fn()
    torch.cuda.synchronize()
    with tp.profile(activities=[tp.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if name in ev.key:
            total_us += ev.self_device_time_total
            count += ev.count
    return total_us / count / 1e3 if count and total_us > 0 else None


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
    phase(2, f"built {os.path.relpath(mls_cuda.library_path(), ROOT)} in "
             f"{time.monotonic() - t0:.2f}s (nvcc {mls_cuda.build_seconds:.2f}s); "
             f"ptxas: {' | '.join(ptxas)}")


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
    alone_ms = kernel_device_ms(call, reps=reps)
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


def seam_bound(work, per_listed: int, corners: int, items: int) -> dict:
    """The least time the card could take for a seam pass's moments (the
    face or skeleton kernel) on these inputs: the larger of its FP32
    operations over the FP32 peak and its bytes over the memory rate.
    `work` = (listed, kept) from mls.face_work / skeleton_work; bytes:
    each listed candidate's filter columns and identity (24) read once,
    each kept candidate's row (32) read once, the moments and hits (40 a
    corner) of `items` rows of `corners` written once; operations:
    `per_listed` for each listed candidate's filter (18 for a face row's
    rectangle test, 10 for a point's), 13 for each kept candidate's frame
    and features, 45 for each (corner, kept candidate) pair (distance 9,
    weight 5, terms 8, the tree's adds 9 amortised, the rest the hit count
    and selects)."""
    listed, kept = work
    flops = per_listed * listed + 13 * kept + 45 * corners * kept
    nbytes = 24 * listed + 32 * kept + 40 * corners * items
    t_ops, t_bytes = flops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return {"listed": listed, "kept": kept, "flops": flops, "bytes": nbytes,
            "ops_ms": t_ops, "bytes_ms": t_bytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def seam_vs_plain(n, binned, starts, lens, origin, region, points, tpa, fit,
                  bf, field, reps=REPS, timed=True) -> list:
    """The face kernel, and the skeleton kernel where `points` (the block's
    skeleton points) are given, against their plain versions on one
    block's binned entries, `field` the field kernel's: moments and hits
    equal value for value (== or both NaN) with the default buffer and
    with SMALL_BUFFER, and the pass's field equal to the plain pass's.
    With `timed`: the pass (its preparation, the kernel, the plain fit and
    write) host-paced and on the device alone, the kernel alone (profiler)
    at both buffers, the plain pass at 32 rows (64 points) a chunk, the
    bound on these inputs, and the launches and host syncs of a pass and
    of the plain one. Its launches are comparisons: not counted by
    callers, who reset the counters after it. Returns a row per kernel."""
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
                   *plain_args, rows.to(torch.int32), buf),
               lambda: mls.face_moments(*plain_args, rows),
               lambda: mls.face_work(*plain_args, rows), 18)]
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
                 *plain_args, pts, tid, inside, buf),
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
            _equal_values(got, ref_f, f"{kind} pass field, buffer {buf}")
        summary = kernel_gate.compare_fields(ref_f, got)
        del m, h, got
        row = {"name": name, "fit": fit, "boundary_factor": bf,
               "items": items, "defined": summary["defined_corners"],
               "max_abs_err": summary["max_abs_err"],
               "equal_value_for_value": True}
        if timed:
            scratch = field.clone()
            call = lambda: run(scratch, None)  # noqa: E731
            row["host_paced_ms"] = cuda_ms(call, reps)
            row["device_ms"] = cuda_ms(call, reps, device_only=True,
                                       sleep_cycles=PASS_SLEEP_CYCLES)
            row["kernel_ms"] = kernel_device_ms(call, f"seam_{kind}_kernel",
                                                reps)
            row["kernel_small_buffer_ms"] = kernel_device_ms(
                lambda: run(scratch, SMALL_BUFFER), f"seam_{kind}_kernel",
                reps)
            row["plain_ms"] = cuda_ms(lambda: plain(scratch), reps)
            row["pass"] = pass_profile(call)
            row["plain_pass"] = pass_profile(lambda: plain(scratch), 1)
            row["bound"] = seam_bound(work(), per, corners, items)
            del scratch
            k_ms = row["kernel_ms"]
            row["share_of_bound"] = (None if k_ms is None else
                                     row["bound"]["bound_ms"] / k_ms)
        phase(n, f"{kind} kernel vs plain, {fit} bf={bf:g}, {items} "
                 f"{'rows' if corners > 1 else 'points'}: moments, hits and "
                 f"the pass's field equal value for value at buffers "
                 f"{seam_cuda.max_buffer()} and {SMALL_BUFFER}; "
                 f"{json.dumps(row)}")
        out.append(row)
    return out


def phase3_kernel_vs_plain(src, info, b, dev) -> list:
    """`b`: the densest of the buckets the main path streams."""
    grid_form, valid = load_bucket(src, info, b)
    min_s, max_s = SUB, LEVELS + SUB - 1
    tpa = 1 << (max_s - 3)
    origin = tuple(int(v) for v in b.cell_lo)
    binned = binning.bin_splats(torch.as_tensor(grid_form, device=dev),
                                torch.as_tensor(valid, device=dev),
                                origin, min_s, max_s)
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
    seams = seam_vs_plain(3, binned, starts, lens, origin, region, points,
                          tpa, "sphere", 0.0, field)
    seams += seam_vs_plain(3, binned, starts, lens, origin, region, points,
                           tpa, "plane", 1.0 - GAMMAS[1] ** 2, field,
                           timed=False)
    phase(3, f"bucket {b.num_splats} splats, {binned.entry_data.shape[0]} "
             f"entries, {tpa}^3 tiles, {n_occ} occupied, max tile total "
             f"{max_tile}, {len(b.skeleton)} skeleton points: OK")
    return rows, seams


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


def cli_run(cloud, name, extra=(), manifold=True) -> dict:
    """One run of `cli.main` on the bench cloud, cloud = (PLY path, grid
    spacing); kernel launches counted from 0 for this run alone. Returns
    the run's numbers, statistics and a digest of its mesh; `manifold`
    runs the manifold check (~30 s at this size)."""
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
                   reg.counter("bucket.skeletonBlocks").get())
    res = {"seconds": elapsed, "vertices": len(verts),
           "triangles": len(tris), "blocks": blocks,
           "kernel_launches": launches, "stats": reg.to_dict(),
           "digest": hashlib.sha256(verts.tobytes() + tris.tobytes())
           .hexdigest()}
    if manifold:
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
    res = cli_run(cloud, "codes")
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


def phase8_statistics_device(cloud, plain) -> list:
    """--statistics-device in the codes and packed modes: the mesh must be
    bitwise the plain run's of the same mode (whose counts phases 5 and 7
    checked), so no second manifold check is needed."""
    runs = []
    for mode in ("codes", "packed"):
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
    # the kernel against its plain version at this dispatch's shapes, before
    # the face and skeleton passes overwrite the field
    min_s, max_s = SUB, TILED_LEVELS + SUB - 1
    tpa = 1 << (max_s - 3)
    binned = binning.bin_splats(sp, va, origin, min_s, max_s)
    starts, lens = binning.tile_segments(binned.entry_keys, min_s, max_s, tpa)
    row = kernel_vs_plain(9, binned, starts, lens, origin, tpa,
                          cfg.fit_shape, bf, reps=3)
    points = (torch.as_tensor(b.skeleton, device=dev) if len(b.skeleton)
              else None)
    field0 = mls_cuda.launch(binned.entry_data, starts, lens, origin, tpa,
                             cfg.fit_shape, bf)
    seams = seam_vs_plain(9, binned, starts, lens, origin, region, points,
                          tpa, cfg.fit_shape, bf, field0, reps=3)
    del binned, starts, lens, field0
    reset_launches()
    field, _ = block.block_field(sp, va, region, origin, bf, points,
                                 levels=cfg.device_levels, subsampling=SUB)
    launches = read_launches()
    if field.shape[0] != 1 << (TILED_LEVELS + SUB - 1) or \
            launches != dict(mls_field=1, seam_face=1,
                             seam_skeleton=int(points is not None)):
        raise AssertionError(f"dispatch {tuple(field.shape)}, {launches} "
                             "launches")
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
                             reg.counter("bucket.skeletonBlocks").get())
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
                   reg.counter("bucket.skeletonBlocks").get())
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
from mlsgpu_tpu_torch.ops import seam_cuda
from mlsgpu_tpu_torch.parallel import multihost
from mlsgpu_tpu_torch.utils.statistics import get_registry
own = {}
merge = multihost._merge_stats
def snapshot(transport):
    reg = get_registry()
    own.update(blocks=reg.counter("mesher.blocks").get(),
               splats=reg.counter("distributed.rankSplats").get(),
               device_s=reg.to_dict().get("device.time", {}).get("sum", 0.0))
    return merge(transport)
multihost._merge_stats = snapshot
rc = cli.main(sys.argv[1:])
reg = get_registry().to_dict()
imb = reg.get("distributed.imbalance")
own.update(rc=rc, launches=list(seam_cuda.launch_counts()),
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
        check_launches(f"rank {r}", dict(zip(KERNELS, rec["launches"])),
                       rec["blocks"], rec["blocks"])
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
                   reg.counter("bucket.skeletonBlocks").get())
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
    launches equal blocks, every worker ran a block, more than one worker
    are as many processes, and no process of the run outlives it. Returns
    each run's numbers by name."""
    out = {}
    for name, extra, workers in runs:
        res = bench_queues.run_cli(ROOT, cloud[0], cloud[1], extra)
        digest = digest or res["digest"]
        if res["digest"] != digest:
            raise AssertionError(f"{name}: the mesh differs from the "
                                 "reference run's")
        if res["launches"] != res["blocks"] or \
                res["face_launches"] != res["blocks"] or \
                res["skeleton_launches"] != res["skeleton_blocks"]:
            raise AssertionError(
                f"{name}: {res['launches']} field, {res['face_launches']} "
                f"face, {res['skeleton_launches']} skeleton launches, "
                f"{res['blocks']} blocks")
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
    one_card = ["--device", "cuda:0", "--device-threads"]
    every_card = [(f"{cards} cards", ["--device", "cuda", "--num-devices",
                                      "0"], cards)] if cards > 1 else []
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
        "kernel_launches": {
            k: sum(v[key] for v in [*out.values(), *big.values()])
            for k, key in zip(KERNELS, ("launches", "face_launches",
                                        "skeleton_launches"))},
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
        if step != dict(mls_field=2, seam_face=2, seam_skeleton=0):
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
    only = None
    if args.only:
        only = {int(n) for n in args.only.split(",")}
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
    launches, rows, seams = [], [], []
    if want(3):
        rows, seams = phase3_kernel_vs_plain(src, info, densest, dev)
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
        print_kernel_record(rows, seams, launches)
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def print_kernel_record(rows, seams, launches) -> None:
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
    print(json.dumps({"kernels": record}))


if __name__ == "__main__":
    sys.exit(main())
