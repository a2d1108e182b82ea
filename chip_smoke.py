"""On-card smoke run of the PyTorch/CUDA port (mlsgpu_tpu_torch).

    python3 chip_smoke.py            # all phases, one CUDA device
    python3 chip_smoke.py --through 3  # stop after phase 3 (quick kernel check)

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
  4. the seam contract on the card: shared-face and T-junction corners of
     adjacent blocks bitwise equal;
  5. end to end through `mlsgpu_tpu_torch.cli.main` on the 2M-splat bench
     cloud (bench.make_cloud) written as a PLY: manifold output, kernel
     launches >= blocks;
  7. the same run with `--readback packed` and `--readback raw`: the codes
     run's vertex, triangle and boundary-edge counts, manifold; the seconds
     of all three modes;
  8. `--statistics-device` (codes, then packed): the same counts, and every
     `device.<stage>.time`;
  9. on the densest 512^3-corner dispatch (`--levels 7`, 64^3 tiles, 7
     levels): the kernel against its plain version as in phase 3 (sphere
     fit, the run's boundary factor), then tiled against dense
     classification of the block's field: the codes images bitwise equal;
     all four times;
 10. `DeviceScaleBias(scale=2, bias)` through `reconstruct(device_filter=)`
     on a small cloud: each block's filtered vertices equal its unfiltered
     ones transformed on the host within 1e-5 of a cell; manifold;
  6. neither jax nor the JAX package `mlsgpu_tpu` in sys.modules (checked
     after every phase).
Kernel launches are counted per main-path run (the counter set to 0 just
before it and read just after; the comparisons of phases 3 and 9
excluded); each run must launch the kernel, and the kernel record's
`launches` is their sum; its `max_abs_err` is the largest of phases 3
and 9; its `ms` is the call's host-paced time, as in earlier versions of
this script, and `device_ms` the call's time on the device alone.
The second-last lines are the kernel JSON record and the card's name and
power limit; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import bench  # noqa: E402  (numpy only: the bench cloud generator)
from mlsgpu_tpu_torch import cli  # noqa: E402
from mlsgpu_tpu_torch.config import ReconstructConfig  # noqa: E402
from mlsgpu_tpu_torch.device import set_precision  # noqa: E402
from mlsgpu_tpu_torch.io import ply  # noqa: E402
from mlsgpu_tpu_torch.io.splat_set import (SequenceSource,  # noqa: E402
                                           merge_ranges)
from mlsgpu_tpu_torch.ops import (binning, block, kernel_gate,  # noqa: E402
                                  marching, mls, mls_cuda)
from mlsgpu_tpu_torch.pipeline import blobs as blobs_mod  # noqa: E402
from mlsgpu_tpu_torch.pipeline import bucket as bucket_mod  # noqa: E402
from mlsgpu_tpu_torch.pipeline import mesh_filter  # noqa: E402
from mlsgpu_tpu_torch.pipeline import reconstruct as port_rec  # noqa: E402
from mlsgpu_tpu_torch.pipeline.streamer import prepare_block_inputs  # noqa: E402
from mlsgpu_tpu_torch.utils.manifold import check_manifold  # noqa: E402
from mlsgpu_tpu_torch.utils.statistics import get_registry  # noqa: E402

N_SPLATS = 2_000_000
LEVELS, SUB = 6, 3   # bench.py:201-215: 256^3-corner dispatches
TILED_LEVELS = 7     # 512^3-corner dispatches: tiled classification
GAMMAS = (1.0, 0.5)  # --fit-boundary-limit values; boundary factor = 1 - g^2
REPS = 7
# The H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): FP32
# outside the tensor cores, and the HBM3 rate.
FP32_PEAK = 67e12      # FLOP/s
HBM_RATE = 3.35e12     # bytes/s
SLEEP_CYCLES = 4_000_000  # ~2 ms of the card's clock: longer than any
#                           host enqueue of one timed call


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


def check_isolated(after: str) -> None:
    """Neither jax nor the JAX package may have been imported."""
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "mlsgpu_tpu"))
    if bad:
        raise AssertionError(f"imported after {after}: {bad[:5]}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int = REPS, device_only: bool = False) -> float:
    """Median CUDA-event time of fn() after one warm-up call. By default
    the events also see the host: work the card finishes faster than the
    host can queue it is timed at the host's pace. device_only: the card
    first sleeps while the host queues fn's work, so the events time the
    device's work alone."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SLEEP_CYCLES)
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
    splats, sr = bench.make_cloud(N_SPLATS)
    spacing = float(sr / 3.0)
    cfg = ReconstructConfig(fit_grid=spacing, fit_smooth=1.0, levels=LEVELS,
                            subsampling=SUB, max_device_splats=4 << 20,
                            tile_candidates=384, progress=False)
    return splats, spacing, cfg


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


def phase3_kernel_vs_plain(splats, cfg, dev) -> dict:
    src = SequenceSource(splats)
    info = blobs_mod.compute_blobs(src, cfg.fit_grid, cfg.micro_cells)
    buckets = bucket_mod.make_buckets(   # the buckets the main path streams
        info, cfg.device_block_cells, cfg.micro_cells,
        max_splats=min(cfg.max_device_splats, cfg.mem_bucket_splats // 32))
    b = max(buckets, key=lambda x: x.num_splats)
    ranges = merge_ranges((int(info.blobs.start[i]),
                           int(info.blobs.start[i] + info.blobs.count[i]))
                          for i in b.blob_ids)
    grid_form, valid = prepare_block_inputs(src.read_ranges(ranges), info.grid)
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
    phase(3, f"bucket {b.num_splats} splats, {binned.entry_data.shape[0]} "
             f"entries, {tpa}^3 tiles, {n_occ} occupied, max tile total "
             f"{max_tile}: OK")
    return {"rows": rows, "info": info}


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


def phase4_seams(dev) -> None:
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
    rng = np.random.default_rng(3)
    splats = sphere_cloud([12.0, 12.0, 16.0], 7.0, 9000, 1.2, rng)
    mk = [bucket_mod.Bucket(chunk_id=None, cell_lo=np.array(lo, np.int64),
                            cell_hi=np.array(hi, np.int64),
                            blob_ids=np.empty(0, np.int64), num_splats=1)
          for lo, hi in (((0, 0, 0), (16, 16, 31)), ((16, 0, 0), (31, 16, 31)),
                         ((0, 16, 0), (31, 31, 31)))]
    bucket_mod.skeleton_points(mk)
    fa, fc, fb = (_seam_block(splats, k.cell_lo, k.cell_hi, dev, k.skeleton)
                  for k in mk)
    checked.append(_bitwise_equal(fa[:, 16, 0:17], fb[:, 0, 0:17], 20, "A|B"))
    checked.append(_bitwise_equal(fc[:, 16, 0:16], fb[:, 0, 16:32], 20, "C|B"))
    checked.append(_bitwise_equal(fa[:, 0:17, 16], fc[:, 0:17, 0], 20, "A|C"))
    phase(4, f"seam contract on the card: {sum(checked)} shared corners "
             f"bitwise equal over {len(checked)} planes: OK")


def cli_run(cloud, name, extra=(), manifold=True) -> dict:
    """One run of `cli.main` on the bench cloud, cloud = (PLY path, grid
    spacing); kernel launches counted from 0 for this run alone. Returns
    the run's numbers, statistics and a digest of its mesh; `manifold`
    runs the manifold check (~30 s at this size)."""
    inp, spacing = cloud
    out = os.path.join(os.path.dirname(inp), f"{name}.ply")
    reg = get_registry()
    reg.clear()
    mls_cuda.launches = 0
    t0 = time.monotonic()
    rc = cli.main([
        "--fit-grid", repr(spacing), "--fit-smooth", "1", "--levels",
        str(LEVELS), "--subsampling", str(SUB), "--max-device-splats",
        "4194304", "--tile-candidates", "384", "--no-progress", *extra,
        "-o", out, inp])
    elapsed = time.monotonic() - t0
    launches = mls_cuda.launches
    if rc != 0:
        raise RuntimeError(f"cli.main {' '.join(extra)} returned {rc}")
    verts, tris = ply.read_mesh(out)
    os.remove(out)
    blocks = reg.counter("bucket.count").get()
    if launches < blocks:
        raise AssertionError(f"{name}: {launches} kernel launches < "
                             f"{blocks} blocks")
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


def phase7_readbacks(cloud, codes) -> dict:
    runs = {"codes": codes}
    seconds = {"codes": codes["seconds"]}
    for mode in ("packed", "raw"):
        res = cli_run(cloud, mode, ["--readback", mode])
        if res["stats"].get(f"readback.mode.{mode}", {}).get("total") != \
                res["blocks"]:
            raise AssertionError(f"{mode}: not every block read back {mode}")
        _same_mesh(res, codes, mode)
        seconds[mode] = res["seconds"]
        runs[mode] = res
        phase(7, f"--readback {mode}: {res['vertices']} vertices, "
                 f"{res['triangles']} triangles, {res['boundary_edges']} "
                 f"boundary edges, manifold, {res['kernel_launches']} "
                 f"launches, readback {res['stats']['readback.bytes']['total']}"
                 f" bytes, device.time "
                 f"{res['stats']['device.time']['sum']:.3f} s: OK")
    phase(7, f"end-to-end seconds by readback: {json.dumps(seconds)}")
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
    info = blobs_mod.compute_blobs(src, cfg.fit_grid, cfg.micro_cells)
    buckets = bucket_mod.make_buckets(
        info, cfg.device_block_cells, cfg.micro_cells,
        max_splats=min(cfg.max_device_splats, cfg.mem_bucket_splats // 32))
    b = max(buckets, key=lambda x: x.num_splats)
    ranges = merge_ranges((int(info.blobs.start[i]),
                           int(info.blobs.start[i] + info.blobs.count[i]))
                          for i in b.blob_ids)
    grid_form, valid = prepare_block_inputs(src.read_ranges(ranges), info.grid)
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
    del binned, starts, lens
    mls_cuda.launches = 0
    field, _ = block.block_field(
        sp, va, region, origin, bf,
        torch.as_tensor(b.skeleton, device=dev) if len(b.skeleton) else None,
        levels=cfg.device_levels, subsampling=SUB)
    launches = mls_cuda.launches
    if field.shape[0] != 1 << (TILED_LEVELS + SUB - 1) or launches != 1:
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
    out, launches = {}, 0
    for name, dfilter in (("plain", None), ("filtered", chain)):
        rec = _Recorder()
        path = os.path.join(workdir, f"{name}.ply")
        mls_cuda.launches = 0
        port_rec.reconstruct(SequenceSource(splats), cfg, path, device="cuda",
                             filters=rec, device_filter=dfilter)
        if mls_cuda.launches < len(rec.blocks):
            raise AssertionError(f"{name}: {mls_cuda.launches} launches")
        launches += mls_cuda.launches
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--through", type=int, default=10,
                   help="run phases 1..N (6, the jax check, runs last) "
                        "[%(default)s]")
    args = p.parse_args(argv)

    check_isolated("the imports")
    phase1_toolchain()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    set_precision()
    phase2_build()
    check_isolated("phase 2")
    if args.through < 3:
        return 0
    splats, spacing, cfg = bench_setup()
    k = phase3_kernel_vs_plain(splats, cfg, dev)
    check_isolated("phase 3")
    if args.through < 4:
        return 0
    phase4_seams(dev)
    check_isolated("phase 4")
    if args.through < 5:
        return 0
    launches = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke.") as workdir:
        inp = os.path.join(workdir, "bench_cloud.ply")
        ply.write_splats_ply(inp, splats)
        codes = phase5_end_to_end((inp, spacing), k["info"])
        check_isolated("phase 5")
        launches.append(codes["kernel_launches"])
        if args.through >= 7:
            plain = phase7_readbacks((inp, spacing), codes)
            check_isolated("phase 7")
            launches += [plain[m]["kernel_launches"]
                         for m in ("packed", "raw")]
        if args.through >= 8:
            launches += [r["kernel_launches"] for r in
                         phase8_statistics_device((inp, spacing), plain)]
            check_isolated("phase 8")
        if args.through >= 9:
            tiled = phase9_tiled_vs_dense(splats, spacing, dev)
            check_isolated("phase 9")
            launches.append(tiled["kernel_launches"])
            k["rows"].append(tiled["kernel_row"])
        if args.through >= 10:
            launches.append(phase10_device_filter(workdir)["kernel_launches"])
            check_isolated("phase 10")
    check_isolated("every phase")
    phase(6, "neither jax nor mlsgpu_tpu in sys.modules after any phase: OK")

    main_row = k["rows"][0]  # sphere, boundary factor 0: the default path
    print(json.dumps({"kernels": [{
        "name": "mls_field", "route": "cuda",
        "source": "mlsgpu_tpu_torch/csrc/mls_field.cu",
        "replaces": "mlsgpu_tpu/ops/mls_pallas.py:43",
        "launches": sum(launches),
        "max_abs_err": max(r["max_abs_err"] for r in k["rows"]),
        "ms": main_row["host_paced_ms"], "device_ms": main_row["device_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound"]["bound_ms"],
        "bound_by": main_row["bound"]["bound_by"],
        "library_ms": None}]}))  # no single PyTorch call computes the field
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
