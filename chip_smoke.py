"""On-card smoke run of the PyTorch/CUDA port (mlsgpu_tpu_torch).

    python3 chip_smoke.py            # all phases, one CUDA device
    python3 chip_smoke.py --through 3  # stop after phase 3 (quick kernel check)

Phases, each printing one line of findings; any failure raises, exits
non-zero and prints no result line:
  1. toolchain and card (torch, CUDA, nvcc, triton, nvidia-smi);
  2. build the MLS field kernel from mlsgpu_tpu_torch/csrc with nvcc (sm_90a);
  3. kernel vs its plain PyTorch version on the card at main-path shapes
     (the densest 256^3-corner bucket of the 2M-splat bench cloud), sphere
     and plane fits, two boundary factors; NaN-pattern agreement > 0.9995 and
     |kernel - plain| < 1e-3 where both are defined; CUDA-event times;
  4. the seam contract on the card: shared-face and T-junction corners of
     adjacent blocks bitwise equal;
  5. end to end through `mlsgpu_tpu_torch.cli.main` on the 2M-splat bench
     cloud (bench.make_cloud) written as a PLY: manifold output, kernel
     launches >= blocks;
  6. no jax in sys.modules.
The second-last lines are the kernel JSON record and the card's name and
power limit; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
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
from mlsgpu_tpu.config import ReconstructConfig  # noqa: E402
from mlsgpu_tpu.io import ply  # noqa: E402
from mlsgpu_tpu.io.splat_set import SequenceSource, merge_ranges  # noqa: E402
from mlsgpu_tpu.pipeline import blobs as blobs_mod  # noqa: E402
from mlsgpu_tpu.pipeline import bucket as bucket_mod  # noqa: E402
from mlsgpu_tpu.utils.manifold import check_manifold  # noqa: E402
from mlsgpu_tpu.utils.statistics import get_registry  # noqa: E402
from mlsgpu_tpu_torch import cli  # noqa: E402
from mlsgpu_tpu_torch.device import set_precision  # noqa: E402
from mlsgpu_tpu_torch.ops import (binning, block, kernel_gate, mls,  # noqa: E402
                                  mls_cuda)
from mlsgpu_tpu_torch.pipeline.streamer import prepare_block_inputs  # noqa: E402

N_SPLATS = 2_000_000
LEVELS, SUB = 6, 3   # bench.py:201-215: 256^3-corner dispatches
GAMMAS = (1.0, 0.5)  # --fit-boundary-limit values; boundary factor = 1 - g^2
REPS = 7


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


def phase(n: int, msg: str) -> None:
    print(f"[phase {n}] {msg}", flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median CUDA-event time of fn() after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    phase(2, f"built {os.path.relpath(mls_cuda.LIBRARY, ROOT)} in "
             f"{time.monotonic() - t0:.2f}s (nvcc {mls_cuda.build_seconds:.2f}s); "
             f"ptxas: {' | '.join(ptxas)}")


def bench_setup():
    splats, sr = bench.make_cloud(N_SPLATS)
    spacing = float(sr / 3.0)
    cfg = ReconstructConfig(fit_grid=spacing, fit_smooth=1.0, levels=LEVELS,
                            subsampling=SUB, max_device_splats=4 << 20,
                            tile_candidates=384, progress=False)
    return splats, spacing, cfg


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
    rows = []
    for fit in ("sphere", "plane"):
        for gamma in GAMMAS:
            bf = 1.0 - gamma * gamma
            got = mls_cuda.launch(binned.entry_data, starts, lens, origin,
                                  tpa, fit, bf)
            ref = mls.eval_field(binned.entry_data, starts, lens, origin,
                                 tpa, fit, bf)
            torch.cuda.synchronize()
            summary = kernel_gate.compare_fields(ref, got)
            kernel_gate.check(summary, min_defined=10_000)
            k_ms = cuda_ms(lambda: mls_cuda.launch(
                binned.entry_data, starts, lens, origin, tpa, fit, bf))
            p_ms = cuda_ms(lambda: mls.eval_field(
                binned.entry_data, starts, lens, origin, tpa, fit, bf))
            rows.append(dict(fit=fit, boundary_factor=bf, kernel_ms=k_ms,
                             plain_ms=p_ms, **summary))
            phase(3, f"{fit} bf={bf:g}: agreement "
                     f"{summary['pattern_agreement']:.6f}, max|d| "
                     f"{summary['max_abs_err']:.3e}, defined "
                     f"{summary['defined_corners']}, kernel {k_ms:.3f} ms, "
                     f"plain {p_ms:.3f} ms")
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


def phase5_end_to_end(splats, spacing, info, workdir) -> dict:
    inp = os.path.join(workdir, "bench_cloud.ply")
    out = os.path.join(workdir, "bench_out.ply")
    ply.write_splats_ply(inp, splats)
    reg = get_registry()
    reg.clear()
    mls_cuda.launches = 0
    t0 = time.monotonic()
    rc = cli.main([
        "--fit-grid", repr(spacing), "--fit-smooth", "1", "--levels",
        str(LEVELS), "--subsampling", str(SUB), "--max-device-splats",
        "4194304", "--tile-candidates", "384", "--no-progress",
        "-o", out, inp])
    elapsed = time.monotonic() - t0
    launches = mls_cuda.launches
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}")
    verts, tris = ply.read_mesh(out)
    rep = check_manifold(verts, tris)
    if not rep.is_manifold:
        raise AssertionError(f"output not manifold: {rep.reason}")
    blocks = reg.counter("bucket.count").get()
    if launches < blocks:
        raise AssertionError(f"{launches} kernel launches < {blocks} blocks")
    ncells = int(np.prod(info.grid.shape_cells))
    res = {"seconds": elapsed, "msplats_per_s": N_SPLATS / elapsed / 1e6,
           "mcells_per_s": ncells / elapsed / 1e6, "vertices": len(verts),
           "triangles": len(tris), "blocks": blocks,
           "boundary_edges": rep.num_boundary_edges,
           "components": rep.num_components, "kernel_launches": launches,
           "pass0_s": reg.variable("pass0.time").sum,
           "pass1_s": reg.variable("pass1.time").sum,
           "write_s": reg.variable("write.time").sum,
           "device_s": reg.variable("device.time").sum}
    phase(5, f"end to end: {json.dumps(res)}")
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--through", type=int, default=6,
                   help="run phases 1..N [%(default)s]")
    args = p.parse_args(argv)

    phase1_toolchain()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    set_precision()
    phase2_build()
    if args.through < 3:
        return 0
    splats, spacing, cfg = bench_setup()
    k = phase3_kernel_vs_plain(splats, cfg, dev)
    if args.through < 4:
        return 0
    phase4_seams(dev)
    if args.through < 5:
        return 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke.") as workdir:
        phase5_end_to_end(splats, spacing, k["info"], workdir)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    phase(6, "no jax in sys.modules: OK")

    main_row = k["rows"][0]  # sphere, boundary factor 0: the default path
    print(json.dumps({"kernels": [{
        "name": "mls_field", "route": "cuda",
        "source": "mlsgpu_tpu_torch/csrc/mls_field.cu",
        "replaces": "mlsgpu_tpu/ops/mls_pallas.py:43",
        "launches": mls_cuda.launches,
        "max_abs_err": max(r["max_abs_err"] for r in k["rows"]),
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"]}]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
