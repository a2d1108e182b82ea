"""Compute-vs-transfer split for the streaming pipeline.

Runs the bench cloud's buckets through the streamer three times: a warm
pass, then pass A, which runs every block step but copies no image to the
host (the counts alone come back: wall time ~= dispatch + device compute),
then pass B, the full path (readback and native decode; no mesher, no
write). B - A is what the device-to-host transfer and the decode cost end
to end (the reference separates these with CL event profiling,
src/statistics_cl.h:43-93). Port of mlsgpu_tpu/tools/bench_split.py.

All times are the host's clock (time.monotonic around the whole pass; the
statistics are the streamer's own timers).

Usage: python -m mlsgpu_tpu_torch.tools.bench_split [n_splats] [--device cpu]
           [--device-threads T]
"""

import argparse
import json
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("splats", type=int, nargs="?", default=2_000_000)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (every visible card), cuda:<i> "
                        "or cpu [%(default)s]")
    p.add_argument("--device-threads", type=int, default=1,
                   help="queues per card; more than one worker in all "
                        "run as worker processes [%(default)s]")
    args = p.parse_args(argv)

    from mlsgpu_tpu_torch.io.splat_set import SequenceSource
    from mlsgpu_tpu_torch.pipeline.reconstruct import (block_result_to_input,
                                                       prepare_run)
    from mlsgpu_tpu_torch.pipeline.streamer import stream_blocks
    from mlsgpu_tpu_torch.tools import cloud
    from mlsgpu_tpu_torch.utils.statistics import get_registry

    splats, sr = cloud.make_cloud(args.splats)
    cfg = cloud.bench_config(sr)
    cfg.device_threads = args.device_threads
    devices, readback = prepare_run(cfg, args.device)
    src = SequenceSource(splats)
    info, buckets, _ = cloud.densest_bucket(src, cfg)

    def run(consume: bool, label: str):
        get_registry().clear()
        t0 = time.monotonic()
        nv = 0
        for b, res in stream_blocks(src, info, buckets, cfg, devices,
                                    readback,
                                    read_images=consume):
            if consume:
                nv += len(block_result_to_input(res, b).vertices)
            else:
                nv += res.num_vertices  # the block step synced its counts
        dt = time.monotonic() - t0
        reg = get_registry()
        out = {"pass": label, "elapsed_s": round(dt, 2),
               "blocks": len(buckets), "welded_or_unwelded_verts": int(nv)}
        stats = reg.to_dict()
        for s in ("device.time", "readback.wait", "readback.decode",
                  "dispatch.h2d"):
            if s in stats:
                out[s] = round(stats[s]["sum"], 2)
        out["readback.bytes"] = stats.get("readback.bytes",
                                          {}).get("total", 0)
        print(json.dumps(out), flush=True)
        return dt

    run(False, "warm (kernel build, allocator)")
    a = run(False, "A: counts-only (compute+dispatch)")
    b = run(True, "B: full readback+decode")
    print(json.dumps({"devices": [str(d) for d in devices],
                      "queues_per_device": max(1, cfg.device_threads),
                      "readback": readback,
                      "transfer+decode_s": round(b - a, 2),
                      "per_block_ms": round((b - a) / len(buckets) * 1e3, 1)}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
