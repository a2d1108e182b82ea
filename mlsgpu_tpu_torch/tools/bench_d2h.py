"""Device-to-host microbenchmark: the fixed cost and the bandwidth of one
readback (port of mlsgpu_tpu/tools/bench_d2h.py).

Measures, on one device, the host's wall time of copying a fresh device
tensor to the host across sizes, to split the device-to-host path into a
fixed cost per copy and a cost per byte (the streamer's `readback.wait`;
reference async 3-event enqueueReadMesh, src/mesh.h:141-179):

- `pageable`: `tensor.cpu()`, the copy into ordinary host memory;
- `pinned`: an asynchronous copy into a pinned buffer made once, then the
  wait for its event (what the streamer's readback does, the buffer coming
  from PyTorch's caching host allocator);
- `pinned_fresh`: the same with the pinned buffer made inside the timing;
- the cost of a scalar sync (`.item()` of a fresh 0-d result: what every
  count that sizes an output costs the block step);
- k asynchronous copies of the same total bytes against one: whether many
  small copies pay a fixed cost each or pipeline.

On `--device cpu` the "device" is the host: the pageable lines time a
memory copy and the pinned lines are left out (no pinned memory without a
card); the tool then only shows that it runs.

Prints one JSON line per measurement; times are the host's clock
(time.perf_counter), each around one copy that ends synchronised.

Usage:
    python -m mlsgpu_tpu_torch.tools.bench_d2h [--device cuda] [--reps 5]
        [--sizes-mb 0.25 0.5 1 2 4 8 16 32] [--total-mb 8]
"""

from __future__ import annotations

import argparse
import json
import time


def _median(ts):
    return sorted(ts)[len(ts) // 2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda, cuda:<i> or cpu [%(default)s]")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--sizes-mb", type=float, nargs="+",
                   default=[0.25, 0.5, 1, 2, 4, 8, 16, 32])
    p.add_argument("--total-mb", type=float, default=8,
                   help="bytes of the k-copies comparison [%(default)s]")
    args = p.parse_args(argv)

    import torch

    from mlsgpu_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    print(json.dumps({"device": str(dev), "name":
                      torch.cuda.get_device_name(dev) if on_card else "cpu",
                      "reps": args.reps}), flush=True)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def fresh(base):
        """A new device tensor, complete before the timing starts."""
        buf = base * 2 + 1
        sync()
        return buf

    def timed(fn, base):
        ts = []
        for _ in range(args.reps):
            buf = fresh(base)
            t0 = time.perf_counter()
            fn(buf)
            ts.append(time.perf_counter() - t0)
        return ts

    def pinned_copy(host):
        def fn(buf):
            h = host if host is not None else torch.empty(
                buf.shape, dtype=buf.dtype, pin_memory=True)
            h.copy_(buf, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            event.synchronize()
        return fn

    # warm the device and the first-copy path with a small round trip
    fresh(torch.ones(1024, dtype=torch.int32, device=dev)).cpu()

    for mb in args.sizes_mb:
        n = max(int(mb * 1024 * 1024) // 4, 1)
        base = torch.arange(n, dtype=torch.int32, device=dev)
        modes = {"pageable": lambda buf: buf.cpu() if on_card
                 else buf.clone()}
        if on_card:
            host = torch.empty(n, dtype=torch.int32, pin_memory=True)
            modes["pinned"] = pinned_copy(host)
            modes["pinned_fresh"] = pinned_copy(None)
        for mode, fn in modes.items():
            ts = timed(fn, base)
            med = _median(ts)
            print(json.dumps({
                "transfer_mb": mb, "mode": mode, "median_s": med,
                "min_s": min(ts), "mb_per_s": mb / med if med else None}),
                flush=True)
        del base

    # the scalar sync: one count fetched with .item()
    sbase = torch.arange(8, dtype=torch.int32, device=dev)
    ts = []
    for _ in range(4 * args.reps):
        small = fresh(sbase).sum()
        sync()
        t0 = time.perf_counter()
        small.item()
        ts.append(time.perf_counter() - t0)
    print(json.dumps({"scalar_sync_median_s": _median(ts),
                      "scalar_sync_min_s": min(ts)}), flush=True)

    # k asynchronous copies of total_mb in all against one copy
    total = max(int(args.total_mb * 1024 * 1024) // 4, 8)
    for k in (1, 2, 4, 8):
        bases = [torch.arange(total // k, dtype=torch.int32, device=dev)
                 for _ in range(k)]
        hosts = ([torch.empty(total // k, dtype=torch.int32, pin_memory=True)
                  for _ in range(k)] if on_card else None)
        ts = []
        for _ in range(args.reps):
            parts = [b * 2 + 1 for b in bases]
            sync()
            t0 = time.perf_counter()
            if on_card:
                for h, part in zip(hosts, parts):
                    h.copy_(part, non_blocking=True)
                sync()
            else:
                outs = [part.clone() for part in parts]
                del outs
            ts.append(time.perf_counter() - t0)
            del parts
        print(json.dumps({"k_transfers": k, "total_mb": args.total_mb,
                          "mode": "pinned" if on_card else "pageable",
                          "median_s": _median(ts), "min_s": min(ts)}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
