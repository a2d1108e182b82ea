"""Summarize a --timeplot trace: per-worker, per-action busy time and
utilization (reference utils/timeplot.py + analyze_timeplot.py).

Usage: python -m mlsgpu_tpu_torch.tools.analyze_timeplot trace.txt
"""

from __future__ import annotations

import sys
from collections import defaultdict


def analyze(path: str):
    spans = defaultdict(float)      # (worker, action) -> busy seconds
    bounds = {}                     # worker -> (first_start, last_stop)
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 5 or parts[0] != "EVENT":
                continue
            _, worker, action, start, stop = parts
            start, stop = float(start), float(stop)
            spans[(worker, action)] += stop - start
            lo, hi = bounds.get(worker, (start, stop))
            bounds[worker] = (min(lo, start), max(hi, stop))
    return spans, bounds


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("usage: analyze_timeplot trace.txt", file=sys.stderr)
        return 2
    spans, bounds = analyze(argv[0])
    workers = sorted(bounds)
    for w in workers:
        lo, hi = bounds[w]
        wall = hi - lo
        busy = sum(t for (ww, _), t in spans.items() if ww == w)
        print(f"{w}: wall {wall:.3f}s, busy {busy:.3f}s "
              f"({100 * busy / wall if wall else 0:.1f}%)")
        for (ww, action), t in sorted(spans.items(), key=lambda kv: -kv[1]):
            if ww == w:
                print(f"  {action}: {t:.3f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
