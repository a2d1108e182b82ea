"""Parse a --statistics dump into a performance breakdown.

Equivalent of the reference's utils/analyze_stats.py: reads the text dump
written by `Registry.dump` (utils/statistics.py), classifies the named
statistics into pipeline phases, and prints per-phase time, percentage of
the run, and derived throughputs.

Dump line grammar (see Statistic.__str__):
    counter:   `name: TOTAL`
    variable:  `name: SUM : MEAN +/- SD [N]`
    peak:      `name: CURRENT (peak PEAK)`

Usage: python -m mlsgpu_tpu_torch.tools.analyze_stats stats.txt
"""

from __future__ import annotations

import re
import sys
from typing import Dict, Optional, Tuple

_VARIABLE = re.compile(
    r"^(?P<name>\S+): (?P<sum>[-+0-9.e]+) : (?P<mean>[-+0-9.e]+) "
    r"\+/- (?P<sd>[-+0-9.e]+|nan) \[(?P<n>\d+)\]$")
_PEAK = re.compile(r"^(?P<name>\S+): (?P<cur>-?\d+) \(peak (?P<peak>-?\d+)\)$")
_COUNTER = re.compile(r"^(?P<name>\S+): (?P<total>-?\d+)$")

# phase -> list of time-variable names composing it (our registry's names;
# the reference's common_names table plays the same role).
PHASES = [
    ("blob pass (pass0)", ["pass0.time"]),
    ("bucketing", ["bucket.time"]),
    ("device compute wait", ["device.time"]),
    ("block dispatch", ["streamer.dispatch"]),
    ("input load", ["loader.time"]),
    ("mesh readback", ["readback.counts", "readback.mesh"]),
    ("mesher (weld/spill)", ["mesher.time"]),
    ("final write", ["write.time"]),
]


def parse(lines) -> Dict[str, dict]:
    stats: Dict[str, dict] = {}
    for line in lines:
        line = line.strip()
        if not line:
            continue
        m = _VARIABLE.match(line)
        if m:
            stats[m.group("name")] = {
                "type": "variable", "sum": float(m.group("sum")),
                "mean": float(m.group("mean")), "n": int(m.group("n"))}
            continue
        m = _PEAK.match(line)
        if m:
            stats[m.group("name")] = {
                "type": "peak", "current": int(m.group("cur")),
                "peak": int(m.group("peak"))}
            continue
        m = _COUNTER.match(line)
        if m:
            stats[m.group("name")] = {
                "type": "counter", "total": int(m.group("total"))}
    return stats


def _time(stats: Dict[str, dict], name: str) -> float:
    d = stats.get(name)
    return float(d["sum"]) if d and d["type"] == "variable" else 0.0


def _count(stats: Dict[str, dict], name: str) -> int:
    d = stats.get(name)
    if d is None:
        return 0
    return int(d["total"]) if d["type"] == "counter" else int(d.get("n", 0))


def report(stats: Dict[str, dict], out=None) -> None:
    out = out or sys.stdout
    run = _time(stats, "run.time") or sum(
        _time(stats, n) for _, names in PHASES for n in names)
    print(f"total run time: {run:.2f}s", file=out)
    print(f"{'phase':<24}{'time':>10}{'% run':>8}{'events':>10}", file=out)
    for label, names in PHASES:
        t = sum(_time(stats, n) for n in names)
        n = sum(stats.get(x, {}).get("n", 0) for x in names)
        if t == 0 and n == 0:
            continue
        pct = 100.0 * t / run if run else 0.0
        print(f"{label:<24}{t:>9.2f}s{pct:>7.1f}%{n:>10}", file=out)

    nblocks = _count(stats, "mesher.blocks")
    nverts = _count(stats, "mesher.vertices")
    ntris = _count(stats, "mesher.triangles")
    retries = _count(stats, "device.capRetries")
    print(file=out)
    print(f"blocks: {nblocks}   cap retries: {retries}", file=out)
    if run:
        print(f"output: {nverts} vertices, {ntris} triangles "
              f"({ntris / run / 1e6:.2f} Mtris/s)", file=out)

    # Device-stage breakdown (--statistics-device; the reference's
    # statistics_cl kernel.*.time harvest, src/statistics_cl.h:43-93).
    dev = [(k, v) for k, v in stats.items()
           if k.startswith("device.") and k.endswith(".time")
           and v["type"] == "variable" and k != "device.time"]
    if dev:
        dtot = sum(float(v["sum"]) for _, v in dev)
        print("\ndevice stages (--statistics-device):", file=out)
        for k, v in sorted(dev, key=lambda kv: -kv[1]["sum"]):
            stage = k[len("device."):-len(".time")]
            t = float(v["sum"])
            pct = 100.0 * t / dtot if dtot else 0.0
            print(f"  {stage:<22}{t:>9.2f}s{pct:>7.1f}%"
                  f"{v.get('n', 0):>10}", file=out)

    peaks = [(k, v) for k, v in stats.items() if v["type"] == "peak"]
    if peaks:
        print("\npeak memory:", file=out)
        for k, v in sorted(peaks, key=lambda kv: -kv[1]["peak"]):
            print(f"  {k:<30}{v['peak'] / (1 << 20):>10.1f} MiB", file=out)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("usage: analyze_stats <statistics-file>", file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        stats = parse(f)
    report(stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
