"""Render a --timeplot trace as an SVG Gantt timeline (reference
utils/draw_timeplot.py).

Each timeplot worker (thread) is a horizontal lane; each EVENT span is a
colored bar, hue keyed by action name (fixed assignment by total busy time,
top 8 actions; the rest fold into a gray "other"). Native SVG <title>
tooltips carry the exact action/start/stop. Dependency-free: writes plain
SVG with embedded light/dark CSS.

Usage: python -m mlsgpu_tpu_torch.tools.draw_timeplot trace.txt -o trace.svg
"""

from __future__ import annotations

import argparse
import html
import sys
from collections import defaultdict

# Validated categorical palette (adjacent-pair CVD-safe, light/dark stepped).
_LIGHT = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100",
          "#e87ba4", "#008300", "#4a3aa7", "#e34948"]
_DARK = ["#3987e5", "#d95926", "#199e70", "#c98500",
         "#d55181", "#008300", "#9085e9", "#e66767"]
_OTHER = ("#9a9992", "#6f6e67")

_LANE_H = 22
_BAR_H = 14
_LEFT = 150
_TOP = 40
_LEGEND_H = 26


def parse(path: str):
    """EVENT worker action start stop lines -> per-worker span lists."""
    lanes = defaultdict(list)
    busy = defaultdict(float)
    t0, t1 = float("inf"), float("-inf")
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 5 or parts[0] != "EVENT":
                continue
            _, worker, action, start, stop = parts
            start, stop = float(start), float(stop)
            lanes[worker].append((start, stop, action))
            busy[action] += stop - start
            t0, t1 = min(t0, start), max(t1, stop)
    return lanes, busy, t0, t1


def _ticks(t0: float, t1: float, n: int = 8):
    span = max(t1 - t0, 1e-9)
    raw = span / n
    mag = 10 ** int(f"{raw:e}".split("e")[1])
    step = next(s * mag for s in (1, 2, 5, 10) if s * mag >= raw)
    first = int(t0 / step) * step
    out = []
    t = first
    while t <= t1 + 1e-12:
        if t >= t0 - 1e-12:
            out.append(t)
        t += step
    return out


def render(lanes, busy, t0: float, t1: float, width: int = 1200) -> str:
    workers = sorted(lanes)
    actions = sorted(busy, key=lambda a: -busy[a])
    slot = {a: i for i, a in enumerate(actions[:8])}
    span = max(t1 - t0, 1e-9)
    plot_w = width - _LEFT - 20
    height = _TOP + len(workers) * _LANE_H + _LEGEND_H + 20

    def x(t):
        return _LEFT + (t - t0) / span * plot_w

    e = html.escape
    out = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" font-family="system-ui, sans-serif" '
        f'font-size="11">',
        "<style>",
        ":root { color-scheme: light dark; }",
        "svg { --surface: #fcfcfb; --ink: #0b0b0b; --ink2: #52514e; "
        "--grid: #e4e3de; "
        + " ".join(f"--s{i}: {c};" for i, c in enumerate(_LIGHT))
        + f" --other: {_OTHER[0]}; }}",
        "@media (prefers-color-scheme: dark) { svg { "
        "--surface: #1a1a19; --ink: #ffffff; --ink2: #c3c2b7; "
        "--grid: #3a3935; "
        + " ".join(f"--s{i}: {c};" for i, c in enumerate(_DARK))
        + f" --other: {_OTHER[1]}; }} }}",
        "text { fill: var(--ink); }",
        ".muted { fill: var(--ink2); }",
        "</style>",
        f'<rect width="{width}" height="{height}" fill="var(--surface)"/>',
        f'<text x="{_LEFT}" y="16" font-size="13" font-weight="600">'
        f"timeplot — {len(workers)} workers, {span:.2f}s</text>",
    ]
    # recessive time grid + tick labels
    for t in _ticks(t0, t1):
        xx = x(t)
        out.append(f'<line x1="{xx:.1f}" y1="{_TOP - 6}" x2="{xx:.1f}" '
                   f'y2="{_TOP + len(workers) * _LANE_H}" '
                   f'stroke="var(--grid)" stroke-width="1"/>')
        out.append(f'<text x="{xx:.1f}" y="{_TOP - 10}" class="muted" '
                   f'text-anchor="middle">{t - t0:g}s</text>')
    # lanes
    for wi, w in enumerate(workers):
        y = _TOP + wi * _LANE_H
        out.append(f'<text x="{_LEFT - 8}" y="{y + _BAR_H}" '
                   f'text-anchor="end">{e(w)}</text>')
        for start, stop, action in sorted(lanes[w]):
            color = (f"var(--s{slot[action]})" if action in slot
                     else "var(--other)")
            bw = max((stop - start) / span * plot_w, 0.5)
            out.append(
                f'<rect x="{x(start):.2f}" y="{y + 3}" width="{bw:.2f}" '
                f'height="{_BAR_H}" rx="2" fill="{color}">'
                f"<title>{e(w)}: {e(action)}  "
                f"{start - t0:.3f}s → {stop - t0:.3f}s "
                f"({stop - start:.3f}s)</title></rect>")
    # legend (identity is color + adjacent text label, never color alone)
    ly = _TOP + len(workers) * _LANE_H + 16
    lx = _LEFT
    for a in actions[:8]:
        out.append(f'<rect x="{lx}" y="{ly - 9}" width="10" height="10" '
                   f'rx="2" fill="var(--s{slot[a]})"/>')
        label = f"{a} ({busy[a]:.2f}s)"
        out.append(f'<text x="{lx + 14}" y="{ly}">{e(label)}</text>')
        lx += 14 + 7 * len(label) + 18
    if len(actions) > 8:
        out.append(f'<rect x="{lx}" y="{ly - 9}" width="10" height="10" '
                   f'rx="2" fill="var(--other)"/>')
        out.append(f'<text x="{lx + 14}" y="{ly}">other '
                   f"({len(actions) - 8} actions)</text>")
    out.append("</svg>")
    return "\n".join(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="draw_timeplot",
                                description="render a timeplot trace as SVG")
    p.add_argument("trace")
    p.add_argument("-o", "--output", default=None,
                   help="output SVG path (default: trace path + .svg)")
    p.add_argument("--width", type=int, default=1200)
    args = p.parse_args(argv)
    lanes, busy, t0, t1 = parse(args.trace)
    if not lanes:
        print("no EVENT lines found", file=sys.stderr)
        return 1
    svg = render(lanes, busy, t0, t1, width=args.width)
    out = args.output or (args.trace + ".svg")
    with open(out, "w") as f:
        f.write(svg)
    print(f"wrote {out}: {sum(len(v) for v in lanes.values())} spans, "
          f"{len(lanes)} workers, {len(busy)} actions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
