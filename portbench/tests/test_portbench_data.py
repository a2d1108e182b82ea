"""The harness is data: a configuration, a traffic mix, a cell and a
per-layer metric added as new files (and entries in BENCHMARK.json) are
listed and loaded, and no file the benchmark had is edited."""

import hashlib
import json
import os
import shutil

from portbench.harness import ROOT
from portbench.tests.helpers import run_python


def digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" in d:
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha1(
                    fh.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path, tmp_env):
    co = tmp_path / "co"
    shutil.copytree(os.path.join(ROOT, "portbench"), co / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(co / "portbench")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    pb = co / "portbench"

    cfg = json.load(open(pb / "configs" / "sphere2m-l6.json"))
    cfg.update(name="sphere3m-l6", cloud=dict(cfg["cloud"], splats=3000000))
    (pb / "configs" / "sphere3m-l6.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "raw.json").write_text(json.dumps(
        {"readback": "raw", "order": "shuffled", "about": "a new mix"}))
    spec = json.load(open(pb / "workloads" / "sphere2m-l6.codes.json"))
    spec.update(config="sphere3m-l6", traffic="raw")
    (pb / "workloads" / "sphere3m-l6.raw.json").write_text(json.dumps(spec))
    (pb / "metrics" / "loader_ms.py").write_text(
        "def read(ctx):\n    return ctx.per_block_ms('loader.time')\n")

    bench["configs"].append(dict(bench["configs"][0], name="sphere3m-l6",
                                 file="portbench/configs/sphere3m-l6.json"))
    bench["workloads"].append({"name": "sphere3m-l6.raw",
                               "config": "sphere3m-l6", "traffic": "raw",
                               "chips": 1, "why": "a new cell"})
    bench["per_layer"].append({"name": "loader_ms", "unit": "ms/block",
                               "better": "lower", "source": "program_span",
                               "layer": "streamer", "moves": "msplats_per_s"})
    (co / "BENCHMARK.json").write_text(json.dumps(bench))

    code = f"""
import json, sys
sys.path.insert(0, {str(co)!r})
from portbench import catalog, harness
from portbench.context import MetricContext
assert catalog.HERE.startswith({str(co)!r})
bench = catalog.benchmark({str(co)!r})
cell = catalog.load_cell(bench, "sphere3m-l6.raw")
cfg = harness.cell_config(cell, rehearse=False)
opts = harness.option_list(cfg, cell.traffic, 0.01)
ctx = MetricContext(jobs=2, splats=10,
                    window_s=1.0, setup_s=1.0, peak_rss_bytes=1,
                    sink_bytes=0, field_bytes=4,
                    stats={{"loader.time": {{"type": "variable", "n": 4,
                                             "sum": 2.0, "sum2": 1.0}},
                           "bucket.count": {{"type": "counter",
                                             "total": 4}}}})
print(json.dumps({{"cells": catalog.cell_names(bench),
                  "splats": cfg["cloud"]["splats"], "opts": opts,
                  "per_layer": [m["name"] for m in cell.per_layer],
                  "read": catalog.read_metrics(cell.per_layer, ctx)}}))
"""
    rc, out, err = run_python(code, cwd=str(co), env=tmp_env)
    assert rc == 0, err[-3000:]
    got = json.loads(out.strip().splitlines()[-1])
    assert "sphere3m-l6.raw" in got["cells"]
    assert got["splats"] == 3000000
    assert got["opts"][got["opts"].index("--readback") + 1] == "raw"
    assert "loader_ms" in got["per_layer"]
    assert got["read"]["loader_ms"] == {"value": 500.0, "unit": "ms/block"}
    # metrics with nothing to read are left out, never reported as 0
    assert "field_roofline_pct" not in got["read"]
    after = digests(co / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before
