"""The port's tools package against the JAX package's tools on the same
inputs, on the CPU. The copied tools print the same text (exact); the bench
cloud and the procedural scan are bitwise equal; both packages' verify
return the same dict on a port chunked output (apart from elapsed_s); the
bench tools run at small sizes and print their keys."""

import contextlib
import functools
import io
import json
import os

import numpy as np
import pytest
import torch

import bench as jbench
from mlsgpu_tpu.tools import analyze_stats as j_analyze_stats
from mlsgpu_tpu.tools import analyze_timeplot as j_analyze_timeplot
from mlsgpu_tpu.tools import bench_ooc as j_bench_ooc
from mlsgpu_tpu.tools import draw_timeplot as j_draw_timeplot
from mlsgpu_tpu.tools import plyio as j_plyio
from mlsgpu_tpu.tools import plymanifold as j_plymanifold
from mlsgpu_tpu.tools import plypntcat as j_plypntcat
from mlsgpu_tpu.tools import simulate as j_simulate
from mlsgpu_tpu.tools import verify_chunks as j_verify
from mlsgpu_tpu_torch import cli
from mlsgpu_tpu_torch.io import ply
from mlsgpu_tpu_torch.io.splat_set import SequenceSource
from mlsgpu_tpu_torch.pipeline import reconstruct as trec
from mlsgpu_tpu_torch.tools import (analyze_stats, analyze_timeplot,
                                    bench_ooc, bench_split, bench_stage,
                                    cloud, draw_timeplot, plyio, plymanifold,
                                    plypntcat, simulate, verify_chunks)

from tests import oracle
from tests.test_torch_reconstruct import RADIUS, small_config

# Off the grid planes: a pole that lies exactly on a cell plane leaves a
# degenerate sliver whose corner signs are float noise.
CENTER = np.array([0.73, -0.31, 0.24])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def printed(main, argv):
    """(return code, stdout, stderr) of one tool's main(argv)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """One small CLI run of the port that leaves what the tools read: the
    input cloud in two PLY files, a chunked output, a statistics file and a
    timeplot trace."""
    d = tmp_path_factory.mktemp("tools")
    splats = oracle.sphere_cloud(CENTER, RADIUS, 20000, 0.25,
                                 np.random.default_rng(21))
    ply.write_splats_ply(str(d / "a.ply"), splats[:12000])
    ply.write_splats_ply(str(d / "b.ply"), splats[12000:])
    rc = cli.main(["--fit-grid", "0.1", "--fit-smooth", "1", "--levels", "3",
                   "--leaf-cells", "8", "--device", "cpu", "--no-progress",
                   "--split-size", "100K", "--statistics-file",
                   str(d / "stats.txt"), "--timeplot", str(d / "trace.txt"),
                   "-o", str(d / "out.ply"), str(d / "a.ply"),
                   str(d / "b.ply")])
    assert rc == 0
    return d


def chunk_files(d, stem="out"):
    return sorted(str(d / n) for n in os.listdir(d)
                  if n.startswith(stem + "_") and n.endswith(".ply"))


def test_plymanifold_prints_what_the_jax_tool_prints(run_dir):
    files = chunk_files(run_dir)
    assert len(files) > 1
    got = printed(plymanifold.main, files)
    assert got == printed(j_plymanifold.main, files)
    assert got[0] == 0 and "manifold" in got[1]


def test_plypntcat_prints_and_writes_what_the_jax_tool_does(run_dir):
    inputs = [str(run_dir / "a.ply"), str(run_dir / "b.ply")]
    out = str(run_dir / "cat.ply")
    got = printed(plypntcat.main, ["-o", out, *inputs])
    with open(out, "rb") as f:
        port_bytes = f.read()
    assert got == printed(j_plypntcat.main, ["-o", out, *inputs])
    with open(out, "rb") as f:
        assert f.read() == port_bytes
    assert got[0] == 0 and "20000 splats from 2 file(s)" in got[1]


def test_plyio_reads_what_the_jax_module_reads(run_dir):
    f = chunk_files(run_dir)[0]
    for a, b in zip(plyio.read_mesh_any(f), j_plyio.read_mesh_any(f)):
        np.testing.assert_array_equal(a, b)
    s = str(run_dir / "a.ply")
    np.testing.assert_array_equal(plyio.read_splats_any(s, smooth=2.0),
                                  j_plyio.read_splats_any(s, smooth=2.0))
    assert sorted(plyio.read_ply(f)) == sorted(j_plyio.read_ply(f))


@pytest.mark.parametrize("port,ref,name,extra", [
    (analyze_stats, j_analyze_stats, "stats.txt", []),
    (analyze_timeplot, j_analyze_timeplot, "trace.txt", []),
    (simulate, j_simulate, "trace.txt", []),
    (simulate, j_simulate, "trace.txt", ["--window", "4", "--loaders", "2"]),
])
def test_report_tools_print_what_the_jax_tools_print(run_dir, port, ref, name,
                                                     extra):
    argv = [str(run_dir / name), *extra]
    got = printed(port.main, argv)
    assert got == printed(ref.main, argv)
    assert got[0] == 0 and len(got[1].splitlines()) >= 2


def test_draw_timeplot_draws_what_the_jax_tool_draws(run_dir):
    trace = str(run_dir / "trace.txt")
    svgs = []
    for mod, name in ((draw_timeplot, "port.svg"), (j_draw_timeplot,
                                                    "jax.svg")):
        out = str(run_dir / name)
        rc, text, _ = printed(mod.main, [trace, "-o", out])
        assert rc == 0
        with open(out) as f:
            svgs.append((text.replace(name, "X"), f.read()))
    assert svgs[0] == svgs[1] and "<svg" in svgs[0][1]


@pytest.mark.parametrize("n,seed", [(1000, 123), (20011, 7)])
def test_make_cloud_bitwise_equals_bench(n, seed):
    got, sr = cloud.make_cloud(n, seed)
    want, jsr = jbench.make_cloud(n, seed)
    assert sr == jsr and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def test_procedural_scan_source_bitwise_equals_jax():
    kw = dict(n=100_003, radius=2.5, splat_scale=1.6)
    port = bench_ooc.ProceduralScanSource(**kw)
    ref = j_bench_ooc.ProceduralScanSource(**kw)
    assert len(port) == len(ref) and port.splat_radius == ref.splat_radius
    for (s0, a), (s1, b) in zip(port.iter_chunks(30_000),
                                ref.iter_chunks(30_000)):
        assert s0 == s1 and a.tobytes() == b.tobytes()
    ranges = [(5, 9), (70_000, 70_010), (99_990, 100_003), (0, 1)]
    assert (port.read_ranges(ranges).tobytes()
            == ref.read_ranges(ranges).tobytes())
    assert port.read_ranges([]).shape == (0, 8)
    # past the 512k generation step: the chunked path
    big = bench_ooc.ProceduralScanSource(1_200_000)
    jbig = j_bench_ooc.ProceduralScanSource(1_200_000)
    assert (big.read_ranges([(0, 1_200_000)]).tobytes()
            == jbig.read_ranges([(0, 1_200_000)]).tobytes())


def _verify_both(base, **kw):
    quiet = dict(log=lambda s: None, **kw)
    port, ref = verify_chunks.verify(base, **quiet), j_verify.verify(base,
                                                                     **quiet)
    port.pop("elapsed_s")
    ref.pop("elapsed_s")
    assert port == ref
    return port


def test_verify_equals_jax_on_port_output(run_dir):
    base = str(run_dir / "out.ply")
    res = _verify_both(base, sample=4)
    assert res["ok"] and res["chunks"] == len(chunk_files(run_dir))
    assert res["manifold"] == {"sampled": 4, "failures": 0, "reports": []}
    assert res["continuity"]["checked"] > 0
    assert res["continuity"]["mismatched_pairs"] == 0
    geom = verify_chunks.parse_geom_comment(chunk_files(run_dir)[0])
    assert geom["chunk_cells"] == 31 and geom["spacing"] == pytest.approx(0.1)
    rc, text, _ = printed(verify_chunks.main, ["--quiet", base])
    assert rc == 0 and json.loads(text)["ok"]


def _copy_chunks(src_dir, dst_dir):
    for f in chunk_files(src_dir):
        with open(f, "rb") as a, open(dst_dir / os.path.basename(f),
                                      "wb") as b:
            b.write(a.read())
    return str(dst_dir / "out.ply")


def test_planted_one_ulp_twin_fails_both_verifies(run_dir, tmp_path):
    """One vertex that both files of a cut plane share, moved by one ulp in
    one file: a near twin, which neither verify may pass."""
    base = _copy_chunks(run_dir, tmp_path)
    chunks = verify_chunks.discover_chunks(base)
    planted = False
    for coords, path in sorted(chunks.items()):
        nb = (coords[0] + 1, coords[1], coords[2])
        if nb not in chunks:
            continue
        va = np.array(verify_chunks.read_vertices(path))
        vb = np.array(verify_chunks.read_vertices(chunks[nb]))
        pv, _ = verify_chunks._plane_value(va[:, 0], vb[:, 0])
        if pv is None:
            continue
        on_a = va[:, 0].view(np.uint32) == pv
        shared = np.intersect1d(verify_chunks._triple_set(va[on_a]),
                                verify_chunks._triple_set(vb))
        # a y well away from zero, so one ulp is a real displacement
        cand = [r for r in shared
                if abs(np.uint32(r["y"]).view(np.float32)) > 0.5]
        if not cand:
            continue
        r = cand[0]
        row = int(np.flatnonzero(
            (va.view(np.uint32) == np.array([r["x"], r["y"], r["z"]],
                                            np.uint32)).all(axis=1))[0])
        header = ply.parse_header(open(path, "rb").read(65536),
                                  need_splat_fields=False)
        with open(path, "r+b") as f:
            f.seek(header.header_size + 12 * row + 4)
            f.write(np.array([r["y"] + 1], np.uint32).tobytes())
        planted = True
        break
    assert planted
    res = _verify_both(base, sample=0)
    # (the vertex may lie on a second cut plane too)
    assert not res["ok"] and res["continuity"]["mismatched_pairs"] >= 1
    assert "near-twin" in res["continuity"]["examples"][0]


def test_verify_passes_without_checking_when_geom_comment_is_missing(
        run_dir, tmp_path):
    """The inherited defect: without the geom comment continuity is skipped
    and verify still says ok, so callers assert `checked > 0` themselves."""
    base = _copy_chunks(run_dir, tmp_path)
    for f in chunk_files(tmp_path):
        data = open(f, "rb").read()
        assert b"comment mlsgpu_tpu geom" in data
        with open(f, "wb") as out:
            out.write(data.replace(b"comment mlsgpu_tpu geom",
                                   b"comment mlsgpu_tpu gone"))
    res = _verify_both(base, sample=2)
    assert res["ok"] and "checked" not in res["continuity"]
    assert res["continuity"] == {"note": "no geom comment; skipped"}


def test_bench_ooc_spills_and_verifies(tmp_path):
    """200k splats with budgets small enough that the blob store and the
    mesher spill to disk; the run verifies its own chunks."""
    from mlsgpu_tpu_torch.utils.statistics import get_registry
    get_registry().clear()
    rc, text, _ = printed(bench_ooc.main, [
        "--splats", "200000", "--device", "cpu", "--levels", "4",
        "--grid-scale", "2", "--split-size", "2M", "--mem-blobs", "4K",
        "--mem-load-splats", "64M", "--mem-host-splats", "64M", "--mem-mesh",
        "1M", "--mem-reorder", "256K", "--out", str(tmp_path / "o" / "out.ply")])
    res = json.loads(text.splitlines()[-1])
    assert rc == 0, res
    assert res["rss_ok"] and res["output_files"] > 8
    assert set(res) >= {"metric", "splats", "elapsed_s", "msplats_per_s",
                        "peak_rss_gb", "rss_budget_gb", "verify"}
    assert res["verify"]["ok"]
    assert res["verify"]["continuity"]["checked"] > 0
    stats = get_registry()
    assert stats.counter("blobs.spilled").get() == 1
    assert stats.counter("spill.flushBytes").get() > 0
    assert 0 < stats.peak("mem.meshWindow").peak <= 2 << 20


def test_bench_ooc_fails_over_the_rss_budget(tmp_path):
    rc, text, _ = printed(bench_ooc.main, [
        "--splats", "20000", "--device", "cpu", "--levels", "3",
        "--grid-scale", "2", "--rss-budget", "1M", "--verify", "0", "--out",
        str(tmp_path / "o" / "out.ply")])
    res = json.loads(text.splitlines()[-1])
    assert rc == 1 and not res["rss_ok"] and "verify" not in res


def test_bench_ooc_default_output_honours_tmpdir(tmp_path, monkeypatch):
    """Without --out the mesh goes into a fresh directory of the system's
    temporary directory, never to a fixed path two runs would share."""
    import tempfile
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    outs = []
    for _ in range(2):
        rc, text, _ = printed(bench_ooc.main, [
            "--splats", "20000", "--device", "cpu", "--levels", "3",
            "--grid-scale", "2", "--verify", "0"])
        res = json.loads(text.splitlines()[-1])
        assert rc == 0, res
        outs.append(res["out"])
    assert outs[0] != outs[1]
    for out in outs:
        assert os.path.dirname(os.path.dirname(out)) == str(tmp_path)
        assert verify_chunks.discover_chunks(out)


def _twins(verify, base):
    """(near-twin crack vertices, on-plane vertices compared, continuity)
    from one package's verify of the chunk files of `base`; every mismatched
    pair must be a pair of near-twin cracks and nothing else."""
    import re
    pat = re.compile(r"^pair .*: (\d+) on-plane verts, .*?(OK|(\d+) CRACKS)$")
    lines = []
    res = verify(base, sample=0, log=lines.append)
    hits = [m for m in map(pat.match, lines) if m]
    cont = res["continuity"]
    assert cont["checked"] == cont["pairs"] == len(hits) > 0
    assert cont["missing"] == 0
    assert cont["mismatched_pairs"] == sum(1 for m in hits if m.group(3))
    return (sum(int(m.group(3) or 0) for m in hits),
            sum(int(m.group(1)) for m in hits), cont)


def test_near_twin_cracks_are_the_jax_packages_too(tmp_path, monkeypatch):
    """The known seam defect (the two copies of one cut-plane vertex a few
    ulps apart) on its cheap reproducer, 200k splats in one block per
    chunk: the JAX package shows it on the same input, and the port no
    more than twice as often (seen: 18 vertices in the port, 12 in the JAX
    package, of 14,512 on-plane vertices). Both packages' verify reject
    both outputs for it.

    Both tools run readback "packed", named: the twins depend on the mode
    (codes gives 12 and 16), and with "auto" each package resolves it from
    its own native library. Packed decodes with or without either."""
    from mlsgpu_tpu import config as jconfig
    from mlsgpu_tpu_torch import config as pconfig
    for mod in (jconfig, pconfig):
        monkeypatch.setattr(mod, "ReconstructConfig", functools.partial(
            mod.ReconstructConfig, readback="packed"))
    args = ["--splats", "200000", "--levels", "4", "--split-size", "2M",
            "--verify", "0"]
    port_out = str(tmp_path / "port" / "out.ply")
    jax_out = str(tmp_path / "jax" / "out.ply")
    assert printed(bench_ooc.main,
                   [*args, "--device", "cpu", "--out", port_out])[0] == 0
    assert printed(j_bench_ooc.main, [*args, "--out", jax_out])[0] == 0
    port_twins, port_on_plane, port_cont = _twins(verify_chunks.verify,
                                                  port_out)
    jax_twins, jax_on_plane, jax_cont = _twins(j_verify.verify, jax_out)
    assert port_cont["pairs"] == jax_cont["pairs"]
    assert port_on_plane == jax_on_plane
    assert jax_twins > 0
    assert port_twins <= 2 * jax_twins
    # each package's verify says the same of the other's files
    assert _twins(j_verify.verify, port_out)[0] == port_twins
    assert _twins(verify_chunks.verify, jax_out)[0] == jax_twins


def test_bench_stage_prints_its_prefixes():
    rc, text, _ = printed(bench_stage.main, ["--splats", "20000", "--reps",
                                             "1", "--levels", "4",
                                             "--device", "cpu"])
    assert rc == 0
    res = json.loads(text.splitlines()[-1])
    assert list(res["prefix_ms"]) == list(bench_stage.PREFIXES)
    assert all(v > 0 for v in res["prefix_ms"].values())
    assert "perf_counter" in res["prefix_ms_clock"]
    assert "prefix_event_ms" not in res       # CUDA events: on the card only
    assert res["device"] == "cpu" and res["splats"] > 0


def test_bench_split_prints_its_passes():
    rc, text, _ = printed(bench_split.main, ["20000", "--device", "cpu"])
    assert rc == 0
    lines = [json.loads(ln) for ln in text.splitlines()]
    assert [ln["pass"][0] for ln in lines[:3]] == ["w", "A", "B"]
    a, b = lines[1], lines[2]
    assert a["readback.bytes"] == 0 and b["readback.bytes"] > 0
    assert a["blocks"] == b["blocks"] >= 1
    assert "readback.decode" in b and "readback.decode" not in a
    assert set(lines[3]) >= {"transfer+decode_s", "per_block_ms", "readback"}


def test_bench_split_over_two_queues():
    rc, text, _ = printed(bench_split.main, ["6000", "--device", "cpu",
                                             "--device-threads", "2"])
    assert rc == 0
    last = json.loads(text.splitlines()[-1])
    assert last["devices"] == ["cpu"] and last["queues_per_device"] == 2


def test_streamer_counts_only_pass_matches_full_pass():
    """stream_blocks(read_images=False) runs the same block steps and
    yields the same counts, with no image."""
    from mlsgpu_tpu_torch.pipeline import blobs as blobs_mod
    from mlsgpu_tpu_torch.pipeline import bucket as bucket_mod
    from mlsgpu_tpu_torch.pipeline.streamer import stream_blocks
    cfg = small_config(levels=4)
    src = SequenceSource(oracle.sphere_cloud(
        CENTER, RADIUS, 6000, 0.4, np.random.default_rng(3)))
    info = blobs_mod.compute_blobs(src, cfg.fit_grid, cfg.micro_cells)
    buckets = bucket_mod.make_buckets(info, cfg.device_block_cells,
                                      cfg.micro_cells, max_splats=200000)
    dev, rb = trec.prepare_run(cfg, "cpu")
    full = list(stream_blocks(src, info, buckets, cfg, dev, rb))
    bare = list(stream_blocks(src, info, buckets, cfg, dev, rb,
                              read_images=False))
    assert len(full) == len(bare) == len(buckets) > 1
    for (b0, r0), (b1, r1) in zip(full, bare):
        assert b0 is b1 and r1.arrays == () and len(r0.arrays) == 1
        np.testing.assert_array_equal(r0.counts, r1.counts)
