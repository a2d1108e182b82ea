"""The port's timeplot (mlsgpu_tpu_torch/utils/timeplot.py): nested actions
and their wall and thread CPU time, the intervals kept in memory and
written when the file closes, and the driver's phases and the --profile
anchor of a CLI run."""

import contextlib
import json
import os
import time

import numpy as np
import pytest

from mlsgpu_tpu_torch import cli
from mlsgpu_tpu_torch.io import ply
from mlsgpu_tpu_torch.utils import timeplot
from mlsgpu_tpu_torch.utils.statistics import Variable, get_registry

from tests import oracle


def events(path):
    with open(path) as f:
        return [ln.split() for ln in f if ln.startswith("EVENT ")]


def spin(seconds):
    """Busy on this thread for `seconds` of wall time."""
    end = time.monotonic() + seconds
    n = 0
    while time.monotonic() < end:
        n += 1
    return n


@pytest.fixture
def closed_plot():
    """No timeplot file open before or after the test."""
    timeplot.init(None)
    yield
    timeplot.init(None)


def test_a_busy_child_gets_the_cpu_and_a_sleeping_parent_almost_none(
        closed_plot):
    """Each action's `stat` gets its wall time and `cpu_stat` its thread
    CPU time, from enter to exit, children included: a child that spins
    has CPU time near its wall time, a parent that sleeps beside it adds
    almost none, and the parent's wall time holds its sleep and the
    child's."""
    w = timeplot.Worker("main")
    wall = {k: Variable(k) for k in ("parent", "child")}
    cpu = {k: Variable(k) for k in ("parent", "child")}
    with timeplot.Action("parent", w, wall["parent"], cpu["parent"]):
        time.sleep(0.2)
        with timeplot.Action("child", w, wall["child"], cpu["child"]):
            spin(0.2)
    assert wall["child"].sum >= 0.2 and wall["parent"].sum >= 0.4
    assert wall["parent"].sum >= wall["child"].sum + 0.2
    assert 0.1 <= cpu["child"].sum <= wall["child"].sum
    assert cpu["parent"].sum >= cpu["child"].sum
    assert cpu["parent"].sum - cpu["child"].sum < 0.05
    assert all(v.n == 1 for v in (*wall.values(), *cpu.values()))
    assert w._stack == []


def test_intervals_are_written_when_the_file_closes(tmp_path, closed_plot):
    """With a file open, nothing reaches it until it is closed; then every
    EVENT line has five fields and a worker's running intervals, its
    children cut out, touching end to end: the parent's, the child's, the
    parent's again. A new init closes the old file the same way."""
    path, other = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    timeplot.init(path)
    w = timeplot.Worker("main", 3)
    outer = Variable("outer")
    with timeplot.Action("outer", w, outer):
        time.sleep(0.01)
        with timeplot.Action("inner", w):
            time.sleep(0.01)
        time.sleep(0.01)
    timeplot.record("proc.1", "compute", 1.5, 2.25)
    assert os.path.getsize(path) == 0
    timeplot.init(other)
    got = events(path)
    assert all(len(e) == 5 for e in got)
    assert [(e[1], e[2]) for e in got] == [
        ("main.3", "outer"), ("main.3", "inner"), ("main.3", "outer"),
        ("proc.1", "compute")]
    times = [(float(e[3]), float(e[4])) for e in got[:3]]
    assert all(lo <= hi for lo, hi in times)
    assert times[0][1] == times[1][0] and times[1][1] == times[2][0]
    assert (float(got[3][3]), float(got[3][4])) == (1.5, 2.25)
    # the outer action's wall time is its intervals' sum, the child's too
    assert outer.sum == pytest.approx(times[2][1] - times[0][0], abs=1e-9)
    with timeplot.Action("late", w):
        pass
    timeplot.init(None)
    assert [e[2] for e in events(other)] == ["late"]


def test_nothing_is_kept_without_a_file(closed_plot):
    """With no file open an action keeps no interval, only its statistics;
    the API that read nothing is gone."""
    w = timeplot.Worker("main")
    stat = Variable("s")
    with timeplot.Action("a", w, stat):
        with timeplot.Action("b", w):
            pass
    timeplot.record("w", "a", 0.0, 1.0)
    assert timeplot._spans is None and timeplot._file is None
    assert stat.n == 1
    assert not hasattr(timeplot, "action")
    a = timeplot.Action("a", w)
    assert not hasattr(a, "set_value") and not hasattr(a, "value_stat")


def test_a_cli_run_plots_the_drivers_phases(tmp_path, closed_plot):
    """A CLI run's --timeplot file has the `driver` worker's actions
    `blob_pass`, `bucketing` and `write`, with the write's passes nested
    in it, in that order around pass 1 (the mesher's actions fall
    between bucketing and the write); each phase's process CPU time is
    one sample beside its wall time."""
    splats = oracle.sphere_cloud([0.7, -0.3, 0.2], 1.0, 1500, 0.3,
                                 np.random.default_rng(5))
    inp, out = str(tmp_path / "in.ply"), str(tmp_path / "out.ply")
    trace = str(tmp_path / "trace.txt")
    ply.write_splats_ply(inp, splats)
    get_registry().clear()
    assert cli.main(["--fit-grid", "0.1", "--fit-smooth", "1", "--levels",
                     "3", "--leaf-cells", "8", "--device", "cpu",
                     "--no-progress", "--timeplot", trace, "-o", out,
                     inp]) == 0
    got = events(trace)
    driver = sorted((float(e[3]), float(e[4]), e[2]) for e in got
                    if e[1] == "driver")
    names = [n for _, _, n in driver]
    assert {"blob_pass", "bucketing", "write", "write.passA",
            "write.verts", "write.tris"} == set(names)
    assert all(a[1] <= b[0] for a, b in zip(driver, driver[1:]))
    first = {n: names.index(n) for n in set(names)}
    last = {n: len(names) - 1 - names[::-1].index(n) for n in set(names)}
    assert last["blob_pass"] < first["bucketing"]
    assert last["bucketing"] < first["write"] < first["write.passA"]
    assert first["write.passA"] < first["write.verts"] < first["write.tris"]
    assert names[-1] == "write"
    bucketed = driver[last["bucketing"]][1]
    writing = driver[first["write"]][0]
    mesher = [(float(e[3]), float(e[4])) for e in got if e[1] == "mesher"]
    assert mesher and all(bucketed <= lo <= hi <= writing
                          for lo, hi in mesher)
    stats = get_registry().to_dict()
    for phase in ("pass0", "bucket", "pass1", "write"):
        assert stats[f"{phase}.cpu"]["n"] == 1, phase
    write_s = sum(hi - lo for lo, hi, n in driver if n.startswith("write"))
    assert stats["write.time"]["sum"] == pytest.approx(write_s, abs=1e-6)
    assert stats["pass0.time"]["sum"] == pytest.approx(
        sum(hi - lo for lo, hi, n in driver if n == "blob_pass"), abs=1e-6)


def test_the_profile_anchor_is_launched_and_written(tmp_path, monkeypatch):
    """--profile with --timeplot: the spin kernel is launched on an idle
    card between two synchronisations, at the time.monotonic() written to
    DIR/anchor.json (torch.cuda stood in for here)."""
    import torch
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append("sync"))
    monkeypatch.setattr(torch.cuda, "_sleep",
                        lambda cycles: calls.append(("sleep", cycles)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    t0 = time.monotonic()
    cli._anchor(str(tmp_path / "prof"), torch.device("cuda", 0))
    t1 = time.monotonic()
    assert calls == ["sync", ("sleep", 1000), "sync"]
    with open(tmp_path / "prof" / "anchor.json") as f:
        anchor = json.load(f)
    assert anchor["kernel"] == "spin_kernel"
    assert anchor["device"] == "cuda:0"
    assert t0 <= anchor["monotonic"] <= t1
