"""tools/bench_queues on the CPU at a tiny size: the command line as a
subprocess of its own per queue count, its statistics read back from its
output (the worker start by stage, the parent's time per block by stage),
one digest for every queue count, and no process of a run left behind
(chip_smoke.py phase 14 runs the same function on the card)."""

import json
import os
import subprocess
import sys

from mlsgpu_tpu_torch.ops import launches
from mlsgpu_tpu_torch.tools import bench_queues

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_run_cli_reads_the_runs_statistics(tmp_path, monkeypatch):
    # one intra-op thread in every process: on the CPU a block step's
    # float sums split by thread count, and a worker process gets its
    # share of the run's threads (workers.start_workers)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    path, spacing = bench_queues.write_cloud(6000, str(tmp_path))
    queues = ["--device", "cpu", "--device-threads"]
    one = bench_queues.run_cli(ROOT, path, spacing, [*queues, "1"])
    two = bench_queues.run_cli(ROOT, path, spacing, [*queues, "2"])
    assert one["digest"] == two["digest"] and one["vertices"] > 0
    assert one["blocks"] >= 1                            # no card here:
    assert one["launches"] == dict.fromkeys(launches.KERNELS, 0)
    assert one["spawned"] == 0 and one["ready_wait_s"] is None
    assert two["spawned"] == 2 and two["main_imported"] == 0
    # torch was imported once, by the worker server
    assert two["start_samples"]["torch_s"] == 1
    assert two["start_samples"]["start_s"] == 2
    assert two["start"]["torch_s"] > 0 and two["ready_wait_s"] >= 0
    assert sum(two["workers"].values()) == two["blocks"]
    for key in ("read_s", "block_wait_s", "decode_s", "mesher_s"):
        assert one["per_block"][key] is not None, key
    for key in ("send_copy_s", "proxy_wait_s", "worker_convert_s"):
        assert two["per_block"][key] is not None, key
    assert one["per_block"]["convert_s"] is not None
    assert two["per_block"]["convert_s"] is None   # the workers convert
    for run, workers in ((one, 1), (two, 2)):
        pace = run["pace"]
        assert pace["decode_threads"] == min(workers, max(
            1, len(os.sched_getaffinity(0)) // 2))
        assert 0 < pace["consumer_busy_share"] <= 1
        assert pace["consumer_wait_s"] >= 0 and pace["slot_wait_s"] >= 0
        assert run["per_block"]["slot_wait_s"] is not None
    assert one["left_running"] == two["left_running"] == []
    assert two["wall_s"] >= two["run_s"] > 0
    assert one["import_s"] > 0 and two["import_s"] > 0


def test_session_pids_finds_a_running_process():
    proc = subprocess.Popen([sys.executable, "-c",
                             "import sys; sys.stdin.read()"],
                            stdin=subprocess.PIPE, start_new_session=True)
    try:
        assert bench_queues.session_pids(proc.pid) == [proc.pid]
    finally:
        proc.communicate(timeout=30)
    assert bench_queues.session_pids(proc.pid) == []


def test_summary_ratios(tmp_path, monkeypatch):
    """main() runs every (cloud, queues) once per root in the order given
    and sets each wall against its root's one-queue runs."""
    walls = iter([10.0, 12.0, 15.0, 18.0])

    def fake(root, path, spacing, extra, timeout=900.0):
        return {"wall_s": next(walls), "digest": "d", "left_running": []}

    monkeypatch.setattr(bench_queues, "run_cli", fake)
    monkeypatch.setattr(bench_queues, "write_cloud",
                        lambda n, work: (str(tmp_path / "c.ply"), 0.1))
    (tmp_path / "c.ply").write_bytes(b"")
    out = []
    monkeypatch.setattr("builtins.print", lambda s, **kw: out.append(s))
    assert bench_queues.main(["--splats", "100", "--queues", "1", "2",
                              "--roots", "a=x", "b=y", "--warmup-splats",
                              "0", "--workdir", str(tmp_path)]) == 0
    summary = json.loads(out[-1][len("SUMMARY "):])
    assert summary["wall_ratio_to_1_queue"] == {
        "a 100 cuda:0 1": [1.0], "b 100 cuda:0 1": [1.0],
        "a 100 cuda:0 2": [1.5], "b 100 cuda:0 2": [1.5]}
    assert summary["one_digest_per_cloud"] and summary["left_running"] == 0


def test_pace_of_a_tree_whose_consumer_decoded():
    """A tree that records no consumer.busy (its mesher thread decoded
    too): the busy share is its decode and mesher time over pass 1."""
    stats = {"pass1.time": {"sum": 10.0}, "readback.decode": {"sum": 3.0},
             "mesher.time": {"sum": 2.0}}
    pace = bench_queues.pace(stats)
    assert pace["consumer_busy_share"] == 0.5
    assert pace["consumer_wait_share"] is None
    assert pace["decode_threads"] is None


def test_profile_runs_print_each_workers_step_split(tmp_path, monkeypatch):
    """--profile: one traced run per profile root and queue count, with
    MLSGPU_PROFILE_STEPS naming a directory of its own, whose summaries
    come back by worker in a PROFILE line."""
    seen = []

    def fake(root, path, spacing, extra, timeout=900.0, env=None):
        if env:
            seen.append((root, extra[-1]))
            with open(os.path.join(env["MLSGPU_PROFILE_STEPS"],
                                   "device.0.0.7.json"), "w") as f:
                json.dump({"worker": "device.0.0", "steps": 4}, f)
        return {"wall_s": 1.0, "pass1_s": 0.5, "digest": "d",
                "left_running": []}

    monkeypatch.setattr(bench_queues, "run_cli", fake)
    monkeypatch.setattr(bench_queues, "write_cloud",
                        lambda n, work: (str(tmp_path / "c.ply"), 0.1))
    (tmp_path / "c.ply").write_bytes(b"")
    out = []
    monkeypatch.setattr("builtins.print", lambda s, **kw: out.append(s))
    assert bench_queues.main(["--splats", "100", "--queues", "1",
                              "--roots", "a=x", "--warmup-splats", "0",
                              "--workdir", str(tmp_path), "--profile",
                              str(tmp_path / "p"), "--profile-queues", "1",
                              "2", "--profile-roots", "b=y"]) == 0
    assert seen == [(os.path.abspath("y"), "1"), (os.path.abspath("y"), "2")]
    lines = [json.loads(s[len("PROFILE "):]) for s in out
             if s.startswith("PROFILE ")]
    assert [(p["root"], p["queues"]) for p in lines] == [("b", 1), ("b", 2)]
    assert lines[0]["workers"] == {"device.0.0": {"worker": "device.0.0",
                                                  "steps": 4}}
