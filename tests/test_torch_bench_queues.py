"""tools/bench_queues on the CPU at a tiny size: the command line as a
subprocess of its own per queue count, its statistics read back from its
output (the worker start by stage, the parent's time per block by stage),
one digest for every queue count, and no process of a run left behind
(chip_smoke.py phase 14 runs the same function on the card)."""

import json
import os
import subprocess
import sys

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
    assert one["blocks"] >= 1 and one["launches"] == 0   # no card here
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
