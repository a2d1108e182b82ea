"""Real processes over torch.distributed (gloo) and a TCPStore, through
`python -m mlsgpu_tpu_torch --device cpu --coordinator ... --num-processes N
--process-id R` (the analogue of the reference's `mpirun -n 4` on one box,
wscript:543-551): two ranks reconstruct, four ranks checkpoint and two
resume, a dead rank ends its peers non-zero within DEAD_RANK_BOUND_S, and a
pair of ranks that starts on an empty build directory builds the native
library once between them. All comparisons are exact (per-chunk vertex and
triangle arrays of the port against the port)."""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from mlsgpu_tpu_torch.io import ply
from mlsgpu_tpu_torch.utils.manifold import check_manifold

from tests import oracle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--fit-grid", "0.12", "--fit-smooth", "1.0", "--levels", "3",
        "--leaf-cells", "8", "--device", "cpu", "--no-progress",
        "--split-size", "40K"]
JOB_TIMEOUT_S = 240
#: A peer of a dead rank must be gone this long after the job started, with
#: MLSGPU_HB_TIMEOUT=5 (start-up and the survivor's own work included).
DEAD_RANK_BOUND_S = 90


@pytest.fixture(scope="module")
def cloud(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mp") / "cloud.ply")
    ply.write_splats_ply(path, oracle.sphere_cloud(
        [0.0, 0.0, 0.0], 3.0, 12000, 0.3, np.random.default_rng(13)))
    return path


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_job(n, args, env_extra=None, timeout=JOB_TIMEOUT_S):
    """Start n ranks of the port's CLI on a fresh coordinator port and wait
    for all; [(returncode, stderr)] by rank and the seconds it took. A port
    taken between the probe and rank 0's bind is tried again."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               MLSGPU_CONNECT_TIMEOUT="60")
    env.update(env_extra or {})
    for _ in range(3):
        port = _free_port()
        t0 = time.monotonic()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "mlsgpu_tpu_torch", "--coordinator",
             f"127.0.0.1:{port}", "--num-processes", str(n), "--process-id",
             str(r), *args], env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True) for r in range(n)]
        out = []
        try:
            for p in procs:
                _, err = p.communicate(
                    timeout=max(timeout - (time.monotonic() - t0), 1))
                out.append((p.returncode, err))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if not any("cannot host the coordinator store" in e for _, e in out):
            return out, time.monotonic() - t0
    raise RuntimeError("no free coordinator port in three tries")


def run_single(args):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "mlsgpu_tpu_torch", *args],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=JOB_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-2000:]


def chunks(tmp_path, stem):
    """{chunk suffix: (vertices, triangles)} of the files `stem`_*.ply."""
    out = {}
    for name in sorted(os.listdir(tmp_path)):
        if name.startswith(stem + "_") and name.endswith(".ply"):
            out[name[len(stem) + 1:]] = ply.read_mesh(str(tmp_path / name))
    return out


def assert_same_chunks(got, want):
    assert sorted(got) == sorted(want) and len(want) > 1
    for key in want:
        for a, b in zip(got[key], want[key]):
            np.testing.assert_array_equal(a, b, err_msg=key)
        assert check_manifold(*got[key]).is_manifold, key


@pytest.fixture(scope="module")
def direct(cloud, tmp_path_factory):
    d = tmp_path_factory.mktemp("direct")
    run_single(BASE + ["-o", str(d / "direct.ply"), cloud])
    return chunks(d, "direct")


@pytest.mark.parametrize("scatter", ["dynamic", "static"])
def test_two_ranks_reconstruct(cloud, tmp_path, direct, scatter):
    out, _ = run_job(2, BASE + ["--scatter", scatter, "--statistics", "-o",
                                str(tmp_path / "two.ply"), cloud])
    for rc, err in out:
        assert rc == 0, err[-2000:]
    assert_same_chunks(chunks(tmp_path, "two"), direct)
    assert "imbalance" in out[0][1]   # rank 0 logs the measured balance


def test_four_ranks_checkpoint_two_resume(cloud, tmp_path, direct):
    ckpt = str(tmp_path / "state.ckpt")
    out, _ = run_job(4, BASE + ["--checkpoint", ckpt, "-o",
                                str(tmp_path / "unused.ply"), cloud])
    for rc, err in out:
        assert rc == 0, err[-2000:]
    assert sorted(os.listdir(tmp_path)) == [
        f"state.ckpt.rank{r:04d}" for r in range(4)]
    out, _ = run_job(2, BASE + ["--resume", ckpt, "-o",
                                str(tmp_path / "resumed.ply")])
    for rc, err in out:
        assert rc == 0, err[-2000:]
    assert_same_chunks(chunks(tmp_path, "resumed"), direct)


@pytest.mark.parametrize("dead", [1, 0])
def test_dead_rank_ends_the_job(cloud, tmp_path, dead):
    """Rank `dead` exits after the blob pass (code 7). Its peers must not
    hang and must not exit 0: gloo raises on the closed socket, or the
    watchdog sees the stale heartbeat (rank 0's death takes the store with
    it, which counts as stale too)."""
    out, seconds = run_job(
        3, BASE + ["-o", str(tmp_path / "dead.ply"), cloud],
        env_extra={"MLSGPU_TEST_DIE_RANK": str(dead),
                   "MLSGPU_HB_TIMEOUT": "5"}, timeout=DEAD_RANK_BOUND_S)
    assert out[dead][0] == 7, out[dead][1][-2000:]
    for r, (rc, err) in enumerate(out):
        if r != dead:
            assert rc not in (0, None) and rc > 0, (r, rc, err[-2000:])
    assert seconds < DEAD_RANK_BOUND_S


def test_a_rank_without_a_coordinator_ends_with_an_error(cloud, tmp_path):
    """Rank 1 alone: no process hosts the store. The client gives up after
    MLSGPU_CONNECT_TIMEOUT seconds with an error, not a hang."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               MLSGPU_CONNECT_TIMEOUT="3")
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "mlsgpu_tpu_torch", "--coordinator",
         f"127.0.0.1:{_free_port()}", "--num-processes", "2", "--process-id",
         "1", *BASE, "-o", str(tmp_path / "x.ply"), cloud], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "no coordinator at" in proc.stderr
    assert time.monotonic() - t0 < 60


def test_pair_builds_native_library_on_empty_build_dir(cloud, tmp_path,
                                                       direct):
    """Both ranks need the native library at once and none is built: the
    locked build (utils/native_build.py) makes it once and both load it."""
    build = tmp_path / "build"
    build.mkdir()
    out, _ = run_job(2, BASE + ["--readback", "codes", "-o",
                                str(tmp_path / "fresh.ply"), cloud],
                     env_extra={"MLSGPU_TORCH_BUILD_DIR": str(build)})
    for rc, err in out:
        assert rc == 0, err[-2000:]
    assert "libmlsnative.so" in os.listdir(build)
    assert_same_chunks(chunks(tmp_path, "fresh"), direct)
