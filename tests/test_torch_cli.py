"""The port's command line: a process in which importing jax fails runs
`python -m mlsgpu_tpu_torch` end to end on PLY input (the package is
jax-free), one in-process run each of `--readback packed`, `--readback raw`
and `--statistics-device`, and the exit-code probes (2 for bad or unported
options and for no inputs, 1 for a missing input file, an unknown
device, or device options that ask for more devices than there are)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mlsgpu_tpu_torch import cli
from mlsgpu_tpu_torch.io import ply
from mlsgpu_tpu_torch.utils.manifold import check_manifold

from tests import oracle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CENTER = np.array([0.7, -0.3, 0.2])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    oversubscribed torch threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

_JAX_FREE = """
import runpy, sys
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["mlsgpu_tpu"] = None   # nor may the JAX package be imported
sys.argv = ["mlsgpu_tpu_torch"] + sys.argv[1:]
try:
    runpy.run_module("mlsgpu_tpu_torch", run_name="__main__")
finally:
    assert sys.modules["jax"] is None
"""


def test_cli_runs_without_jax(tmp_path):
    """The package is jax-free: a process in which importing jax fails runs
    the CLI end to end on PLY input (plain path, --device cpu)."""
    inp = str(tmp_path / "in.ply")
    splats = oracle.sphere_cloud(CENTER, 3.0, 6000, 0.4,
                                 np.random.default_rng(21))
    ply.write_splats_ply(inp, splats)
    out = str(tmp_path / "out.ply")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_FREE, "--fit-grid", "0.1",
         "--fit-smooth", "1", "--levels", "3", "--leaf-cells", "8",
         "--device", "cpu", "--no-progress", "-o", out, inp],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    verts, tris = ply.read_mesh(out)
    rep = check_manifold(verts, tris)
    assert rep.is_manifold and rep.num_boundary_edges == 0, rep.reason
    r = np.linalg.norm(verts - CENTER, axis=1)
    assert len(verts) > 500 and abs(np.median(r) - 3.0) < 0.08


@pytest.mark.parametrize("argv,code", [
    (["--fit-grid", "-1", "-o", "x.ply", "in.ply"], 2),
    (["-o", "x.ply"], 2),                                  # no inputs
    # ported options: the run starts and stops at the missing input file
    (["--readback", "packed", "--device", "cpu", "-o", "x.ply", "in.ply"], 1),
    # --num-devices: more than one device needs --device cuda and as many
    # visible cards; never a quiet run on fewer (here no card is visible)
    (["--num-devices", "2", "-o", "x.ply", "in.ply"], 1),
    (["--num-devices", "2", "--device", "cpu", "-o", "x.ply", "in.ply"], 1),
    (["--num-devices", "2", "--device", "cuda:0", "-o", "x.ply", "in.ply"],
     1),
    (["--num-devices", "-1", "--device", "cpu", "-o", "x.ply", "in.ply"], 1),
    # one device on the CPU is fine: the run stops at the missing input
    (["--num-devices", "1", "--device-threads", "2", "--device", "cpu", "-o",
      "x.ply", "in.ply"], 1),
    # multi-host without --coordinator
    (["--num-processes", "2", "-o", "x.ply", "in.ply"], 2),
    (["--statistics-device", "--device", "cpu", "-o", "x.ply", "in.ply"], 1),
    (["--mls-backend", "pallas", "-o", "x.ply", "in.ply"], 2),
    (["--device", "tpu", "-o", "x.ply", "in.ply"], 1),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2", "--process-id",
      "2", "-o", "x.ply", "in.ply"], 2),                   # rank out of range
])
def test_cli_probes(argv, code, tmp_path, capsys):
    argv = [a if a != "x.ply" else str(tmp_path / a) for a in argv]
    assert cli.main(argv) == code
    err = capsys.readouterr().err
    assert "error:" in err
    if "--num-devices" in argv:
        option_error = "--num-devices" in err or "CUDA device requested" in err
        assert option_error == (argv[argv.index("--num-devices") + 1] != "1")


def test_num_devices_beyond_the_visible_cards(monkeypatch, tmp_path, capsys):
    """With two cards visible `--num-devices 3` stops with the option
    error before any input is opened."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert cli.main(["--num-devices", "3", "-o", str(tmp_path / "x.ply"),
                     "in.ply"]) == 1
    assert "--num-devices 3: only 2 card(s) visible" in capsys.readouterr().err


@pytest.fixture(scope="module")
def small_ply(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "in.ply")
    ply.write_splats_ply(path, oracle.sphere_cloud(
        CENTER, 3.0, 5000, 0.4, np.random.default_rng(5)))
    return path


@pytest.mark.parametrize("extra", [["--readback", "packed"],
                                   ["--readback", "raw"],
                                   ["--statistics-device", "--statistics"]])
def test_cli_readback_and_statistics_device(small_ply, tmp_path, capsys,
                                            extra):
    out = str(tmp_path / "out.ply")
    assert cli.main(["--fit-grid", "0.1", "--fit-smooth", "1", "--levels",
                     "4", "--leaf-cells", "8", "--device", "cpu",
                     "--no-progress", *extra, "-o", out, small_ply]) == 0
    verts, tris = ply.read_mesh(out)
    rep = check_manifold(verts, tris)
    assert rep.is_manifold and rep.num_boundary_edges == 0, rep.reason
    r = np.linalg.norm(verts - CENTER, axis=1)
    assert len(verts) > 500 and abs(np.median(r) - 3.0) < 0.08
    if "--statistics-device" in extra:
        printed = capsys.readouterr().out
        for stage in ("binning", "segments", "mls", "faces", "marching",
                      "pack"):
            assert f"device.{stage}.time" in printed
