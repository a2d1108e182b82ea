"""The port stands alone: no module of `mlsgpu_tpu_torch` (its `tools` and
`parallel` sub-packages included), nor its command line, nor
`chip_smoke.py`, imports the JAX package `mlsgpu_tpu`, `jax`, or the JAX
package's benchmark script `bench.py` at the root of the repo.

A subprocess installs a `sys.meta_path` finder that raises on any import of
either, then imports every module of the port and runs
`python -m mlsgpu_tpu_torch --help` and every tool as
`python -m mlsgpu_tpu_torch.tools.<name>`; `chip_smoke.py` is checked with
`ast` (it needs a card to run). A worker process of the streamer starts
from `pipeline/worker_start.py`, forked from a server that has imported
`pipeline/worker_preload.py`; tests/test_torch_workers.py checks what such
a process has imported while it runs blocks. The command line and
`worker_start` import no torch, so that the server starts first."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("mlsgpu_tpu", "jax", "jaxlib", "bench")

_GUARD = """
import importlib.abc, sys
FORBIDDEN = {forbidden!r}

class Forbid(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("the port imported " + name)
        return None

sys.meta_path.insert(0, Forbid())
for name in FORBIDDEN:
    sys.modules.pop(name, None)
""".format(forbidden=FORBIDDEN)

_IMPORT_ALL = _GUARD + """
import importlib, pkgutil
import mlsgpu_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mlsgpu_tpu_torch.__path__,
                                               "mlsgpu_tpu_torch.")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
assert not bad, bad
for sub in ("tools.verify_chunks", "tools.bench_ooc", "tools.cloud",
            "tools.bench_d2h", "tools.bench_micro", "tools.bench_micro2",
            "parallel.multihost", "parallel.sharded", "pipeline.workers",
            "ops.seam_cuda"):
    assert "mlsgpu_tpu_torch." + sub in names, sub
print(len(names))
"""

# What a worker process imports before its first block: the module of its
# target, the worker server's preload and those of the pickled block step.
_IMPORT_WORKER = _GUARD + """
import mlsgpu_tpu_torch.pipeline.worker_start
import mlsgpu_tpu_torch.pipeline.worker_preload
import mlsgpu_tpu_torch.pipeline.workers as w
from mlsgpu_tpu_torch.ops.block import block_step, block_step_staged
from mlsgpu_tpu_torch.pipeline.mesh_filter import DeviceFilterChain
bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
assert not bad, bad
print(w._worker_main.__module__)
"""

_RUN_HELP = _GUARD + """
import runpy
sys.argv = ["mlsgpu_tpu_torch", "--help"]
runpy.run_module("mlsgpu_tpu_torch", run_name="__main__")
"""


def _run(code):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_every_module_imports_without_jax_package():
    proc = _run(_IMPORT_ALL)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) > 59      # every module was imported


def test_worker_process_imports_without_jax_package():
    proc = _run(_IMPORT_WORKER)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "mlsgpu_tpu_torch.pipeline.workers"


_NO_TORCH = """
import sys
import mlsgpu_tpu_torch.cli as cli
import mlsgpu_tpu_torch.pipeline.worker_start
cli.config_from_args(cli.build_parser().parse_args(["-o", "x", "y"]))
print(sorted(m for m in sys.modules if m.split(".")[0] == "torch")[:3])
"""


def test_cli_and_worker_start_import_no_torch():
    """The command line reaches its worker server's start (worker_start,
    from its parsed options) before anything imports torch, so that the
    server's import of torch runs beside the command line's own."""
    proc = _run(_NO_TORCH)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[-2] == "[]"


def test_cli_help_without_jax_package():
    proc = _run(_RUN_HELP)
    assert proc.returncode == 0, proc.stderr
    assert "usage: mlsgpu_tpu_torch" in proc.stdout
    assert "--device" in proc.stdout and "--readback" in proc.stdout


_RUN_TOOL = _GUARD + """
import runpy
sys.argv = ["tool"] + {args!r}
runpy.run_module("mlsgpu_tpu_torch.tools.{name}", run_name="__main__")
"""

# The tools that parse with argparse show their help; the three that read
# sys.argv themselves print their usage line when called with no file.
TOOLS = [("plymanifold", []), ("plypntcat", ["--help"]),
         ("analyze_stats", []), ("analyze_timeplot", []),
         ("draw_timeplot", ["--help"]), ("simulate", ["--help"]),
         ("verify_chunks", ["--help"]), ("bench_ooc", ["--help"]),
         ("bench_stage", ["--help"]), ("bench_split", ["--help"]),
         ("bench_d2h", ["--help"]), ("bench_micro", ["--help"]),
         ("bench_micro2", ["--help"]), ("bench_queues", ["--help"])]


@pytest.mark.parametrize("name,args", TOOLS, ids=[t[0] for t in TOOLS])
def test_tool_runs_as_a_module_without_jax_package(name, args):
    proc = _run(_RUN_TOOL.format(name=name, args=args))
    text = (proc.stdout + proc.stderr).lower()
    assert "usage" in text, text[-2000:]
    assert "the port imported" not in text
    assert proc.returncode == (0 if args else 2), text[-2000:]


def test_chip_smoke_imports_neither():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "mlsgpu_tpu_torch.cli" in names or "mlsgpu_tpu_torch" in names
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN], names
