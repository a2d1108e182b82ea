"""A CPU rehearsal of every cell, and the isolation rule on what the run
and the reference load."""

import json

import pytest

from portbench import catalog
from portbench.harness import ROOT
from portbench.tests.helpers import run_python

CELLS = catalog.cell_names(catalog.benchmark(ROOT))
FORBIDDEN = {"jax", "jaxlib", "flax", "mlsgpu_tpu", "bench"}

_REHEARSE = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import harness
rc = harness.run(["--workload", {cell!r}, "--seed", "2147483707",
                  "--seconds", "1", "--trace", {trace!r}, "--rehearse"])
print(json.dumps({{"rc": rc, "top": sorted({{m.split(".")[0]
                                             for m in sys.modules}})}}))
"""


@pytest.mark.parametrize("trace", ["0", "1"])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_is_correct_and_isolated(cell, trace, tmp_env):
    rc, out, err = run_python(_REHEARSE.format(root=ROOT, cell=cell,
                                               trace=trace), env=tmp_env)
    assert rc == 0, err[-3000:]
    lines = out.strip().splitlines()
    loaded = json.loads(lines[-1])
    result = json.loads(lines[-2])
    assert loaded["rc"] == 0
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    # a rehearsal prints no metric and claims no card
    assert result["metrics"] == {} and result["rehearsal"] is True
    assert result["device"]["platform"] == "cpu"
    assert list(result)[-1] == "checks"
    assert not FORBIDDEN & set(loaded["top"]), loaded["top"]
    assert "mlsgpu_tpu_torch" in loaded["top"]


def test_reference_loads_nothing_of_the_program(tmp_env):
    code = f"""
import json, sys
sys.path.insert(0, {ROOT!r})
import numpy as np, torch
from portbench import reference
from portbench.traffic import generator
cloud, sr = generator.make_cloud(3000, 9)
# a mesh of two triangles is enough to drive every reading
v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32) * sr
import io
head = ("ply\\nformat binary_little_endian 1.0\\nelement vertex 4\\n"
        "property float32 x\\nproperty float32 y\\nproperty float32 z\\n"
        "element face 2\\nproperty list uint8 uint32 vertex_indices\\n"
        "end_header\\n").encode()
t = np.array([[0, 1, 2], [1, 3, 2]], np.uint32)
rec = np.zeros((2, 13), np.uint8); rec[:, 0] = 3
rec[:, 1:] = t.view(np.uint8).reshape(2, 12)
buf = np.frombuffer(head + v.tobytes() + rec.tobytes(), np.uint8)
r = reference.judge(buf, cloud, sr / 3, 1.0, 0.02, 0.0, 1,
                    dict(uniform=4, face=4, skeleton=4), 63,
                    torch.device("cpu"), control=torch.bfloat16)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    rc, out, err = run_python(code, env=tmp_env)
    assert rc == 0, err[-3000:]
    top = set(json.loads(out.strip().splitlines()[-1]))
    assert "mlsgpu_tpu_torch" not in top
    assert not FORBIDDEN & top


def test_measuring_run_without_a_card_fails(tmp_env):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the check is of a machine without")
    rc, out, err = run_python(
        "import sys; sys.argv = ['run.py', '--workload', "
        f"{CELLS[0]!r}, '--seed', '1', '--seconds', '1', '--trace', '0'];"
        f"sys.path.insert(0, {ROOT!r}); from portbench import run;"
        "sys.exit(run.main())", env=tmp_env)
    assert rc != 0
    assert out.strip() == ""
    assert "CUDA" in err


def test_run_outside_a_checkout_fails(tmp_path, tmp_env):
    """Only BENCHMARK.json and the benchmark's folder: no program to run."""
    import shutil
    shutil.copytree(f"{ROOT}/portbench", tmp_path / "co" / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(f"{ROOT}/BENCHMARK.json", tmp_path / "co")
    proc_code = ("import runpy, sys; sys.argv = ['portbench/run.py', "
                 f"'--workload', {CELLS[0]!r}, '--seed', '1', '--seconds', "
                 "'1', '--trace', '0', '--rehearse'];"
                 "runpy.run_path('portbench/run.py', run_name='__main__')")
    rc, out, err = run_python(proc_code, cwd=str(tmp_path / "co"),
                              env=tmp_env)
    assert rc != 0
    assert not any(line.startswith("{") for line in out.splitlines())


def test_module_loaded_while_judging_stops_the_result(tmp_env):
    """The isolation check comes after the verdict: a forbidden module that
    only the judging loads still stops the result."""
    code = f"""
import sys, types
sys.path.insert(0, {ROOT!r})
from portbench import harness, reference
judge = reference.judge
def loading_judge(*a, **k):
    sys.modules["jax"] = types.ModuleType("jax")
    return judge(*a, **k)
reference.judge = loading_judge
sys.exit(harness.run(["--workload", {CELLS[0]!r}, "--seed", "2147483708",
                      "--seconds", "1", "--trace", "0", "--rehearse"]))
"""
    rc, out, err = run_python(code, env=tmp_env)
    assert rc == 3, err[-3000:]
    assert not any(line.startswith("{") for line in out.splitlines())
    assert "jax" in err
