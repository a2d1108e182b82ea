"""The verdict: a sound rehearsal is correct; each fault a cell can have,
planted underneath the run, turns it false; so does the control (the
reference in bfloat16) put in the program's place. Every other splat
left out (`half_splats`) changes nothing at this size (PERF.md §2): the
second half of each block left out stands for half the batch here."""

import pytest

from portbench import catalog
from portbench.harness import ROOT
from portbench.tests.helpers import last_json, run_python

_RUN = """
import sys
sys.path.insert(0, {root!r})
from portbench import harness
sys.exit(harness.run(["--workload", {cell!r}, "--seed", "2147483709",
                      "--seconds", "1", "--trace", "0", "--rehearse"],
                     faults={faults!r}, control={control!r}))
"""

#: The faults each cell can have: a step that leaves the mesh unchanged,
#: half of a block's splats left out, an answer altered where it is made;
#: and the control.
FAULTS = [(cell, fault) for cell in catalog.cell_names(catalog.benchmark(ROOT))
          for fault in ("block_dropped", "half_block", "vertex_moved",
                        "control")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_turns_correct_false(cell, fault, tmp_env):
    control = fault == "control"
    rc, out, err = run_python(_RUN.format(
        root=ROOT, cell=cell, faults=[] if control else [fault],
        control=control), env=tmp_env)
    assert rc == 0, err[-3000:]
    result = last_json(out)
    assert result["correct"] is False, result["checks"]
    failing = [k for k, c in result["checks"].items()
               if not c["value"] <= c["limit"]]
    assert failing
    if control:
        assert failing == ["vertex_gap_cells"]
    # the numbers compared are the last lines on standard error
    tail = err.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("check ") for line in tail)
