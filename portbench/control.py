"""The readings that the limits of `correct` are set from, and the checks
that those limits fail what they must (PERF.md gives the readings).

    python3 portbench/control.py --workload <cell> --seeds 1 2 3
                                 [--faults block_dropped vertex_moved ...]

For each seed, in one process: the cloud made from the seed, one job of
the program at the cell's size, and the reference's readings of its mesh
(a sound run: the lower readings); the control's reading, the reference
itself computed in bfloat16 put in the program's place (the upper
reading of `vertex_gap_cells`); then one job with each fault of
portbench/faults.py planted and its readings. One JSON line each. The
benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def main(argv=None) -> int:
    import torch
    from portbench import catalog, faults, harness
    from portbench.sink import MemorySink

    p = argparse.ArgumentParser(prog="portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", nargs="*", default=[],
                   choices=faults.FAULTS)
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)
    harness.set_environment()
    cell = catalog.load_cell(catalog.benchmark(harness.ROOT), args.workload)
    if not args.rehearse:
        harness.check_card(cell)
    for seed in args.seeds:
        with harness.Session(cell, seed, args.rehearse) as session:
            sink = MemorySink()
            for variant in ["sound"] + list(args.faults):
                mend = (faults.plant(variant)
                        if variant != "sound" else None)
                t0 = time.monotonic()
                try:
                    session.job(sink)
                finally:
                    if mend is not None:
                        mend()
                job_s = time.monotonic() - t0
                readings = session.judge(
                    sink, control=torch.bfloat16 if variant == "sound"
                    else None)
                print(json.dumps(dict(readings, seed=seed, variant=variant,
                                      cell=cell.name, job_s=job_s)),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
