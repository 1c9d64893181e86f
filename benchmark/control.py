#!/usr/bin/env python3
"""The control of a cell's comparison: the reference computed in bfloat16
(scene tables, camera, rays and hit distances rounded to bfloat16), put in
the program's place and judged as the program is, on each seed given.

    python benchmark/control.py --workload <cell> --units <n> --seeds 1,2,3

``--units`` is the window's passes, steps or frames that a run of the cell
compares.  Prints one JSON line a seed with the numbers beside the cell's
limits; every number should fail at least one limit.  A benchmark run
never runs this: it is how the limits' upper readings were taken.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--units", type=int, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    from harness import cells, check, guard, scenes

    guard.set_cache_dirs(os.path.dirname(HERE))
    cell = cells.find(args.workload)
    scene_file = scenes.scene_path(cell.config_name, cell.config)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        found = check.control_numbers(cell, scene_file, seed, args.device, args.units)
        fails, shown = check.judge(found, cell.limits)
        print(json.dumps({"workload": cell.name, "seed": seed, "units": args.units, "control_correct": fails,
                          "numbers": shown, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
