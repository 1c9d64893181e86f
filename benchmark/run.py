#!/usr/bin/env python3
"""Run one cell of the benchmark once, on this machine's card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints progress on standard error, then each
number compared with the reference beside its limit as the last lines of
standard error, and one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``.  Exits non-zero, with no
result, without a CUDA card, with a program setting (``RT_*``) in the
environment, or if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]


def log(msg: str):
    print(f"[bench {time.perf_counter() - T_START:8.2f} s] {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import cells, guard

    settings = guard.program_settings()
    if settings:
        log(f"refused: program settings in the environment {settings}; a cell runs the program's defaults")
        return 2
    guard.set_cache_dirs(ROOT)
    cell = cells.find(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"refused: {cell.name} needs {cell.chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    from harness import runner

    log(f"{cell.name}: seed {args.seed}, {args.seconds} s, trace {args.trace}, {torch.cuda.get_device_name(0)}, "
        f"torch {torch.__version__}")
    result = runner.run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START, log)
    bad = guard.loaded()
    if bad:
        log(f"refused: modules of JAX or the JAX package were loaded: {bad}")
        return 3
    err, line = runner.result_lines(result)
    print("\n".join(err), file=sys.stderr, flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
