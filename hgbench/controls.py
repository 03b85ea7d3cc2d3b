"""Read a cell's compared numbers over many seeds in one process: the
program's, or with ``--traffic`` a control's (the program's own lower path
switched on, or the reference in the program's place) or a planted fault.
One JSON line a seed: the checks and the run's notes.

    python3 hgbench/controls.py --workload config5.codes-q1024 \
        --seconds 2 --seeds 1 2 3 --traffic '{"mode": "approx"}'

The limits in a cell's files are set from these readings: above the
largest of the program's over a dozen seeds or more, below the smallest
of the control's.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, os.path.dirname(HERE))


def main(argv=None) -> int:
    import torch

    from hgbench import core
    from hgbench.run import execute

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--traffic", default="{}",
                    help="JSON merged over the cell's traffic file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = core.find_cell(core.load_benchmark(), args.workload,
                          overrides={"traffic": json.loads(args.traffic)})
    for seed in args.seeds:
        t0 = time.time()
        result, record = execute(cell, seed, args.seconds, False, "cuda", t0)
        print(json.dumps({"seed": seed, "traffic": args.traffic,
                          "correct": result["correct"],
                          "checks": result["checks"],
                          "metrics": result["metrics"],
                          "notes": record.notes}), flush=True)
        del record
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
