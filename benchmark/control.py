"""The readings a cell's limits are set from, on the card, in one process.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 [--control] [--seconds 2]

Runs the cell once for each seed, with a short window, and prints one
JSON line per seed: the numbers compared with the plain reference.
Without ``--control`` these are the program's readings (the lower ones);
with it the reference's control takes the program's place in every
compress (the codec's ``CONTROL``: the same stream format with one
stated guarantee broken), and its readings are the upper ones.  The
benchmark's own runs never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmark import harness  # noqa: E402


def main(argv):
    p = argparse.ArgumentParser(prog="python3 benchmark/control.py", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", action="store_true")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    alter = (lambda e: e.control()) if args.control else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        line = harness.run_cell(args.workload, seed, args.seconds, False, t0, alter=alter)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "correct": line["correct"], "checks": line["checks"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
