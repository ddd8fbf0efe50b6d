"""Readings for a cell's limits, on the card: the numbers that decide
``correct`` for the program on many seeds, for the control and for each
fault the cell can have, read in one process.

    python3 mqbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --kinds program,control --out calibration.jsonl

Each line of ``--out`` is one reading: the cell, the kind, the seed and
the numbers. The kinds are the driver's (its ``calibration``).
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--kinds", default="program,control")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", required=True)
    args = p.parse_args()
    from mqbench import harness

    bench = harness.load_benchmark()
    cell, _, config, traffic = harness.find_cell(bench, args.workload)
    query = harness.query_card()
    harness.check_card(cell["chips"])
    harness.card_notes(query)
    driver = harness.load_driver(config["driver"])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as out:
        for kind in args.kinds.split(","):
            for seed in (int(s) for s in args.seeds.split(",")):
                t0 = time.perf_counter()
                spec = harness.Spec(cell=cell, config=config,
                                    traffic=traffic, seed=seed,
                                    seconds=args.seconds,
                                    trace=False, device="cuda",
                                    started=t0)
                got = driver.calibration(spec, kind)
                row = {"cell": args.workload, "kind": kind, "seed": seed,
                       "numbers": got,
                       "seconds": time.perf_counter() - t0}
                out.write(json.dumps(row) + "\n")
                out.flush()
                harness.log(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
