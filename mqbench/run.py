"""Run one cell of ``BENCHMARK.json`` once, on the card.

    python3 mqbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds the program
(``chanamq_tpu_torch``). The last line of standard output is the result
object; the numbers that decided ``correct`` are the last lines of
standard error. Without a card, or with fewer cards than the cell asks
for, it exits with 1 and prints no result.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this folder, leads the import path
sys.path[0] = ROOT


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    from mqbench import harness

    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), started=STARTED)
    except Exception:  # noqa: BLE001 — any failure: no result, exit 1
        traceback.print_exc()
        return 1
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
