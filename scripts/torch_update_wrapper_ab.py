#!/usr/bin/env python3
"""Per-call time of the PyTorch port's forecaster update wrapper
(``chanamq_tpu_torch.kernels.update.clip_momentum_sgd``) in one or more
checkouts of this repository, on one card.

    python3 scripts/torch_update_wrapper_ab.py [--rounds 5] DIR [DIR ...]

Each DIR runs in a process of its own, in the order given (to compare two
versions on one card, give them as A B B A), and builds its own kernels.
That process imports the checkout's own ``chip_smoke`` and holds the
update at the flagship's 29 parameter tensors (``train_inputs`` at B = 16,
the ``[fc-train-kernels]`` inputs) ``rounds`` times with
``hold_train_kernel``: each round checks the kernels against the plain
version, bit for bit at the kernel's clip scale, and times the kernels'
device work and one wrapper call, its host work included (CUDA events
around 100 calls each). Prints one JSON line a DIR, then the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def one(root: str, rounds: int) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from chanamq_tpu_torch.models.forecaster import ForecasterConfig

    device = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(1)
    args = chip_smoke.train_inputs(gen, ForecasterConfig(), 16,
                                   device)["clip_momentum_sgd"]
    rows = [chip_smoke.hold_train_kernel("clip_momentum_sgd", args)
            for _ in range(rounds)]
    return {"dir": root, "wrapper_ms": [r["wrapper_ms"] for r in rows],
            "ms": [r["ms"] for r in rows],
            "max_abs_err": max(r["max_abs_err"] for r in rows)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.dirs[0], args.rounds)))
        return 0
    for root in map(os.path.abspath, args.dirs):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one",
             "--rounds", str(args.rounds), root],
            cwd=root, capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            sys.stderr.write(out.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
