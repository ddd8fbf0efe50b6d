#!/usr/bin/env python3
"""The PyTorch port's matrix-product kernels (``csrc/products.cu``) in one
or more checkouts of this repository, on one card.

    python3 scripts/products_ab.py [--rounds 1] [--out FILE] [--sweep]
        [--paths] DIR [DIR ...]

Each DIR runs in a process of its own, in the order given (to compare two
versions on one card, give them as A B B A), and builds its own
``products`` library (ptxas's registers, shared memory and spills for
each kernel instance are printed). That process imports the checkout's
own ``chip_smoke`` and runs its ``[products]`` phase ``rounds`` times:
every site, layout and epilogue held against the plain version within
``product_limit``, the flagship's sites timed (kernel alone behind a
sleeping kernel, the wrapper call, the plain version and the cuBLAS call
each replaced, CUDA events around 100 calls each). Prints one JSON line a
DIR (each timed site's times, tile and split where the checkout has
them), then the card's name and power limit; ``--out`` also writes the
lines to FILE. ``--sweep`` also times, in the current directory's
checkout, every flagship bf16 site at each split S of 1, 2, 4 and 8;
``--paths`` also runs ``chip_smoke``'s ``[forward]`` and ``[train]``
phases in each checkout, for the host clock of a forward and a step, and
times the host's cost a call of each forward bf16 site at B = 1 (the
wrapper, and its bound launch alone).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys


def sweep(device) -> dict:
    """The bf16 kernel alone at each flagship site (the forward's and the
    gradients' batches) with K split over each of 1, 2, 4 and 8 blocks
    (``prepare_bf16_product``'s test-only ``splits``): {site: {S: ms}}."""
    import torch

    import chip_smoke
    from chanamq_tpu_torch.kernels import products as pk
    from chanamq_tpu_torch.models.forecaster import ForecasterConfig

    cfg = ForecasterConfig()
    gen = torch.Generator().manual_seed(2)
    out: dict = {}
    for b, grads in ([(b, False) for b in chip_smoke.FORECAST_BATCHES]
                     + [(b, True) for b in chip_smoke.TRAIN_BATCHES]):
        sites = chip_smoke.product_sites(gen, cfg, b, device, grads=grads)
        for site, (name, args) in sites.items():
            if name != "bf16_product":
                continue
            m, n, k = pk.dims(args[2], args[0], args[1])
            row = out[f"{site} B={b}"] = {
                "tile": pk.tile_rows(m, n, k), "wrapper_s": pk.split_k(
                    m, n, k)}
            for s in (1, 2, 4, 8):
                _, launch = pk.prepare_bf16_product(*args, splits=s)
                row[s] = chip_smoke._time_ms(launch, 100, device_only=True)
    return out


def host_cost(device, calls: int = 2000) -> dict:
    """Host µs a call of each flagship forward bf16 site at B = 1: the
    wrapper (checks, output, plan, binding, launch) and the bound launch
    alone (the C launcher), over ``calls`` calls, synchronising every
    100 so the queue never fills."""
    import time

    import torch

    import chip_smoke
    from chanamq_tpu_torch.kernels import products as pk
    from chanamq_tpu_torch.models.forecaster import ForecasterConfig

    gen = torch.Generator().manual_seed(3)
    sites = chip_smoke.product_sites(gen, ForecasterConfig(), 1, device)
    out: dict = {}
    for site, (name, args) in sites.items():
        if name != "bf16_product":
            continue
        _, launch = pk.prepare_bf16_product(*args)
        row = out[site] = {}
        for key, fn in (("wrapper_us", lambda: pk.bf16_product(*args)),
                        ("launch_us", launch)):
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            spent = 0.0
            for _ in range(calls // 100):
                t0 = time.perf_counter()
                for _ in range(100):
                    fn()
                spent += time.perf_counter() - t0
                torch.cuda.synchronize()
            row[key] = spent / calls * 1e6
    return out


def paths(device) -> dict:
    """``chip_smoke``'s ``[forward]`` (B = 1 and 32) and ``[train]`` (B =
    16) phases: host-clock and CUDA-event ms of a forward and of a step,
    and the bf16 products' traced device time where the checkout's trace
    splits it by kernel."""
    import chip_smoke

    out: dict = {}
    for b, row in chip_smoke.phase_forward(device, 0).items():
        out[f"forward B={b}"] = _path_row(row)
    out["train B=16"] = _path_row(chip_smoke.phase_train(device, 0))
    return out


def _path_row(row: dict) -> dict:
    kernels = row["traced"]["port_kernels"].get("by_kernel", {})
    return {"host_ms": row["host_ms"], "event_ms": row["event_ms"],
            "bf16_traced_us": kernels.get("bf16_product", {}).get("us")}


def one(root: str, rounds: int, with_sweep: bool = False,
        with_paths: bool = False) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from chanamq_tpu_torch.kernels import build

    built = build.build("products")
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if re.search(r"registers|spill|Compiling entry|Performance",
                          ln)]
    device = torch.device("cuda", 0)
    sites: dict = {}
    for _ in range(rounds):
        res = chip_smoke.phase_products(device, 0)
        for (label, site, b), row in res.items():
            if "ms" not in row:
                continue
            one = sites.setdefault(f"{label} {site} B={b}", {
                k: row[k] for k in ("shape", "tile", "splits", "bound_ms")
                if k in row})
            for k in ("ms", "wrapper_ms", "plain_ms", "library_ms"):
                one.setdefault(k, []).append(row[k])
    return {"dir": root, "build_s": built.seconds, "ptxas": ptxas,
            "sites": sites,
            **({"sweep": sweep(device)} if with_sweep else {}),
            **({"paths": paths(device), "host": host_cost(device)}
               if with_paths else {})}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out")
    ap.add_argument("--sweep", action="store_true",
                    help="also time each bf16 site at S = 1, 2, 4, 8 (a "
                    "checkout whose wrapper takes splits)")
    ap.add_argument("--paths", action="store_true",
                    help="also run chip_smoke's [forward] and [train] "
                    "phases in each checkout (host-clock ms a forward and "
                    "a step)")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.dirs[0], args.rounds, args.sweep,
                             args.paths)))
        return 0
    lines = []
    for root in map(os.path.abspath, args.dirs):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one",
             "--rounds", str(args.rounds), root]
            + (["--sweep"] if args.sweep and root == os.path.abspath(".")
               else []) + (["--paths"] if args.paths else []),
            cwd=root, capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            sys.stderr.write(out.stdout[-20000:] + out.stderr[-20000:])
            return out.returncode
        lines.append(out.stdout.strip().splitlines()[-1])
        print(lines[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines + [smi.stdout.strip()]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
