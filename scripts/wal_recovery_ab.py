#!/usr/bin/env python3
"""Crash recovery of a durable node of the JAX package and of its PyTorch
port, on one burst of persistent messages each.

    python3 scripts/wal_recovery_ab.py [--seed 0] [--order ref port port ref]

For each entry of ``--order``, ``chip_smoke.py``'s ``[durable]`` phase
(``phase_durable``) against a node of that package: ``BrokerServer.
from_config`` with its store under a temporary directory and every
``chana.mq.wal.*`` key at its default (fsync, flush-ms 2); the reference's
router on its default backend (JAX, on the host's CPU), the port's on
``--port-device`` (the card by default). The main path's tables, all
durable; 4 confirming publishers send 50,000 persistent 256 B messages;
after the last confirm the node is SIGKILLed, a new node starts from the
same directory, and every queue is drained and held to the host oracle
(exactly once, in order, identical). Prints one JSON line a run: the
package, confirmed msg/s, the WAL's appends and commits, the records the
restart replayed, and the seconds from the restart to listening, to the
first delivery and to the last, and the restarted node's seconds from
its config to listening (its WAL replay included, its imports not).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def node(package: str, port: int, db: str, device: str, state: str) -> None:
    if package == "port":
        chip_smoke.durable_node(port, db, device, state)
        return
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from chanamq_tpu.broker.server import BrokerServer
    from chanamq_tpu.config import Config

    def make_server(settings: dict):
        # the reference has no router.device key: its backend's default
        settings = {k: v for k, v in settings.items() if k != "router.device"}
        return BrokerServer.from_config(Config(settings, env={}))

    chip_smoke.durable_node(port, db, "cpu", state, make_server=make_server)


def starter(package: str):
    def start_node(port: int, db: str, device: str, state: str):
        os.makedirs(state)
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--node", package,
             str(port), db, device, state], cwd=ROOT)
    return start_node


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--order", nargs="+", choices=("ref", "port"),
                    default=["ref", "port", "port", "ref"])
    ap.add_argument("--port-device", default="cuda")
    ap.add_argument("--node", nargs=5, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.node:
        package, port, db, device, state = args.node
        node(package, int(port), db, device, state)
        return 0
    for package in args.order:
        device = args.port_device if package == "port" else "cpu"
        res = chip_smoke.phase_durable(device, args.seed,
                                       start_node=starter(package))
        wal = res["traced"]["wal"]
        print(json.dumps({
            "package": package, "router_device": device,
            "messages": res["messages"], "msgs_per_s": res["msgs_per_s"],
            "wal_appends": wal["appends"], "wal_commits": wal["commits"],
            "recovered_records": res["recovered_records"],
            "restart_to_ready_s": res["restart_to_ready_s"],
            "node_start_s": res["node_start_s"],
            "restart_to_first_delivery_s":
                res["restart_to_first_delivery_s"],
            "restart_to_drained_s": res["restart_to_drained_s"],
            "deliveries": res["deliveries"], "lost": res["lost"],
            "duplicated": res["duplicated"]}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() or "nvidia-smi: not available")
    return 0


if __name__ == "__main__":
    sys.exit(main())
