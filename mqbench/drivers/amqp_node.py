"""Entry kind ``amqp_node``: the node's served AMQP path, as clients feel it.

The broker runs in this process: a ``BrokerServer``
(``chanamq_tpu_torch/broker/server.py``) on 127.0.0.1 from the
configuration's settings, its router on the device (``router.device``),
transient messages in memory. Set-up builds the router's kernel library,
starts the server, spawns the client processes (``mqbench/clients.py``:
``consumers`` consumers over contiguous blocks of the queues and
``publishers`` publishers), declares the configuration's topology
(``frozen/workload.py``) over one AMQP connection, and lets the publishers
run ``warmup_s`` seconds (the first compile and kernel batch of each
exchange) before the window opens. ``confirmed_msgs_per_s`` is every
publisher's messages confirmed inside the window over the window's length
(``confirm_rate``). A traced run also installs the program's profile
runtime and traces the card across the window.

After the window the publishers wait for their last confirms, the broker
empties its queues into the consumers, and the consumers hand in their
logs. ``correct`` holds when no confirm was a nack, no queue received a
message twice, every queue received each publisher's messages in their
order, and each message of a sample drawn from the seed reached exactly
the queues the plain matchers (``reference/matchers.py``) give it.
"""

from __future__ import annotations

import asyncio
import json
import os
import random
import shutil
import sys
import tempfile
import time

import numpy as np

from mqbench import harness
from mqbench.frozen import workload
from mqbench.reference.matchers import TopicMatcher

CLIENTS = os.path.join(harness.BENCH_DIR, "clients.py")


def topology_args(config: dict) -> dict:
    return dict(config["topology"])


class Recording:
    """Stands in for the router's kernel module inside
    ``router/compile.py`` while a traced window lasts: every match launch
    is kept with its arguments, then passed on."""

    def __init__(self, module) -> None:
        self._module = module
        self.calls: list = []

    def __getattr__(self, name):
        return getattr(self._module, name)

    def topic_match(self, table, pre_m, suf_m, mlen):
        self.calls.append(("topic_match", table, (pre_m, suf_m, mlen)))
        return self._module.topic_match(table, pre_m, suf_m, mlen)

    def headers_match(self, table, pids):
        self.calls.append(("headers_match", table, (pids,)))
        return self._module.headers_match(table, pids)


def make_server(spec: harness.Spec):
    from chanamq_tpu_torch.broker.server import BrokerServer
    from chanamq_tpu_torch.config import Config

    overrides = dict(spec.config["broker"])
    overrides.update({"amqp.interface": "127.0.0.1", "amqp.port": 0,
                      "router.device": spec.device})
    return BrokerServer.from_config(Config(overrides, env={}))


async def declare(port: int, topo: workload.Topology,
                  channels: int = 16) -> None:
    """The exchanges, queues and bindings over one connection, on
    ``channels`` channels at once."""
    from mqbench.frozen.client import AMQPClient

    c = await AMQPClient.connect("127.0.0.1", port, heartbeat=0)
    chs = [await c.channel() for _ in range(channels)]
    await chs[0].exchange_declare(workload.TOPIC_EXCHANGE, "topic")
    await chs[0].exchange_declare(workload.HEADERS_EXCHANGE, "headers")

    async def part(k: int) -> None:
        ch = chs[k]
        for q in topo.queues[k::channels]:
            await ch.queue_declare(q)
        for pat, q in topo.topic_bindings[k::channels]:
            await ch.queue_bind(q, workload.TOPIC_EXCHANGE, pat)
        for q, args in topo.headers_bindings[k::channels]:
            await ch.queue_bind(q, workload.HEADERS_EXCHANGE, "",
                                arguments=args)

    await asyncio.gather(*(part(k) for k in range(channels)))
    await c.close()


async def spawn(role: str, arg: dict):
    return await asyncio.create_subprocess_exec(
        sys.executable, CLIENTS, role, json.dumps(arg),
        stdin=asyncio.subprocess.PIPE, stdout=asyncio.subprocess.PIPE,
        cwd=harness.ROOT)


async def expect(proc, want: str, timeout: float) -> str:
    line = await asyncio.wait_for(proc.stdout.readline(), timeout)
    text = line.decode().strip()
    if not text.startswith(want):
        raise harness.BenchError(f"a client said {text!r}, not {want!r}")
    return text


def ready_count(broker) -> int:
    return sum(q.message_count for v in broker.vhosts.values()
               for q in v.queues.values())


async def drive(spec: harness.Spec, server, topo, logdir: str) -> dict:
    """Set-up, window and drain; the client processes are always ended."""
    t = spec.traffic
    marks = [("start", time.perf_counter())]
    await server.start()
    port = server.bound_port
    procs: list = []
    try:
        n_q = len(topo.queues)
        per = n_q // t["consumers"]
        cons = []
        for k in range(t["consumers"]):
            arg = {"host": "127.0.0.1", "port": port,
                   "queues": list(range(k * per, (k + 1) * per
                                        if k < t["consumers"] - 1 else n_q)),
                   "prefetch": t["prefetch"],
                   "multi_ack_every": t["multi_ack_every"],
                   "log": os.path.join(logdir, f"consumer{k}.bin")}
            cons.append((arg, None))
        pubs = []
        for p in range(t["publishers"]):
            arg = {"host": "127.0.0.1", "port": port, "p": p,
                   "seed": spec.seed, "traffic": t,
                   "topology": topology_args(spec.config)}
            pubs.append(await spawn("publisher", arg))
        procs += pubs
        await declare(port, topo)
        marks.append(("declare", time.perf_counter()))
        for i, (arg, _) in enumerate(cons):
            cons[i] = (arg, await spawn("consumer", arg))
            procs.append(cons[i][1])
        for proc in [c for _, c in cons] + pubs:
            await expect(proc, "ready", 300)
        marks.append(("clients ready", time.perf_counter()))
        traced = None
        if spec.trace:
            # the profiler takes seconds to start: before the warm-up
            from chanamq_tpu_torch.kernels import router_match as rm
            from chanamq_tpu_torch.router import compile as rcompile

            traced = (harness.start_profiler(), Recording(rm))
            rcompile.router_match = traced[1]
            router = server.broker.router
            router.route_pending = harness.annotated(
                router.route_pending, "mqbench.route_pending")
            marks.append(("profiler start", time.perf_counter()))
        harness.log("[setup] before the server %.3f s, " % (
            marks[0][1] - spec.started) + ", ".join(
            f"{name} {b - a:.3f} s" for (_, a), (name, b)
            in zip(marks, marks[1:])) + f", warm-up {t['warmup_s']} s")
        now = time.monotonic()
        t0 = now + t["warmup_s"]
        t1 = t0 + spec.seconds
        for proc in pubs:
            proc.stdin.write(f"go {t0!r} {t1!r}\n".encode())
            await proc.stdin.drain()
        return await window(spec, server, pubs, cons, t0, t1, traced)
    finally:
        for proc in procs:
            if proc.returncode is None:
                proc.kill()
            await proc.wait()
        await server.stop()


async def window(spec, server, pubs, cons, t0: float, t1: float,
                 traced) -> dict:
    import torch

    from chanamq_tpu_torch import profile
    from chanamq_tpu_torch.kernels import router_match as rm
    from chanamq_tpu_torch.router import compile as rcompile

    out: dict = {"readings": {}}
    await asyncio.sleep(max(0.0, t0 - time.monotonic()))
    if traced is not None:
        prof, rec = traced
        rt = profile.install(
            profile.ProfileRuntime(metrics=server.broker.metrics))
        rt.start()
        launches0 = rm.topic_match.launches + rm.headers_match.launches
    out["setup_s"] = time.perf_counter() - spec.started
    span = torch.profiler.record_function(harness.WINDOW_SPAN)
    span.__enter__()
    await asyncio.sleep(max(0.0, t1 - time.monotonic()))
    span.__exit__(None, None, None)
    if spec.trace:
        snap = rt.snapshot()
        out["readings"].update(
            loop_cpu_ns=snap["loop_cpu_ns"],
            route_ns=int(rt.stage_ns[profile.ROUTE]),
            route_calls=int(rt.stage_calls[profile.ROUTE]),
            launches=rm.topic_match.launches + rm.headers_match.launches
            - launches0)
        profile.clear()
        rcompile.router_match = rm
        del server.broker.router.route_pending
        prof.stop()
        out["readings"]["router_calls"] = rec.calls
        out["readings"]["trace"] = harness.trace_summary(prof)
        del prof
    results = [json.loads(await expect(p, "{", 180)) for p in pubs]
    deadline = time.monotonic() + 90
    while ready_count(server.broker) and time.monotonic() < deadline:
        await asyncio.sleep(0.02)
    for _, proc in cons:
        proc.stdin.write(b"stop\n")
        await proc.stdin.drain()
    for _, proc in cons:
        await expect(proc, "{", 120)
    out["publishers"] = results
    out["left_ready"] = ready_count(server.broker)
    return out


def read_logs(logdir: str, consumers: int) -> list:
    logs = []
    for k in range(consumers):
        with open(os.path.join(logdir, f"consumer{k}.bin"), "rb") as f:
            n = int(np.frombuffer(f.read(8), dtype="<u8")[0])
            q = np.frombuffer(f.read(2 * n), dtype=np.uint16)
            p = np.frombuffer(f.read(n), dtype=np.uint8)
            s = np.frombuffer(f.read(4 * n), dtype=np.uint32)
        logs.append((q.astype(np.int64), p.astype(np.int64),
                     s.astype(np.int64)))
    return logs


def check(spec: harness.Spec, topo: workload.Topology, logs: list,
          published: list) -> dict:
    """The numbers that decide ``correct`` (each must be 0) and the mean
    fan-out of the sample."""
    dup = order = 0
    allq, allp, alls = [], [], []
    for q, p, s in logs:
        group = (q << 8) | p
        idx = np.argsort(group, kind="stable")
        g, ss = group[idx], s[idx]
        same = g[1:] == g[:-1]
        order += int(np.count_nonzero(same & (ss[1:] <= ss[:-1])))
        allq.append(q)
        allp.append(p)
        alls.append(s)
    q = np.concatenate(allq)
    msg = (np.concatenate(allp) << 32) | np.concatenate(alls)
    key = (msg << 12) | q
    dup = len(key) - len(np.unique(key))
    rng = random.Random(spec.seed)
    n_sample = spec.traffic["check_sample"]
    pool = [(p, i) for p, n in enumerate(published) for i in range(n)]
    sample = pool if len(pool) <= n_sample else rng.sample(pool, n_sample)
    want_keys = np.array(sorted((p << 32) | i for p, i in sample),
                         dtype=np.int64)
    hit = np.isin(msg, want_keys)
    got: dict = {}
    for m, qq in zip(msg[hit].tolist(), q[hit].tolist()):
        got.setdefault(m, set()).add(qq)
    streams = [workload.Stream(topo, spec.traffic, spec.seed, p)
               for p in range(len(published))]
    n_msgs = spec.traffic["messages_per_publisher"]
    mismatched = fanout = 0
    for p, i in sorted(sample):
        want = {int(name[1:]) for name in
                topo.route(streams[p].message(i % n_msgs))}
        fanout += len(want)
        if got.get((p << 32) | i, set()) != want:
            mismatched += 1
    return {"routed_set_mismatches": mismatched, "duplicate_deliveries": dup,
            "order_violations": order,
            "mean_fanout": fanout / max(1, len(sample)),
            "sampled": len(sample), "deliveries": int(len(q))}


class OneOrMoreHash(TopicMatcher):
    """The control's topic matcher: ``#`` takes one or more words, not
    zero or more (a guarantee of AMQP's topic semantics broken)."""

    def _walk(self, node: dict, words: list, i: int, out: set) -> None:
        nxt = node.get("next", {})
        if i == len(words):
            out |= node.get("queues", set())
        else:
            for w in (words[i], "*"):
                child = nxt.get(w)
                if child is not None:
                    self._walk(child, words, i + 1, out)
        hash_ = nxt.get("#")
        if hash_ is not None:
            for j in range(i + 1, len(words) + 1):
                self._walk(hash_, words, j, out)


def control_route_batch(topo: workload.Topology):
    """A ``route_batch`` that routes as the reference does, with the
    control's topic matcher in place of the kernels."""
    topic = OneOrMoreHash()
    for pat, q in topo.topic_bindings:
        topic.bind(pat, q)

    def route_batch(compiled, items, backend="torch", device="cuda"):
        if compiled.kind == "topic":
            return [frozenset(topic.route(k)) for k, _ in items]
        return [frozenset(topo.headers.route(h or {})) for _, h in items]
    return route_batch


def calibration(spec: harness.Spec, kind: str) -> dict:
    """One run's numbers for setting the limits: ``program`` (a run as it
    is) or ``control`` (the program's batch routing replaced by the
    reference's matchers with ``#`` taking one or more words)."""
    from chanamq_tpu_torch.router import compile as rcompile

    if kind == "program":
        out = run(spec)
    elif kind == "control":
        real = rcompile.route_batch
        rcompile.route_batch = control_route_batch(
            workload.Topology(**topology_args(spec.config)))
        try:
            out = run(spec)
        finally:
            rcompile.route_batch = real
    else:
        raise ValueError(f"unknown calibration {kind!r}")
    return {name: value for name, value, _ in out["checks"]} | {
        "confirmed_msgs_per_s": out["end_to_end"]["confirmed_msgs_per_s"],
        "setup_s": out["setup_s"]}


def confirm_rate(pubs: list, seconds: float) -> float:
    """Confirmed messages a second: every publisher's messages whose
    confirm arrived inside the window, over the window's length. The
    broker confirms in batches of hundreds, so the count moves by a batch
    with where the window's edges fall; the window is long enough that
    this is a small share of it."""
    return sum(r["c1"] - r["c0"] for r in pubs) / seconds


def run(spec: harness.Spec) -> dict:
    import torch

    cuda = spec.device.startswith("cuda")
    if cuda:
        from chanamq_tpu_torch.kernels import router_match

        router_match.library()
    topo = workload.Topology(**topology_args(spec.config))
    server = make_server(spec)
    logdir = tempfile.mkdtemp(prefix="mqbench-")
    try:
        out = asyncio.run(drive(spec, server, topo, logdir))
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        logs = read_logs(logdir, spec.traffic["consumers"])
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    pubs = out["publishers"]
    confirmed = sum(r["c1"] - r["c0"] for r in pubs)
    rate = confirm_rate(pubs, spec.seconds)
    nacked = sum(r["nacked"] for r in pubs)
    got = check(spec, topo, logs, [r["published"] for r in pubs])
    harness.log(f"[node] confirmed {confirmed} in {spec.seconds} s "
                f"({rate:.4f} a second), "
                f"published {[r['published'] for r in pubs]}, "
                f"confirm drain {[round(r['drain_s'], 3) for r in pubs]} s, "
                f"mean fan-out {got['mean_fanout']:.4f} over "
                f"{got['sampled']} sampled, {got['deliveries']} deliveries, "
                f"{out['left_ready']} left ready, "
                f"setup {out['setup_s']:.3f} s")
    readings = out["readings"]
    readings.update(window_s=spec.seconds, confirmed=confirmed)
    checks = [("nacked", nacked, 0),
              ("routed_set_mismatches", got["routed_set_mismatches"], 0),
              ("duplicate_deliveries", got["duplicate_deliveries"], 0),
              ("order_violations", got["order_violations"], 0)]
    return {"setup_s": out["setup_s"],
            "end_to_end": {"confirmed_msgs_per_s": rate},
            "attempted": confirmed, "failed": nacked,
            "correct": out["left_ready"] == 0, "checks": checks,
            "memory_peak_bytes": peak,
            "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "readings": readings}
