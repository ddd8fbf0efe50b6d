"""Broker benchmark harness — the reference's PerfTest matrix, multi-process.

Run as ``python -m chanamq_tpu_torch.bench [mode flags]`` from the repo
root. Every broker it starts, spawned or in-process, routes on
``chana.mq.router.device`` (``cuda`` unless ``CHANAMQ_ROUTER_DEVICE`` says
otherwise, e.g. ``CHANAMQ_ROUTER_DEVICE=cpu`` on a host with no card).
Child roles run as ``python -m chanamq_tpu_torch.bench --role ...``.

Reproduces the shape of the reference's perf specs
(chana-mq-test/perf/publish-consume-spec*.js: {autoAck, manual-ack} x
{transient, persistent}, 3 producers, 3 consumers transient / 1 consumer
persistent, prefetch 5000) against this broker. Like the reference's
RabbitMQ PerfTest, every producer/consumer is its OWN process talking to the
broker process over real sockets, publishers pace themselves with a
publisher-confirm window, and latency is measured client-side from a
timestamp embedded in the message body (publish -> deliver, end to end).

Prints ONE JSON line:
  {"metric": ..., "value": msgs/s, "unit": "msgs/s", "vs_baseline": null, ...}
vs_baseline is null because the reference publishes no numbers
(BASELINE.md: "harness only").

Env knobs: BENCH_SECONDS (default 5), BENCH_BODY_BYTES (default 100),
BENCH_SPECS ("a" = headline transient/autoAck only, "all" = full matrix),
BENCH_CONFIRM_WINDOW (default 2000).
"""

from __future__ import annotations

import asyncio
import json
import os
import socket
import shutil
import subprocess
import sys
import tempfile
import time

# the repository root: children find the package through PYTHONPATH
REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_DIR)

BENCH_SECONDS = float(os.environ.get("BENCH_SECONDS", "5"))
BODY_BYTES = max(16, int(os.environ.get("BENCH_BODY_BYTES", "100")))
CONFIRM_WINDOW = int(os.environ.get("BENCH_CONFIRM_WINDOW", "2000"))
PREFETCH = 5000

SPECS = {
    # name -> (auto_ack, persistent, producers, consumers); mirrors the
    # reference's four spec files
    "transient_autoack_3p3c": (True, False, 3, 3),
    "transient_ack_3p3c": (False, False, 3, 3),
    # same-topology transient twins of the persistent specs: the honest
    # denominators for the WAL overhead ratio (--wal)
    "transient_autoack_3p1c": (True, False, 3, 1),
    "transient_ack_3p1c": (False, False, 3, 1),
    "persistent_autoack_3p1c": (True, True, 3, 1),
    "persistent_ack_3p1c": (False, True, 3, 1),
}

# the remaining BASELINE.json configs: fanout 1 producer -> 8 consumers and
# a topic exchange with wildcard bindings over mixed routing keys (one
# consumer per queue; delivered counts every copy, like PerfTest)
TOPO_SPECS = {
    "fanout_1p8c": {
        "exchange_type": "fanout", "producers": 1,
        "queues": [(f"bench_q{i}", [""]) for i in range(8)],
        "keys": ["bench"],
    },
    "topic_3p3c_wildcards": {
        "exchange_type": "topic", "producers": 3,
        "queues": [("bench_q0", ["quote.*.*"]),
                   ("bench_q1", ["quote.#", "*.eu.msft"]),
                   ("bench_q2", ["#"])],
        "keys": ["quote.us.appl", "quote.eu.msft", "trade.us.goog"],
    },
}

# Paced-load latency spec: the saturated specs above measure queueing delay
# by construction (a full confirm window IS hundreds of ms of in-flight
# messages), so broker latency is measured separately under a fixed-rate
# load well below capacity. The rate is derived from the measured headline
# (~25% of saturated throughput) or BENCH_PACED_RATE.
PACED_SPEC = "paced_latency_1p1c"
PACED_PERSISTENT_SPEC = "paced_persistent_latency_1p1c"


# ---------------------------------------------------------------------------
# child roles
# ---------------------------------------------------------------------------


async def producer_main(
    port: int, persistent: bool, seconds: float, rate: int = 0,
    keys: "list[str] | None" = None, shape: str = "burst",
) -> None:
    from chanamq_tpu_torch.amqp.properties import BasicProperties
    from chanamq_tpu_torch.client import AMQPClient

    keys = keys or ["bench"]
    nkeys = len(keys)
    c = await AMQPClient.connect("127.0.0.1", port)
    ch = await c.channel()
    await ch.confirm_select()
    props = BasicProperties(delivery_mode=2 if persistent else 1)
    pad = b"x" * (BODY_BYTES - 8)
    deadline = time.perf_counter() + seconds
    published = 0
    if rate > 0:
        # fixed-rate pacing: 10 ms micro-bursts (PerfTest --rate shape) by
        # default, or strictly per-message ("smooth") — the burst shape
        # queues up to rate/100 messages at each tick, so its measured p99
        # has a ~10 ms floor that buries sub-ms broker latency
        burst = 1 if shape == "smooth" else max(1, rate // 100)
        next_t = time.perf_counter()
        while time.perf_counter() < deadline:
            for _ in range(burst):
                body = time.time_ns().to_bytes(8, "big") + pad
                ch.basic_publish(body, exchange="bench_ex",
                                 routing_key=keys[published % nkeys],
                                 properties=props)
                published += 1
            next_t += burst / rate
            delay = next_t - time.perf_counter()
            if delay > 0:
                await c.drain()
                await asyncio.sleep(delay)
            if len(ch.unconfirmed) >= CONFIRM_WINDOW:
                await c.drain()
                await ch.wait_unconfirmed_below(CONFIRM_WINDOW // 2)
    else:
        while time.perf_counter() < deadline:
            body = time.time_ns().to_bytes(8, "big") + pad
            ch.basic_publish(body, exchange="bench_ex",
                             routing_key=keys[published % nkeys],
                             properties=props)
            published += 1
            if len(ch.unconfirmed) >= CONFIRM_WINDOW:
                await c.drain()
                await ch.wait_unconfirmed_below(CONFIRM_WINDOW // 2)
    await c.drain()
    try:
        await ch.wait_unconfirmed_below(1, timeout=15)
    except asyncio.TimeoutError:
        pass
    await c.close()
    print(json.dumps({"role": "producer", "published": published}), flush=True)


async def consumer_main(port: int, auto_ack: bool, seconds: float,
                        queue: str = "bench_q") -> None:
    from chanamq_tpu_torch.client import AMQPClient

    c = await AMQPClient.connect("127.0.0.1", port)
    ch = await c.channel()
    if not auto_ack:
        await ch.basic_qos(prefetch_count=PREFETCH)
    delivered = 0
    latencies: list[int] = []

    def on_msg(msg) -> None:
        nonlocal delivered
        delivered += 1
        latencies.append(time.time_ns() - int.from_bytes(msg.body[:8], "big"))
        if not auto_ack and delivered % 500 == 0:
            ch.basic_ack(msg.delivery_tag, multiple=True)

    await ch.basic_consume(queue, on_msg, no_ack=auto_ack)
    # run until producers are done plus drain time
    await asyncio.sleep(seconds + 3)
    if not auto_ack and delivered:
        ch.basic_ack(0, multiple=True)
        await asyncio.sleep(0.2)
    await c.close()
    latencies.sort()
    n = len(latencies)
    stats = {
        "role": "consumer",
        "delivered": delivered,
        "p50_us": latencies[n // 2] / 1000 if n else None,
        "p99_us": latencies[min(n - 1, int(n * 0.99))] / 1000 if n else None,
        "max_us": latencies[-1] / 1000 if n else None,
    }
    print(json.dumps(stats), flush=True)


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------


def wait_port(port: int, timeout: float = 15) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), 0.2).close()
            return
        except OSError:
            time.sleep(0.05)
    raise RuntimeError("broker did not come up")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


async def setup_topology(
    port: int, persistent: bool, exchange_type: str = "direct",
    queues: "list[tuple[str, list[str]]] | None" = None,
) -> None:
    from chanamq_tpu_torch.client import AMQPClient

    queues = queues or [("bench_q", ["bench"])]
    c = await AMQPClient.connect("127.0.0.1", port)
    ch = await c.channel()
    await ch.exchange_declare("bench_ex", exchange_type, durable=persistent)
    for name, bind_keys in queues:
        await ch.queue_declare(name, durable=persistent)
        for key in bind_keys:
            await ch.queue_bind(name, "bench_ex", key)
    await c.close()


def _tail(path: str, limit: int = 2000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - limit))
            return f.read().decode("utf-8", "replace").strip()
    except OSError:
        return ""


def _reap_children(children: list, consumers: int,
                   timeout: float) -> "tuple[list[dict], list[str]]":
    """Collect each child's one-line JSON result (consumers first, then
    producers, matching spawn order); kills and reports stragglers."""
    outputs: list[dict] = []
    errors: list[str] = []
    for i, child in enumerate(children):
        role = "consumer" if i < consumers else "producer"
        try:
            out, err = child.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            child.kill()
            _, err = child.communicate()
            err_lines = err.decode("utf-8", "replace").strip().splitlines()
            tail = f": {err_lines[-1][:300]}" if err_lines else ""
            errors.append(f"{role}[{i}] timed out{tail}")
            continue  # post-kill partial stdout is not a valid result
        lines = out.decode().strip().splitlines()
        if child.returncode != 0 or not lines:
            err_lines = err.decode("utf-8", "replace").strip().splitlines()
            tail = err_lines[-1][:300] if err_lines else "no output"
            errors.append(f"{role}[{i}] rc={child.returncode}: {tail}")
            continue
        try:
            outputs.append(json.loads(lines[-1]))
        except ValueError:
            errors.append(f"{role}[{i}] bad output: {lines[-1][:200]}")
    return outputs, errors


def _proc_cpu_s(pid: int) -> "float | None":
    """Cumulative user+system CPU seconds of a process from
    /proc/<pid>/stat. Sampled around the load window so boot cost (torch
    import is seconds) never pollutes the per-message CPU figure."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            data = f.read().decode("ascii", "replace")
        # comm may contain spaces/parens; real fields start after the
        # last ')': state is field 3, utime/stime are fields 14/15
        fields = data.rpartition(")")[2].split()
        ticks = int(fields[11]) + int(fields[12])
        return ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return None


# ---------------------------------------------------------------------------
# bench trajectory ledger + regression gate
# ---------------------------------------------------------------------------

# the port's own ledger (git-ignored): a port run never writes the
# reference's BENCH_trajectory.jsonl
TRAJECTORY_PATH = os.path.join(REPO_DIR, "BENCH_torch_trajectory.jsonl")


def router_device() -> str:
    """The router device of every broker this harness builds in-process:
    ``chana.mq.router.device`` as the port's config resolves it (default
    ``cuda``; ``CHANAMQ_ROUTER_DEVICE`` overrides). Spawned brokers read
    the same key through the environment they inherit."""
    from chanamq_tpu_torch.config import Config

    return Config().str("chana.mq.router.device")


def _git_rev() -> "str | None":
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=REPO_DIR,
            capture_output=True, timeout=10)
        return out.stdout.decode().strip() or None
    except Exception:
        return None


def _env_fingerprint() -> dict:
    """What must match for two trajectory lines to be comparable: numbers
    from a different core count, body size, run length, or parser
    implementation are history, not baselines."""
    from chanamq_tpu_torch import native_ext

    return {
        "python": sys.version.split()[0],
        "cores": os.cpu_count(),
        "body_bytes": BODY_BYTES,
        "seconds": BENCH_SECONDS,
        "native": native_ext.available(),
    }


def trajectory_record(scenario: str, result: dict) -> "dict | None":
    """Normalize one clean run_spec result into a trajectory line. The
    headline cost is µs of wall per delivered message; cpu_us_per_msg is
    the broker-process CPU ledger (far less noisy than wall on a shared
    box, hence the tighter regression band on it)."""
    delivered_per_s = result.get("delivered_per_s")
    if not delivered_per_s:
        return None
    return {
        "ts": round(time.time(), 1),
        "scenario": scenario,
        "us_per_msg": round(1e6 / delivered_per_s, 3),
        "cpu_us_per_msg": result.get("cpu_us_per_msg"),
        "delivered_per_s": delivered_per_s,
        "p50_us": result.get("p50_us"),
        "p99_us": result.get("p99_us"),
        "rev": _git_rev(),
        "env": _env_fingerprint(),
    }


def trajectory_append(record: dict) -> None:
    with open(TRAJECTORY_PATH, "a") as f:
        f.write(json.dumps(record) + "\n")


def trajectory_baseline(scenario: str,
                        path: str = None,
                        stats: "dict | None" = None) -> "dict | None":
    """Latest recorded run of `scenario` from a comparable environment.

    When `stats` is given, stats["corrupt_lines"] counts unparseable
    lines skipped along the way — a half-written append from a killed
    run must not silently shrink the judged history."""
    env = _env_fingerprint()
    latest = None
    corrupt = 0
    try:
        with open(path or TRAJECTORY_PATH) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    corrupt += 1
                    continue
                if rec.get("scenario") != scenario:
                    continue
                rec_env = rec.get("env") or {}
                if any(rec_env.get(k) != env[k]
                       for k in ("cores", "body_bytes", "seconds",
                                 "native")):
                    continue
                latest = rec
    except OSError:
        if stats is not None:
            stats["corrupt_lines"] = corrupt
        return None
    if stats is not None:
        stats["corrupt_lines"] = corrupt
    return latest


def regress_evaluate(current: dict, base: dict,
                     wall_band: float = 0.20,
                     cpu_band: float = 0.10) -> dict:
    """Pure verdict on one scenario (unit-testable without a broker).

    Regressed only when BOTH per-message costs exceed their noise band:
    wall µs/msg past +20% (the ROADMAP's honest band for 5 s wall numbers
    on a shared box) AND broker CPU µs/msg past +10% (CPU is steadier, so
    the band is tighter). Requiring both keeps a CPU-steal burst in either
    single run from failing the gate; a real regression moves both. Wall
    alone decides when either side lacks the CPU ledger (old record)."""
    cur_wall, base_wall = current.get("us_per_msg"), base.get("us_per_msg")
    cur_cpu, base_cpu = (current.get("cpu_us_per_msg"),
                         base.get("cpu_us_per_msg"))
    wall_over = bool(cur_wall is not None and base_wall
                     and cur_wall > base_wall * (1 + wall_band))
    cpu_over = bool(cur_cpu is not None and base_cpu
                    and cur_cpu > base_cpu * (1 + cpu_band))
    if cur_cpu is None or not base_cpu:
        regressed = wall_over
    else:
        regressed = wall_over and cpu_over
    return {
        "scenario": current.get("scenario"),
        "us_per_msg": cur_wall,
        "base_us_per_msg": base_wall,
        "cpu_us_per_msg": cur_cpu,
        "base_cpu_us_per_msg": base_cpu,
        "wall_band_pct": round(wall_band * 100, 1),
        "cpu_band_pct": round(cpu_band * 100, 1),
        "wall_over": wall_over,
        "cpu_over": cpu_over,
        "base_rev": base.get("rev"),
        "base_ts": base.get("ts"),
        "regressed": regressed,
    }


def run_spec(name: str, rate: int = 0,
             extra_env: "dict | None" = None,
             shape: str = "burst") -> dict:
    persistent = False
    exchange_type = "direct"
    queues = None  # default bench_q/bench
    keys = None
    if name == PACED_SPEC:
        auto_ack, producers, consumers = True, 1, 1
    elif name == PACED_PERSISTENT_SPEC:
        # durable-path latency: publish->deliver through the group-commit
        # store at a rate well below persistent capacity
        auto_ack, producers, consumers = True, 1, 1
        persistent = True
    elif name in TOPO_SPECS:
        topo = TOPO_SPECS[name]
        auto_ack = True
        producers = topo["producers"]
        exchange_type = topo["exchange_type"]
        queues = topo["queues"]
        keys = topo["keys"]
        consumers = len(queues)
    else:
        auto_ack, persistent, producers, consumers = SPECS[name]
    port = free_port()
    env = {**os.environ, "PYTHONPATH": REPO_DIR}
    if extra_env:
        env.update(extra_env)
    broker_args = [sys.executable, "-m", "chanamq_tpu_torch.broker.server",
                   "--host", "127.0.0.1", "--port", str(port),
                   "--no-admin", "--log-level", "WARNING"]
    store_file = None
    if persistent:
        tmp = tempfile.NamedTemporaryFile(suffix=".db", delete=False)
        tmp.close()
        store_file = tmp.name
        broker_args += ["--store", store_file]
    # Broker stderr goes to a file so a failed spec can report the tail
    # instead of an opaque crash.
    broker_log = tempfile.NamedTemporaryFile(
        suffix=".log", prefix="bench-broker-", delete=False)
    broker = subprocess.Popen(broker_args, env=env,
                              stdout=broker_log, stderr=broker_log)
    children = []
    errors: list[str] = []
    outputs: list[dict] = []
    elapsed = 0.0
    cpu0 = cpu1 = None
    try:
        wait_port(port)
        asyncio.run(setup_topology(port, persistent, exchange_type, queues))
        # broker CPU around the load window only: boot (torch import) and
        # teardown are excluded from the per-message figure
        cpu0 = _proc_cpu_s(broker.pid)
        queue_names = [q for q, _ in queues] if queues else ["bench_q"]
        for i in range(consumers):
            children.append(subprocess.Popen(
                [sys.executable, "-m", "chanamq_tpu_torch.bench", "--role", "consumer",
                 "--port", str(port), "--auto-ack", str(int(auto_ack)),
                 "--seconds", str(BENCH_SECONDS),
                 "--queue", queue_names[i % len(queue_names)]],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        time.sleep(0.3)
        t0 = time.perf_counter()
        producer_args = []
        if keys:
            producer_args = ["--keys", ",".join(keys)]
        for _ in range(producers):
            children.append(subprocess.Popen(
                [sys.executable, "-m", "chanamq_tpu_torch.bench", "--role", "producer",
                 "--port", str(port), "--persistent", str(int(persistent)),
                 "--seconds", str(BENCH_SECONDS), "--rate", str(rate),
                 "--shape", shape]
                + producer_args,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        outs, errs = _reap_children(children, consumers, BENCH_SECONDS + 60)
        outputs.extend(outs)
        errors.extend(errs)
        elapsed = time.perf_counter() - t0
        cpu1 = _proc_cpu_s(broker.pid)
    except Exception as exc:  # noqa: BLE001 — a red spec must stay parseable
        for child in children:
            if child.poll() is None:
                child.kill()
            child.communicate()  # reap: no zombies/leaked pipe fds
        errors.append(f"{type(exc).__name__}: {exc}")
    finally:
        broker.terminate()
        try:
            broker.wait(timeout=10)
        except subprocess.TimeoutExpired:
            broker.kill()
            broker.wait()
        broker_log.close()
        if store_file:
            try:
                os.unlink(store_file)
            except OSError:
                pass
            # the WAL engine keeps its segments beside the SQLite file
            shutil.rmtree(store_file + ".wal", ignore_errors=True)
    if broker.returncode not in (0, -15):
        errors.append(f"broker rc={broker.returncode}")
    if errors:
        result = {"error": "; ".join(errors)}
        tail = _tail(broker_log.name)
        if tail:
            result["broker_stderr_tail"] = tail[-800:]
        if outputs:  # partial results still help diagnosis
            result["partial_outputs"] = outputs
        try:
            os.unlink(broker_log.name)
        except OSError:
            pass
        return result
    try:
        os.unlink(broker_log.name)
    except OSError:
        pass
    published = sum(o.get("published", 0) for o in outputs)
    delivered = sum(o.get("delivered", 0) for o in outputs)
    p99s = [o["p99_us"] for o in outputs if o.get("p99_us") is not None]
    p50s = [o["p50_us"] for o in outputs if o.get("p50_us") is not None]
    broker_cpu_s = (round(cpu1 - cpu0, 3)
                    if cpu0 is not None and cpu1 is not None else None)
    return {
        "published_per_s": round(published / BENCH_SECONDS, 1),
        "delivered_per_s": round(delivered / BENCH_SECONDS, 1),
        "published": published,
        "delivered": delivered,
        "p50_us": round(max(p50s), 1) if p50s else None,
        "p99_us": round(max(p99s), 1) if p99s else None,
        "wall_s": round(elapsed, 2),
        "broker_cpu_s": broker_cpu_s,
        "cpu_us_per_msg": (round(broker_cpu_s * 1e6 / delivered, 2)
                           if broker_cpu_s is not None and delivered
                           else None),
    }


def _spawn_store_broker(port: int, store_path: str, env: dict, log_file):
    return subprocess.Popen(
        [sys.executable, "-m", "chanamq_tpu_torch.broker.server",
         "--host", "127.0.0.1", "--port", str(port),
         "--no-admin", "--log-level", "WARNING", "--store", store_path],
        env=env, stdout=log_file, stderr=log_file)


def run_wal_recovery_smoke(kill_after_confirms: int = 200,
                           batch: int = 25) -> dict:
    """The kill-9 durability drill: publish persistent messages with
    confirms against a WAL-backed broker subprocess, SIGKILL it mid-stream
    (unconfirmed batch in flight), restart on the same store, drain the
    queue — every confirmed message must come back. The confirmed set is
    exact because a batch only enters it after its last confirm arrived,
    and a WAL confirm means the group commit fsynced it."""
    from chanamq_tpu_torch.amqp.properties import BasicProperties
    from chanamq_tpu_torch.client import AMQPClient

    tmpdir = tempfile.mkdtemp(prefix="bench-walrec-")
    store_path = os.path.join(tmpdir, "broker.db")
    port = free_port()
    env = {**os.environ,
           "PYTHONPATH": REPO_DIR}
    log_file = open(os.path.join(tmpdir, "broker.log"), "ab")
    broker = _spawn_store_broker(port, store_path, env, log_file)
    confirmed: list[bytes] = []
    in_flight = 0
    persistent = BasicProperties(delivery_mode=2)

    async def publish_until_killed() -> None:
        nonlocal in_flight
        conn = await AMQPClient.connect("127.0.0.1", port)
        try:
            ch = await conn.channel()
            await ch.confirm_select()
            await ch.queue_declare("walq", durable=True)
            i = 0
            while i < 100_000:
                bodies = [b"w%06d" % (i + j) for j in range(batch)]
                try:
                    in_flight = len(bodies)
                    for body in bodies:
                        ch.basic_publish(body, routing_key="walq",
                                         properties=persistent)
                    if len(confirmed) >= kill_after_confirms:
                        # the batch above is on the wire, unconfirmed:
                        # the kill lands mid-publish by construction
                        broker.kill()
                    await ch.wait_unconfirmed_below(1, timeout=10)
                except Exception:
                    return  # connection died with the broker
                confirmed.extend(bodies)
                in_flight = 0
                i += batch
        finally:
            try:
                await conn.close()
            except Exception:
                pass

    async def drain() -> set:
        conn = await AMQPClient.connect("127.0.0.1", port)
        try:
            ch = await conn.channel()
            await ch.basic_qos(prefetch_count=PREFETCH)
            got: set = set()
            event = asyncio.Event()

            def on_msg(msg):
                got.add(bytes(msg.body))
                event.set()

            await ch.basic_consume("walq", on_msg, no_ack=True)
            while True:
                event.clear()
                try:
                    await asyncio.wait_for(event.wait(), 2.0)
                except asyncio.TimeoutError:
                    return got
        finally:
            try:
                await conn.close()
            except Exception:
                pass

    t_recover = None
    try:
        wait_port(port)
        asyncio.run(publish_until_killed())
        broker.kill()
        broker.wait()

        t0 = time.perf_counter()
        broker = _spawn_store_broker(port, store_path, env, log_file)
        wait_port(port)
        t_recover = time.perf_counter() - t0
        delivered = asyncio.run(drain())
    finally:
        broker.kill()
        broker.wait()
        log_file.close()
        shutil.rmtree(tmpdir, ignore_errors=True)

    missing = sorted(b.decode() for b in set(confirmed) - delivered)
    return {
        "confirmed": len(confirmed),
        "in_flight_at_kill": in_flight,
        "delivered": len(delivered),
        "lost_confirmed": len(missing),
        "lost_first": missing[:5],
        "recover_s": round(t_recover, 2) if t_recover is not None else None,
    }


async def _start_cluster_node(seeds, store_factory, **cluster_kwargs):
    """Shared bootstrap for the in-process 2-node specs: a BrokerServer on
    an ephemeral port wrapped in a ClusterNode joined to `seeds`. The store
    backend and replication knobs are the only things the specs vary."""
    from chanamq_tpu_torch.broker.broker import Broker
    from chanamq_tpu_torch.broker.server import BrokerServer
    from chanamq_tpu_torch.cluster.node import ClusterNode

    srv = BrokerServer(
        broker=Broker(store=store_factory(), router_device=router_device()),
        host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    cl = ClusterNode(srv.broker, "127.0.0.1", 0, seeds,
                     heartbeat_interval_s=0.2, failure_timeout_s=5,
                     **cluster_kwargs)
    await cl.start()
    return srv, cl


async def _admin_get(port: int, path: str) -> dict:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(-1), 10)
    writer.close()
    return json.loads(raw.partition(b"\r\n\r\n")[2])


async def _admin_text(port: int, path: str) -> str:
    """Like _admin_get but for text/plain payloads (collapsed stacks)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(-1), 10)
    writer.close()
    return raw.partition(b"\r\n\r\n")[2].decode("utf-8", "replace")


async def _trace_gate(admin_port: int, node_names: set) -> dict:
    """BENCH_TRACE=1 smoke gate: scrape /admin/traces and demand at least
    one stitched cross-node trace (>=5 stages spanning >=2 nodes) — the
    whole point of the trailer propagation. Raises to fail the bench."""
    body = await _admin_get(admin_port, "/admin/traces")
    traces = body.get("recent", []) + body.get("slow", [])
    best = None
    for t in traces:
        if len(t.get("nodes", [])) >= 2 and t.get("spans", 0) >= 5:
            if best is None or t["spans"] > best["spans"]:
                best = t
    if best is None:
        raise RuntimeError(
            f"no stitched cross-node trace with >=5 stages among "
            f"{len(traces)} captured (nodes={sorted(node_names)})")
    from urllib.parse import quote

    detail = await _admin_get(
        admin_port, f"/admin/traces/{quote(best['id'], safe='')}")
    return {
        "stitched_id": best["id"],
        "spans": best["spans"],
        "nodes": best["nodes"],
        "total_us": best["total_us"],
        "stages": sorted(detail.get("stages", {})),
        "captured": len(traces),
    }


async def _cluster_spec() -> dict:
    """Two in-process nodes sharing a store: publish a burst via the
    NON-owner (batch-pipelined queue.push_many), then consume remotely
    (per-tick deliver_many events). Evidence for the cluster fast paths;
    in-process, so both nodes share this one core."""
    from chanamq_tpu_torch.client import AMQPClient
    from chanamq_tpu_torch.store.sqlite import SqliteStore

    tmpdir = tempfile.mkdtemp(prefix="bench-cluster-")
    store = os.path.join(tmpdir, "shared.db")

    def start_node(seeds):
        return _start_cluster_node(seeds, lambda: SqliteStore(store))

    a_srv = a_cl = b_srv = b_cl = None
    trace_mod = admin = None
    try:
        a_srv, a_cl = await start_node([])
        b_srv, b_cl = await start_node([a_cl.name])
        if os.environ.get("BENCH_TRACE"):
            # trace every publish and expose A's admin API so the tier-1
            # smoke can demand a stitched cross-node trace (both brokers
            # share the one in-process ACTIVE; per-broker trace_node still
            # attributes each span to the right node)
            from chanamq_tpu_torch import trace as trace_mod
            from chanamq_tpu_torch.rest.admin import AdminServer

            trace_mod.install(trace_mod.TraceRuntime(
                sample_rate=1.0, ring_size=1024,
                metrics=a_srv.broker.metrics, node=a_cl.name))
            admin = AdminServer(a_srv.broker, port=0)
            await admin.start()
        for _ in range(100):
            if (len(a_cl.membership.alive_members()) == 2
                    and len(b_cl.membership.alive_members()) == 2):
                break
            await asyncio.sleep(0.05)
        else:
            raise RuntimeError("2-node membership did not converge")
        qn = next(f"bq{i}" for i in range(200)
                  if a_cl.queue_owner("/", f"bq{i}") == b_cl.name)
        n = 5000
        body = b"x" * BODY_BYTES

        # publish via non-owner A -> owner B, confirmed
        c = await AMQPClient.connect("127.0.0.1", a_srv.bound_port)
        ch = await c.channel()
        await ch.confirm_select()
        await ch.queue_declare(qn)
        # the owner's metadata broadcast is fire-and-forget: wait for A to
        # learn the queue exists, else default-exchange publishes racing
        # the replication are silently unroutable
        for _ in range(100):
            if ("/", qn) in a_cl.queue_metas:
                break
            await asyncio.sleep(0.05)
        else:
            raise RuntimeError(f"queue meta for {qn} never replicated")
        t0 = time.perf_counter()
        for _ in range(n):
            ch.basic_publish(body, routing_key=qn)
        await ch.wait_unconfirmed_below(1, timeout=60)
        publish_rate = n / (time.perf_counter() - t0)

        # consume the backlog remotely: owner B -> origin A
        loop = asyncio.get_event_loop()
        got = 0
        done = loop.create_future()
        lat_ns: list = []
        paced_n = 500
        paced_done = loop.create_future()
        phase = {"paced": False}

        def cb(m):
            nonlocal got
            if phase["paced"]:
                lat_ns.append(time.perf_counter_ns() - int(bytes(m.body[:19])))
                if len(lat_ns) >= paced_n and not paced_done.done():
                    paced_done.set_result(None)
                return
            got += 1
            if got >= n and not done.done():
                done.set_result(None)

        t0 = time.perf_counter()
        await ch.basic_consume(qn, cb, no_ack=True)
        await asyncio.wait_for(done, 60)
        consume_rate = n / (time.perf_counter() - t0)

        # paced latency phase: publish -> remote push -> owner dispatch ->
        # remote deliver -> origin render, timed end to end off one clock
        # (both nodes are in-process). ~1k msgs/s, far below saturation, so
        # this measures the interconnect's added latency, not queueing.
        phase["paced"] = True
        stamp_pad = 19  # perf_counter_ns as fixed-width decimal
        for _ in range(paced_n):
            stamp = str(time.perf_counter_ns()).rjust(stamp_pad, "0").encode()
            ch.basic_publish(stamp + body, routing_key=qn)
            await asyncio.sleep(0.001)
        await asyncio.wait_for(paced_done, 60)
        lat_ns.sort()
        await c.close()

        trace_gate = None
        if trace_mod is not None:
            trace_gate = await _trace_gate(admin.bound_port,
                                           {a_cl.name, b_cl.name})

        am, bm = a_srv.broker.metrics, b_srv.broker.metrics
        return {
            **({"trace_gate": trace_gate} if trace_gate is not None else {}),
            "publish_via_nonowner_msgs_per_s": round(publish_rate, 1),
            "remote_consume_msgs_per_s": round(consume_rate, 1),
            "remote_p50_us": round(lat_ns[len(lat_ns) // 2] / 1000, 1),
            "remote_p99_us": round(
                lat_ns[min(len(lat_ns) - 1, int(len(lat_ns) * 0.99))] / 1000, 1),
            "messages": n,
            "interconnect": {
                "push_records": am.rpc_push_records,
                "push_batches": am.rpc_push_batches,
                "deliver_records": bm.rpc_deliver_records,
                "deliver_batches": bm.rpc_deliver_batches,
                "settle_records": am.rpc_settle_records,
                "settle_batches": am.rpc_settle_batches,
                "data_bytes_sent": am.rpc_data_bytes_sent + bm.rpc_data_bytes_sent,
                "data_bytes_recv": am.rpc_data_bytes_recv + bm.rpc_data_bytes_recv,
                "flushes": {
                    "window": am.rpc_flush_window + bm.rpc_flush_window,
                    "bytes": am.rpc_flush_bytes + bm.rpc_flush_bytes,
                    "count": am.rpc_flush_count + bm.rpc_flush_count,
                    "demand": am.rpc_flush_demand + bm.rpc_flush_demand,
                },
            },
        }
    finally:
        if admin is not None:
            try:
                await admin.stop()
            except Exception:
                pass
        if trace_mod is not None:
            trace_mod.clear()
        for part in (b_cl, b_srv, a_cl, a_srv):
            if part is not None:
                try:
                    await part.stop()
                except Exception:
                    pass
        shutil.rmtree(tmpdir, ignore_errors=True)


def run_cluster_spec() -> dict:
    try:
        return asyncio.run(asyncio.wait_for(_cluster_spec(), timeout=120))
    except Exception as exc:
        return {"error": f"{type(exc).__name__}: {exc}"}


# ---------------------------------------------------------------------------
# sharded node (chanamq_tpu_torch/shard/): one broker process per core
# ---------------------------------------------------------------------------

SHARD_QUEUE_COUNT = 4
SHARD_PRODUCERS = 3


def _free_port_block(n: int) -> int:
    """Base of `n` consecutive free TCP ports (shard i's listener is
    base + i, so the whole block must be bindable)."""
    for _ in range(64):
        socks: list = []
        try:
            first = socket.socket()
            first.bind(("127.0.0.1", 0))
            base = first.getsockname()[1]
            socks.append(first)
            for i in range(1, n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no block of {n} consecutive free ports")


async def _shard_wait_ready(admin_ports: "list[int]", count: int,
                            timeout: float = 30) -> None:
    """Every worker's admin is up and its membership sees all siblings."""
    deadline = time.time() + timeout
    last = "no shard responded yet"
    while time.time() < deadline:
        try:
            if count == 1:
                await _admin_get(admin_ports[0], "/admin/overview")
                return
            converged = 0
            for port in admin_ports:
                body = await _admin_get(port, "/admin/cluster")
                if body.get("enabled") and len(body.get("alive", [])) >= count:
                    converged += 1
            if converged == count:
                return
            last = f"{converged}/{count} shards converged"
        except (OSError, ValueError, asyncio.TimeoutError) as exc:
            last = repr(exc)
        await asyncio.sleep(0.2)
    raise RuntimeError(f"sharded node not ready: {last}")


async def _shard_wait_metas(admin_ports: "list[int]", n_queues: int,
                            timeout: float = 15) -> None:
    """The fire-and-forget metadata broadcast reached every shard — a
    producer whose connection lands on a shard that hasn't heard of
    bench_ex yet would publish unroutably."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            bodies = [await _admin_get(p, "/admin/cluster")
                      for p in admin_ports]
            if all(b.get("known_queues", 0) >= n_queues for b in bodies):
                return
        except (OSError, ValueError, asyncio.TimeoutError):
            pass
        await asyncio.sleep(0.1)
    raise RuntimeError(f"queue metadata did not reach all "
                       f"{len(admin_ports)} shards")


async def _shard_scrape(admin_ports: "list[int]") -> dict:
    """Per-shard broker counters off each worker's /admin/metrics."""
    per_shard = {}
    for i, port in enumerate(admin_ports):
        snap = await _admin_get(port, "/admin/metrics")
        per_shard[str(i)] = {
            "published": snap.get("published_msgs"),
            "delivered": snap.get("delivered_msgs"),
            "delivered_per_s": round(
                (snap.get("delivered_msgs") or 0) / BENCH_SECONDS, 1),
            "cross_pushes": snap.get("shard_cross_pushes"),
            "handoffs": snap.get("shard_handoffs"),
            "restarts": snap.get("shard_restarts"),
        }
    return per_shard


def run_shard_spec(count: int) -> dict:
    """One broker *node* at `count` shards (1 = the unsharded baseline):
    the saturated transient/autoack workload spread over SHARD_QUEUE_COUNT
    queues, then a paced 1p1c latency phase on its own idle queue. The
    node is a single subprocess — past one shard it becomes the
    supervisor and spawns one worker per shard; SO_REUSEPORT spreads the
    client connections, the hash ring spreads queue ownership, and every
    cross-shard message rides the UDS data plane. Per-shard counters come
    from each worker's own admin endpoint (admin base + shard index)."""
    port = free_port()
    admin_base = _free_port_block(count)
    cluster_base = _free_port_block(count)
    shard_dir = tempfile.mkdtemp(prefix="bench-shards-")
    env = {**os.environ,
           "PYTHONPATH": REPO_DIR,
           "CHANAMQ_SHARD_COUNT": str(count),
           "CHANAMQ_SHARD_DIR": shard_dir,
           "CHANAMQ_CLUSTER_HOST": "127.0.0.1",
           "CHANAMQ_CLUSTER_PORT": str(cluster_base)}
    broker_log = tempfile.NamedTemporaryFile(
        suffix=".log", prefix="bench-shards-", delete=False)
    broker = subprocess.Popen(
        [sys.executable, "-m", "chanamq_tpu_torch.broker.server",
         "--host", "127.0.0.1", "--port", str(port),
         "--admin-port", str(admin_base), "--log-level", "WARNING"],
        env=env, stdout=broker_log, stderr=broker_log)
    admin_ports = [admin_base + i for i in range(count)]
    keys = [f"bench{i}" for i in range(SHARD_QUEUE_COUNT)]
    queues = [(f"bench_q{i}", [keys[i]]) for i in range(SHARD_QUEUE_COUNT)]
    queues.append(("bench_paced", ["paced"]))
    children: list = []
    errors: list[str] = []
    outputs: list[dict] = []
    paced_outputs: list[dict] = []
    per_shard: dict = {}
    paced_rate = 0
    elapsed = 0.0
    try:
        wait_port(port)
        asyncio.run(_shard_wait_ready(admin_ports, count))
        # declares idempotently retry: right after boot a shard's outbound
        # RPC client to a sibling can still be in reconnect backoff from
        # dialing before that sibling's listener was up, which fails the
        # forwarded remote declare once
        for attempt in range(5):
            try:
                asyncio.run(setup_topology(port, False, "direct", queues))
                break
            except Exception as exc:  # noqa: BLE001
                if attempt == 4:
                    raise RuntimeError(
                        f"topology setup kept failing: {exc!r}") from exc
                time.sleep(0.5)
        if count > 1:
            asyncio.run(_shard_wait_metas(admin_ports, len(queues)))
        # phase 1: saturated transient/autoack across all queues
        for i in range(SHARD_QUEUE_COUNT):
            children.append(subprocess.Popen(
                [sys.executable, "-m", "chanamq_tpu_torch.bench", "--role", "consumer",
                 "--port", str(port), "--auto-ack", "1",
                 "--seconds", str(BENCH_SECONDS),
                 "--queue", f"bench_q{i}"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        time.sleep(0.3)
        t0 = time.perf_counter()
        for _ in range(SHARD_PRODUCERS):
            children.append(subprocess.Popen(
                [sys.executable, "-m", "chanamq_tpu_torch.bench", "--role", "producer",
                 "--port", str(port), "--persistent", "0",
                 "--seconds", str(BENCH_SECONDS), "--rate", "0",
                 "--keys", ",".join(keys)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        outs, errs = _reap_children(
            children, SHARD_QUEUE_COUNT, BENCH_SECONDS + 60)
        outputs.extend(outs)
        errors.extend(errs)
        elapsed = time.perf_counter() - t0
        per_shard = asyncio.run(_shard_scrape(admin_ports))
        # phase 2: paced latency on the idle bench_paced queue (its own
        # queue so stale saturated-phase backlog can't pollute the p99),
        # at ~25% of the measured rate — queue delay excluded by design
        delivered_per_s = sum(
            o.get("delivered", 0) for o in outputs) / BENCH_SECONDS
        rate_env = os.environ.get("BENCH_SHARD_PACED_RATE")
        if rate_env is not None:
            paced_rate = int(rate_env)
        else:
            paced_rate = max(500, int(delivered_per_s * 0.25))
        if not errors and delivered_per_s > 0:
            paced_children = [subprocess.Popen(
                [sys.executable, "-m", "chanamq_tpu_torch.bench", "--role", "consumer",
                 "--port", str(port), "--auto-ack", "1",
                 "--seconds", str(BENCH_SECONDS),
                 "--queue", "bench_paced"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)]
            time.sleep(0.3)
            paced_children.append(subprocess.Popen(
                [sys.executable, "-m", "chanamq_tpu_torch.bench", "--role", "producer",
                 "--port", str(port), "--persistent", "0",
                 "--seconds", str(BENCH_SECONDS),
                 "--rate", str(paced_rate), "--keys", "paced"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
            paced_outputs, errs = _reap_children(
                paced_children, 1, BENCH_SECONDS + 60)
            errors.extend(errs)
    except Exception as exc:  # noqa: BLE001 — a red spec must stay parseable
        for child in children:
            if child.poll() is None:
                child.kill()
            child.communicate()  # reap: no zombies/leaked pipe fds
        errors.append(f"{type(exc).__name__}: {exc}")
    finally:
        broker.terminate()
        try:
            # past one shard the node is a supervisor: give it time to
            # SIGTERM and reap every worker before escalating
            broker.wait(timeout=20)
        except subprocess.TimeoutExpired:
            broker.kill()
            broker.wait()
        broker_log.close()
        shutil.rmtree(shard_dir, ignore_errors=True)
    if broker.returncode not in (0, -15):
        errors.append(f"broker rc={broker.returncode}")
    if errors:
        result = {"shards": count, "error": "; ".join(errors)}
        tail = _tail(broker_log.name)
        if tail:
            result["broker_stderr_tail"] = tail[-800:]
        if outputs:
            result["partial_outputs"] = outputs
        try:
            os.unlink(broker_log.name)
        except OSError:
            pass
        return result
    try:
        os.unlink(broker_log.name)
    except OSError:
        pass
    published = sum(o.get("published", 0) for o in outputs)
    delivered = sum(o.get("delivered", 0) for o in outputs)
    p99s = [o["p99_us"] for o in outputs if o.get("p99_us") is not None]
    shard_published = sum(
        s.get("published") or 0 for s in per_shard.values())
    cross_pushes = sum(s.get("cross_pushes") or 0 for s in per_shard.values())
    paced = paced_outputs[0] if paced_outputs else {}
    return {
        "shards": count,
        "published_per_s": round(published / BENCH_SECONDS, 1),
        "delivered_per_s": round(delivered / BENCH_SECONDS, 1),
        "published": published,
        "delivered": delivered,
        "p99_us": round(max(p99s), 1) if p99s else None,
        "per_shard": per_shard,
        "cross_shard_push_ratio": (
            round(cross_pushes / shard_published, 3)
            if count > 1 and shard_published else 0.0),
        "paced_rate": paced_rate,
        "paced_p50_us": paced.get("p50_us"),
        "paced_p99_us": paced.get("p99_us"),
        "wall_s": round(elapsed, 2),
    }


async def _replicate_spec() -> dict:
    """Two in-process nodes with PRIVATE MemoryStores, replicate.factor=2 +
    sync=true: persistent confirmed publishes to the owner, so every confirm
    gates on the follower's replication ack. Measures the price of the
    synchronous durability upgrade (confirm latency) plus the shipping
    pipeline's health (event lag, per-batch ack latency)."""
    from chanamq_tpu_torch.amqp.properties import BasicProperties
    from chanamq_tpu_torch.client import AMQPClient
    from chanamq_tpu_torch.store.memory import MemoryStore

    persistent = BasicProperties(delivery_mode=2)

    def start_node(seeds):
        return _start_cluster_node(
            seeds, MemoryStore, replicate_factor=2, replicate_sync=True,
            replicate_ack_timeout_ms=2000)

    a_srv = a_cl = b_srv = b_cl = None
    try:
        a_srv, a_cl = await start_node([])
        b_srv, b_cl = await start_node([a_cl.name])
        for _ in range(100):
            if (len(a_cl.membership.alive_members()) == 2
                    and len(b_cl.membership.alive_members()) == 2):
                break
            await asyncio.sleep(0.05)
        else:
            raise RuntimeError("2-node membership did not converge")
        # a queue OWNED by node A: publishes ride the local fast path and
        # the confirm barrier's replication gate, not a remote push
        qn = next(f"rq{i}" for i in range(200)
                  if a_cl.queue_owner("/", f"rq{i}") == a_cl.name)
        body = b"x" * BODY_BYTES
        c = await AMQPClient.connect("127.0.0.1", a_srv.bound_port)
        ch = await c.channel()
        await ch.confirm_select()
        await ch.queue_declare(qn, durable=True)

        # confirm latency: solo publishes, each awaiting its own confirm
        lat_us = []
        for _ in range(200):
            t0 = time.perf_counter()
            ch.basic_publish(body, routing_key=qn, properties=persistent)
            await ch.wait_unconfirmed_below(1, timeout=10)
            lat_us.append((time.perf_counter() - t0) * 1e6)
        lat_us.sort()

        # throughput: one pipelined confirmed burst
        n = 2000
        t0 = time.perf_counter()
        for _ in range(n):
            ch.basic_publish(body, routing_key=qn, properties=persistent)
        await ch.wait_unconfirmed_below(1, timeout=60)
        rate = n / (time.perf_counter() - t0)
        await c.close()

        repl = a_cl.replication
        snap = a_srv.broker.metrics.snapshot()
        follower_applied = sum(
            copy.applied_seq for copy in b_cl.replication.applier.copies.values())
        return {
            "sync_confirm_p50_us": round(lat_us[len(lat_us) // 2], 1),
            "sync_confirm_p99_us": round(lat_us[int(len(lat_us) * 0.99)], 1),
            "sync_publish_msgs_per_s": round(rate, 1),
            "repl_lag_events": repl.total_lag(),
            "repl_ack_p50_us": snap.get("repl_ack_p50_us"),
            "repl_ack_p99_us": snap.get("repl_ack_p99_us"),
            "events_shipped": snap.get("repl_events_shipped"),
            "batches_shipped": snap.get("repl_batches_shipped"),
            "ack_timeouts": snap.get("repl_ack_timeouts"),
            "follower_applied_seq": follower_applied,
            "messages": n + len(lat_us),
        }
    finally:
        for part in (b_cl, b_srv, a_cl, a_srv):
            if part is not None:
                try:
                    await part.stop()
                except Exception:
                    pass


def run_replicate_spec() -> dict:
    try:
        return asyncio.run(asyncio.wait_for(_replicate_spec(), timeout=120))
    except Exception as exc:
        return {"error": f"{type(exc).__name__}: {exc}"}


async def _stream_spec() -> dict:
    """Stream-queue scenario: ONE confirmed producer appends to an
    x-queue-type=stream queue while THREE independent cursors read it —
    attached at "first" (replays the pre-run backlog then follows),
    "next" (tail only) and a mid-run timestamp — every cursor manual-ack
    through prefetch credit. Reports publish throughput plus each
    cursor's committed lag, read off the live queue object."""
    from chanamq_tpu_torch.amqp.properties import BasicProperties
    from chanamq_tpu_torch.amqp.value_codec import Timestamp
    from chanamq_tpu_torch.broker.broker import Broker
    from chanamq_tpu_torch.broker.server import BrokerServer
    from chanamq_tpu_torch.client import AMQPClient
    from chanamq_tpu_torch.store.memory import MemoryStore

    qn = "bench_stream"
    warmup = 2000
    srv = BrokerServer(
        broker=Broker(store=MemoryStore(), router_device=router_device()),
        host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    conn_p = conn_c = None
    try:
        conn_p = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        pch = await conn_p.channel()
        await pch.confirm_select()
        await pch.queue_declare(qn, durable=True,
                                arguments={"x-queue-type": "stream"})
        props = BasicProperties(delivery_mode=2)
        pad = b"x" * BODY_BYTES

        # pre-run backlog: only the "first" cursor should replay this
        for _ in range(warmup):
            pch.basic_publish(pad, routing_key=qn, properties=props)
        await pch.wait_unconfirmed_below(1, timeout=30)
        attach_ts = Timestamp(int(time.time()))

        conn_c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        counts = {"first": 0, "next": 0, "timestamp": 0}
        channels = {}
        for cursor, offset_spec in (("first", "first"), ("next", "next"),
                                    ("timestamp", attach_ts)):
            ch = await conn_c.channel()
            await ch.basic_qos(prefetch_count=PREFETCH)

            def on_msg(msg, cursor=cursor, ch=ch):
                counts[cursor] += 1
                if counts[cursor] % 500 == 0:
                    ch.basic_ack(msg.delivery_tag, multiple=True)

            await ch.basic_consume(
                qn, on_msg, consumer_tag=f"bench-{cursor}",
                arguments={"x-stream-offset": offset_spec})
            channels[cursor] = ch

        deadline = time.perf_counter() + BENCH_SECONDS
        t0 = time.perf_counter()
        published = 0
        while time.perf_counter() < deadline:
            pch.basic_publish(pad, routing_key=qn, properties=props)
            published += 1
            if len(pch.unconfirmed) >= CONFIRM_WINDOW:
                await conn_p.drain()
                await pch.wait_unconfirmed_below(CONFIRM_WINDOW // 2)
        await conn_p.drain()
        await pch.wait_unconfirmed_below(1, timeout=30)
        publish_rate = published / (time.perf_counter() - t0)

        # drain: every cursor reaches the tail (first also replays warmup)
        targets = {"first": warmup + published, "next": published,
                   "timestamp": published}
        for _ in range(200):
            if all(counts[c] >= targets[c] for c in counts):
                break
            await asyncio.sleep(0.05)
        run_s = time.perf_counter() - t0
        for cursor, ch in channels.items():
            if counts[cursor]:
                ch.basic_ack(0, multiple=True)
        await asyncio.sleep(0.3)  # let the final acks commit cursors

        queue = srv.broker.vhosts["/"].queues[qn]
        lags = {c: queue.cursor_lag(f"bench-{c}") for c in counts}
        snap = srv.broker.metrics.snapshot()
        return {
            "published": published,
            "published_per_s": round(publish_rate, 1),
            "delivered": dict(counts),
            "delivered_per_s_total": round(sum(counts.values()) / run_s, 1),
            "cursor_lag": lags,
            "segments": queue.segment_count,
            "retained_bytes": queue.retained_bytes,
            "stream_cursor_commits": snap.get("stream_cursor_commits"),
        }
    finally:
        for conn in (conn_c, conn_p):
            if conn is not None:
                try:
                    await conn.close()
                except Exception:
                    pass
        await srv.stop()


def run_stream_spec() -> dict:
    try:
        return asyncio.run(asyncio.wait_for(_stream_spec(), timeout=120))
    except Exception as exc:
        return {"error": f"{type(exc).__name__}: {exc}"}


# ---------------------------------------------------------------------------
# --route: tensorized router microbench (compile + batch-route vs trie)
# ---------------------------------------------------------------------------

def _route_build_matcher(n: int):
    """Binding corpus at size n: exact-heavy (the shape compiled into the
    host dict) with a capped wildcard tail (the shape the kernel handles),
    mirroring a direct/topic production mix."""
    from chanamq_tpu_torch.broker.matchers import TopicMatcher

    m = TopicMatcher()
    n_wild = min(256, max(16, n // 100))
    for i in range(n - n_wild):
        m.bind(f"t{i % 97}.k{i}.s{i % 31}", f"q{i % 512}")
    for i in range(n_wild):
        pattern = (f"t{i % 97}.*.s{i % 31}" if i % 2
                   else f"w{i % 97}.k{i}.#")
        m.bind(pattern, f"wq{i % 64}")
    return m


def _route_keys(n: int, msgs: int, rng) -> list:
    """Message corpus: drawn from a bounded pool of active routing keys
    (pub/sub traffic reuses keys heavily — topics are stable, messages
    are not), pool mix ~70% exact hits, ~15% wildcard-shaped, ~15%
    misses."""
    pool = []
    pool_size = min(max(msgs // 8, 256), 2048)
    for _ in range(pool_size):
        r = rng.random()
        if r < 0.70:
            i = rng.randrange(n)
            pool.append(f"t{i % 97}.k{i}.s{i % 31}")
        elif r < 0.85:
            i = rng.randrange(max(1, n // 100))
            pool.append(f"t{i % 97}.x{rng.randrange(1000)}.s{i % 31}")
        else:
            pool.append(f"miss.{rng.randrange(10 ** 6)}.z")
    return [rng.choice(pool) for _ in range(msgs)]


def run_route_spec(quick: bool = False) -> dict:
    """Batched tensor routing vs per-message trie walks, single process,
    single core: compile time, µs/msg at each binding-table size, parity
    spot checks, and a 100-group key-shared fan-out through a live broker."""
    import random

    from chanamq_tpu_torch.router.compile import compile_exchange, route_batch

    device = router_device()
    rng = random.Random(8)
    sizes = [1_000, 10_000] if quick else [1_000, 10_000, 100_000]
    msgs = 2048 if quick else 16384
    batch = 512
    out: dict = {"batch": batch, "msgs": msgs, "sizes": {}}

    for n in sizes:
        m = _route_build_matcher(n)
        t0 = time.perf_counter()
        compiled = compile_exchange("topic", m.bindings())
        compile_s = time.perf_counter() - t0
        keys = _route_keys(n, msgs, rng)
        items = [(k, None) for k in keys]

        t0 = time.perf_counter()
        oracle = [m.route(k) for k in keys]
        trie_s = time.perf_counter() - t0

        uniq_items = [(k, None) for k in dict.fromkeys(keys)]

        backends = {}
        mismatches = 0
        for backend in ("torch", "python"):
            route_batch(compiled, items[:batch], backend,
                        device=device)  # warm (upload, kernel build)
            compiled._route_memo.clear()
            # cold: every key unseen, the all-miss tokenize+kernel path
            t0 = time.perf_counter()
            for i in range(0, len(uniq_items), batch):
                route_batch(compiled, uniq_items[i:i + batch], backend,
                            device=device)
            cold_s = time.perf_counter() - t0
            # steady state: bounded active keyset, memo-hit path
            t0 = time.perf_counter()
            got: list = []
            for i in range(0, len(items), batch):
                got.extend(route_batch(compiled, items[i:i + batch],
                                       backend, device=device))
            backends[backend] = (cold_s, time.perf_counter() - t0)
            mismatches += sum(
                1 for g, o in zip(got, oracle) if set(g) != o)

        torch_cold, torch_warm = backends["torch"]
        out["sizes"][str(n)] = {
            "bindings": n,
            "kernel_rows": compiled.kernel_rows,
            "unique_keys": len(uniq_items),
            "compile_ms": round(compile_s * 1e3, 2),
            "trie_us_per_msg": round(trie_s / msgs * 1e6, 3),
            "batched_torch_us_per_msg": round(
                torch_warm / msgs * 1e6, 3),
            "batched_torch_cold_us_per_key": round(
                torch_cold / len(uniq_items) * 1e6, 3),
            "batched_numpy_us_per_msg": round(
                backends["python"][1] / msgs * 1e6, 3),
            "speedup_vs_trie": round(trie_s / torch_warm, 2),
            "parity_mismatches": mismatches,
        }

    if not quick:
        m = _route_build_matcher(1_000_000)
        t0 = time.perf_counter()
        compiled = compile_exchange("topic", m.bindings())
        out["build_1m_bindings_s"] = round(time.perf_counter() - t0, 3)
        out["build_1m_kernel_rows"] = compiled.kernel_rows

    groups = 20 if quick else 100
    records = 100 if quick else 200
    try:
        out["key_shared_fanout"] = asyncio.run(asyncio.wait_for(
            _route_groups_spec(groups, records), timeout=120))
    except Exception as exc:
        out["key_shared_fanout"] = {
            "error": f"{type(exc).__name__}: {exc}"}
    return out


async def _route_groups_spec(groups: int, records: int) -> dict:
    """N key-shared groups fanning one stream out: every group delivers
    every record (group count × record count total deliveries), manual
    ack, 16 partition keys."""
    from chanamq_tpu_torch.broker.broker import Broker
    from chanamq_tpu_torch.broker.server import BrokerServer
    from chanamq_tpu_torch.client.client import AMQPClient

    srv = BrokerServer(broker=Broker(router_device=router_device()),
                       host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    conn = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    try:
        setup = await conn.channel()
        await setup.queue_declare(
            "route_ks", durable=True, arguments={"x-queue-type": "stream"})
        await setup.exchange_declare("route_ksx", "fanout")
        await setup.queue_bind("route_ks", "route_ksx", "")

        channels = [await conn.channel() for _ in range(4)]
        total = groups * records
        seen = [0]
        done = asyncio.get_event_loop().create_future()

        def on_msg(ch):
            def cb(msg):
                ch.basic_ack(msg.delivery_tag)
                seen[0] += 1
                if seen[0] >= total and not done.done():
                    done.set_result(None)
            return cb

        for g in range(groups):
            ch = channels[g % len(channels)]
            await ch.basic_consume(
                "route_ks", on_msg(ch), consumer_tag=f"ks-bench-{g}",
                arguments={"x-group": f"g{g}",
                           "x-group-type": "key-shared",
                           "x-stream-offset": "first"})

        t0 = time.perf_counter()
        for i in range(records):
            setup.basic_publish(b"x" * 32, exchange="route_ksx",
                                routing_key=f"k{i % 16}")
        await asyncio.wait_for(done, 90)
        wall = time.perf_counter() - t0
        await asyncio.sleep(0.2)  # let trailing acks commit cursors
        return {
            "groups": groups,
            "records": records,
            "deliveries": total,
            "wall_s": round(wall, 3),
            "deliveries_per_s": round(total / wall, 1),
            "group_cursors_committed": len([
                k for k in srv.broker.vhosts["/"].queues["route_ks"]
                .committed if k.startswith("%grp%")]),
        }
    finally:
        try:
            await conn.close()
        except Exception:
            pass
        await srv.stop()


# ---------------------------------------------------------------------------
# --rpc: request-reply workload (exclusive reply queues, correlation ids)
# ---------------------------------------------------------------------------

async def _rpc_spec(clients: int = 4, servers: int = 2,
                    paced_rate: int = 80) -> dict:
    """Request-reply RPC: N clients each own an exclusive server-named
    reply queue and publish correlated requests to a shared request
    queue; M servers consume it and answer to ``reply_to`` with the
    request's ``correlation_id``. Phase 1 is closed-loop (each client
    pipelines nothing: one request in flight) for round-trips/s; phase 2
    paces each client at a fixed request rate and reports the round-trip
    p50/p99 — the small-message regime the RPCAcc workload targets."""
    from chanamq_tpu_torch.amqp.properties import BasicProperties
    from chanamq_tpu_torch.broker.broker import Broker
    from chanamq_tpu_torch.broker.server import BrokerServer
    from chanamq_tpu_torch.client import AMQPClient
    from chanamq_tpu_torch.store.memory import MemoryStore

    closed_s = max(2.0, min(BENCH_SECONDS, 6.0))
    paced_s = max(2.0, min(BENCH_SECONDS, 4.0))
    srv = BrokerServer(
        broker=Broker(store=MemoryStore(), router_device=router_device()),
        host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    conns: list = []
    served = 0
    try:
        boot = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        conns.append(boot)
        bch = await boot.channel()
        await bch.queue_declare("rpc_q")

        for _ in range(servers):
            conn = await AMQPClient.connect("127.0.0.1", srv.bound_port)
            conns.append(conn)
            ch = await conn.channel()
            await ch.basic_qos(prefetch_count=64)

            def on_req(msg, ch=ch):
                nonlocal served
                served += 1
                ch.basic_publish(
                    msg.body, routing_key=msg.properties.reply_to,
                    properties=BasicProperties(
                        correlation_id=msg.properties.correlation_id))
                ch.basic_ack(msg.delivery_tag)

            await ch.basic_consume("rpc_q", on_req)

        class RpcClient:
            def __init__(self):
                self.waiting: dict = {}
                self.seq = 0

            async def open(self, idx: int):
                self.idx = idx
                self.conn = await AMQPClient.connect(
                    "127.0.0.1", srv.bound_port)
                conns.append(self.conn)
                self.ch = await self.conn.channel()
                ok = await self.ch.queue_declare("", exclusive=True)
                self.reply_q = ok.queue

                def on_reply(msg):
                    fut = self.waiting.pop(
                        msg.properties.correlation_id, None)
                    if fut is not None and not fut.done():
                        fut.set_result(None)

                await self.ch.basic_consume(self.reply_q, on_reply,
                                            no_ack=True)

            async def call(self, body: bytes, timeout: float = 10.0):
                self.seq += 1
                cid = f"c{self.idx}-{self.seq}"
                fut = asyncio.get_event_loop().create_future()
                self.waiting[cid] = fut
                self.ch.basic_publish(
                    body, routing_key="rpc_q",
                    properties=BasicProperties(
                        reply_to=self.reply_q, correlation_id=cid))
                await asyncio.wait_for(fut, timeout)

        rpc_clients = []
        for i in range(clients):
            c = RpcClient()
            await c.open(i)
            rpc_clients.append(c)
        body = b"r" * 64

        # phase 1: closed loop
        async def closed_loop(c) -> int:
            n = 0
            loop = asyncio.get_event_loop()
            end = loop.time() + closed_s
            while loop.time() < end:
                await c.call(body)
                n += 1
            return n

        # clients, servers and broker share this process: the CPU ledger
        # sampled around the closed-loop window is the whole round-trip
        # cost (publish + route + 2x deliver + ack), not broker-only
        cpu0 = _proc_cpu_s(os.getpid())
        t0 = time.perf_counter()
        counts = await asyncio.gather(
            *(closed_loop(c) for c in rpc_clients))
        closed_wall = time.perf_counter() - t0
        cpu1 = _proc_cpu_s(os.getpid())
        round_trips = sum(counts)
        cpu_us_per_msg = (
            round((cpu1 - cpu0) * 1e6 / round_trips, 3)
            if cpu0 is not None and cpu1 is not None and round_trips
            else None)

        # phase 2: paced, round-trip latency under a fixed offered rate
        async def paced_loop(c) -> list:
            lats = []
            loop = asyncio.get_event_loop()
            interval = 1.0 / paced_rate
            end = loop.time() + paced_s
            nxt = loop.time()
            while loop.time() < end:
                nxt += interval
                t = time.perf_counter()
                await c.call(body)
                lats.append((time.perf_counter() - t) * 1e6)
                delay = nxt - loop.time()
                if delay > 0:
                    await asyncio.sleep(delay)
            return lats

        lat_lists = await asyncio.gather(
            *(paced_loop(c) for c in rpc_clients))
        lats = sorted(x for lst in lat_lists for x in lst)

        def pct(p: float):
            return (round(lats[min(len(lats) - 1,
                                   int(len(lats) * p))], 1)
                    if lats else None)

        return {
            "clients": clients,
            "servers": servers,
            "round_trips": round_trips,
            "round_trips_per_s": round(round_trips / closed_wall, 1),
            "cpu_us_per_msg": cpu_us_per_msg,
            "served": served,
            "paced_rate_per_client": paced_rate,
            "paced_samples": len(lats),
            "paced_p50_us": pct(0.50),
            "paced_p99_us": pct(0.99),
        }
    finally:
        for conn in conns:
            try:
                await conn.close()
            except Exception:
                pass
        await srv.stop()


def run_rpc_spec() -> dict:
    try:
        return asyncio.run(asyncio.wait_for(_rpc_spec(), timeout=120))
    except Exception as exc:
        return {"error": f"{type(exc).__name__}: {exc}"}


# ---------------------------------------------------------------------------
# --dlx: dead-letter + priority-queue scenario
# ---------------------------------------------------------------------------

async def _dlx_spec() -> dict:
    """Delivery-semantics scenario: a burst into an x-max-priority queue
    drained in strict priority order (the PriorityFan dispatch path at
    bench scale), then a reject-everything pass through a dead-letter
    exchange asserting exactly-once dead-lettering with x-death headers.
    Reports burst drain throughput and the DLX round-trip rate."""
    import random

    from chanamq_tpu_torch.amqp.properties import BasicProperties
    from chanamq_tpu_torch.broker.broker import Broker
    from chanamq_tpu_torch.broker.server import BrokerServer
    from chanamq_tpu_torch.client import AMQPClient
    from chanamq_tpu_torch.store.memory import MemoryStore

    burst = int(3000 * max(1.0, min(BENCH_SECONDS / 5.0, 4.0)))
    dlx_msgs = 500
    rng = random.Random(17)
    srv = BrokerServer(
        broker=Broker(store=MemoryStore(), router_device=router_device()),
        host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    conn = None
    violations: list = []
    try:
        conn = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await conn.channel()
        await ch.exchange_declare("bench_dlx", "fanout")
        await ch.queue_declare("bench_dlq")
        await ch.queue_bind("bench_dlq", "bench_dlx", "")
        await ch.queue_declare("bench_prio", arguments={
            "x-max-priority": 9,
            "x-dead-letter-exchange": "bench_dlx"})

        # phase 1: burst at shuffled priorities, drain in priority order
        # (producer, broker and consumer share this process: the CPU
        # window is the full publish->prio-dispatch->deliver cost)
        cpu0 = _proc_cpu_s(os.getpid())
        t0 = time.perf_counter()
        for i in range(burst):
            ch.basic_publish(
                b"p" * 64, routing_key="bench_prio",
                properties=BasicProperties(priority=rng.randrange(12)))
        drained = 0
        done = asyncio.get_event_loop().create_future()
        last_prio = [9]

        def on_prio(msg):
            nonlocal drained
            drained += 1
            prio = min(msg.properties.priority or 0, 9)
            if prio > last_prio[0]:
                violations.append(
                    f"priority inversion at {drained}: {prio} after "
                    f"{last_prio[0]}")
            last_prio[0] = prio
            if drained >= burst and not done.done():
                done.set_result(None)

        tag = await ch.basic_consume("bench_prio", on_prio, no_ack=True)
        await asyncio.wait_for(done, timeout=60)
        await ch.basic_cancel(tag)
        burst_wall = time.perf_counter() - t0
        cpu1 = _proc_cpu_s(os.getpid())
        cpu_us_per_msg = (
            round((cpu1 - cpu0) * 1e6 / burst, 3)
            if cpu0 is not None and cpu1 is not None and burst else None)

        # phase 2: reject everything once -> exactly-once dead-lettering
        t1 = time.perf_counter()
        for i in range(dlx_msgs):
            ch.basic_publish(b"d%d" % i, routing_key="bench_prio")
        rejected = 0
        rejected_done = asyncio.get_event_loop().create_future()

        def on_reject(msg):
            nonlocal rejected
            rejected += 1
            ch.basic_reject(msg.delivery_tag, requeue=False)
            if rejected >= dlx_msgs and not rejected_done.done():
                rejected_done.set_result(None)

        tag = await ch.basic_consume("bench_prio", on_reject)
        await asyncio.wait_for(rejected_done, timeout=60)
        await ch.basic_cancel(tag)
        seen: dict = {}
        deadline = asyncio.get_event_loop().time() + 10.0
        while (len(seen) < dlx_msgs
               and asyncio.get_event_loop().time() < deadline):
            msg = await ch.basic_get("bench_dlq", no_ack=True)
            if msg is None:
                await asyncio.sleep(0.02)
                continue
            body = bytes(msg.body).decode()
            seen[body] = seen.get(body, 0) + 1
            deaths = (msg.properties.headers or {}).get("x-death") or []
            if (len(deaths) != 1 or deaths[0].get("count") != 1
                    or deaths[0].get("reason") != "rejected"):
                violations.append(f"{body}: bad x-death {deaths}")
        dlx_wall = time.perf_counter() - t1
        if len(seen) != dlx_msgs:
            violations.append(
                f"dead-lettered {len(seen)}/{dlx_msgs} bodies")
        if any(n != 1 for n in seen.values()):
            violations.append("duplicate dead-letters")
        return {
            "burst": burst,
            "burst_drain_per_s": round(burst / burst_wall, 1),
            "cpu_us_per_msg": cpu_us_per_msg,
            "dlx_msgs": dlx_msgs,
            "dlx_round_trip_per_s": round(dlx_msgs / dlx_wall, 1),
            "violations": violations,
        }
    finally:
        if conn is not None:
            try:
                await conn.close()
            except Exception:
                pass
        await srv.stop()


def run_dlx_spec() -> dict:
    try:
        return asyncio.run(asyncio.wait_for(_dlx_spec(), timeout=180))
    except Exception as exc:
        return {"error": f"{type(exc).__name__}: {exc}"}


def run_overhead(metric: str, variants: "list[tuple]",
                 budget_pct: "float | None" = None,
                 value_label: "str | None" = None,
                 extra_out: "dict | None" = None) -> None:
    """Shared off-vs-on overhead harness for every observability subsystem
    (--trace-overhead / --telemetry-overhead / --control-overhead /
    --profile-overhead used to carry four copies of this logic).

    `variants` is [(label, extra_env-or-None), ...]; the first is the
    baseline. Reports each variant's throughput delta vs the baseline;
    when `budget_pct` is set (e.g. -2.0), any variant losing more than
    that fails the smoke (exit 1) — a caller may retry the whole comparison
    because two independent 5 s runs carry +/-10% noise on a shared box.
    Prints the one-line JSON and exits non-zero on error/over-budget."""
    runs: dict = {}
    for label, extra in variants:
        runs[label] = run_spec("transient_autoack_3p3c", extra_env=extra)
        print(f"# {metric} {label}: {runs[label]}", file=sys.stderr)
    base_label = variants[0][0]
    base = runs[base_label].get("delivered_per_s") or 0
    deltas = {}
    for label, _ in variants[1:]:
        cur = runs[label].get("delivered_per_s")
        deltas[label] = (round((cur - base) / base * 100, 2)
                         if base and cur is not None else None)
    errors = {k: v["error"] for k, v in runs.items() if "error" in v}
    over_budget = budget_pct is not None and any(
        d is not None and d < budget_pct for d in deltas.values())
    value = deltas.get(value_label or variants[1][0])
    print(json.dumps({
        "metric": metric,
        "value": value,
        "unit": "%",
        "vs_baseline": None,
        "delta_pct": deltas,
        "delivered_per_s": {
            k: v.get("delivered_per_s") for k, v in runs.items()},
        "cpu_us_per_msg": {
            k: v.get("cpu_us_per_msg") for k, v in runs.items()},
        "body_bytes": BODY_BYTES,
        **({"budget_pct": budget_pct, "within_budget": not over_budget}
           if budget_pct is not None else {}),
        **(extra_out or {}),
        **({"error": errors} if errors else {}),
    }))
    if errors or over_budget:
        sys.exit(1)  # over-budget throughput loss fails the smoke


def run_profile_smoke() -> dict:
    """Attribution smoke: the headline workload against a broker booted
    with the cost ledger + stack sampler on, scraping /admin/profile just
    before and just after the load window. The stage/CPU deltas between
    the two scrapes exclude boot and idle time, so the gate can demand
    that the ledger's non-overlapping top-level windows account for >=90%
    of the broker's measured process CPU, that at least 5 distinct stages
    saw traffic, and that the collapsed-stack endpoint is non-empty."""
    port = free_port()
    admin_port = free_port()
    env = {**os.environ,
           "PYTHONPATH": REPO_DIR,
           "CHANAMQ_PROFILE_ENABLED": "true",
           "CHANAMQ_PROFILE_SAMPLE_HZ": "67",
           "CHANAMQ_PROFILE_SLOW_CALLBACK_MS": "250"}
    broker_log = tempfile.NamedTemporaryFile(
        suffix=".log", prefix="bench-profile-", delete=False)
    broker = subprocess.Popen(
        [sys.executable, "-m", "chanamq_tpu_torch.broker.server",
         "--host", "127.0.0.1", "--port", str(port),
         "--admin-port", str(admin_port), "--log-level", "WARNING"],
        env=env, stdout=broker_log, stderr=broker_log)
    children: list = []
    try:
        wait_port(port)
        wait_port(admin_port)
        asyncio.run(setup_topology(port, False))
        snap0 = asyncio.run(_admin_get(admin_port, "/admin/profile"))
        for _ in range(2):
            children.append(subprocess.Popen(
                [sys.executable, "-m", "chanamq_tpu_torch.bench", "--role", "consumer",
                 "--port", str(port), "--auto-ack", "1",
                 "--seconds", str(BENCH_SECONDS)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        time.sleep(0.3)
        for _ in range(2):
            children.append(subprocess.Popen(
                [sys.executable, "-m", "chanamq_tpu_torch.bench", "--role", "producer",
                 "--port", str(port), "--seconds", str(BENCH_SECONDS)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        outputs, errors = _reap_children(children, 2, BENCH_SECONDS + 60)
        snap1 = asyncio.run(_admin_get(admin_port, "/admin/profile"))
        stacks = asyncio.run(_admin_text(
            admin_port, "/admin/profile/stacks"))
    except Exception as exc:  # noqa: BLE001 — a red smoke must stay parseable
        for child in children:
            if child.poll() is None:
                child.kill()
            child.communicate()
        return {"error": f"{type(exc).__name__}: {exc}",
                "broker_stderr_tail": _tail(broker_log.name)[-800:]}
    finally:
        broker.terminate()
        try:
            broker.wait(timeout=10)
        except subprocess.TimeoutExpired:
            broker.kill()
            broker.wait()
        broker_log.close()
        try:
            os.unlink(broker_log.name)
        except OSError:
            pass
    if errors:
        return {"error": "; ".join(errors)}
    delivered = sum(o.get("delivered", 0) for o in outputs)
    stages = {}
    for name, s1 in snap1["stages"].items():
        s0 = snap0["stages"][name]
        d_ns = s1["ns"] - s0["ns"]
        d_calls = s1["calls"] - s0["calls"]
        stages[name] = {
            "ns": d_ns, "calls": d_calls,
            "us_per_call": (round(d_ns / d_calls / 1000.0, 3)
                            if d_calls else None),
        }
    busy_ns = snap1["busy_ns"] - snap0["busy_ns"]
    # the honest denominator is the event-loop thread's CPU (steal-proof,
    # excludes the sampler thread); older payloads only carry process CPU
    loop_cpu_ns = (snap1["loop_cpu_ns"] - snap0["loop_cpu_ns"]
                   if "loop_cpu_ns" in snap1
                   else snap1["process_cpu_ns"] - snap0["process_cpu_ns"])
    active = sorted(n for n, s in stages.items() if s["calls"] > 0)
    stack_lines = [ln for ln in stacks.splitlines() if ln.strip()]
    return {
        "delivered": delivered,
        "delivered_per_s": round(delivered / BENCH_SECONDS, 1),
        "stages": stages,
        "stages_active": active,
        "busy_ns": busy_ns,
        "loop_cpu_ns": loop_cpu_ns,
        "process_cpu_ns": (snap1["process_cpu_ns"]
                           - snap0["process_cpu_ns"]),
        "attributed_pct": (round(busy_ns / loop_cpu_ns * 100, 1)
                           if loop_cpu_ns > 0 else None),
        "gc_pauses": snap1["gc"]["pauses"] - snap0["gc"]["pauses"],
        "samples": (snap1["sampler"]["samples"]
                    - snap0["sampler"]["samples"]),
        "distinct_stacks": snap1["sampler"]["distinct_stacks"],
        "stack_lines": len(stack_lines),
        "slow_callbacks": snap1["slow_callbacks"]["count"],
    }


def main() -> None:
    if "--role" in sys.argv:
        import argparse

        parser = argparse.ArgumentParser()
        parser.add_argument("--role", required=True)
        parser.add_argument("--port", type=int, required=True)
        parser.add_argument("--auto-ack", type=int, default=1)
        parser.add_argument("--persistent", type=int, default=0)
        parser.add_argument("--seconds", type=float, default=5)
        parser.add_argument("--rate", type=int, default=0)
        parser.add_argument("--queue", default="bench_q")
        parser.add_argument("--keys", default="")
        parser.add_argument("--shape", default="burst",
                            choices=("burst", "smooth"))
        args = parser.parse_args()
        if args.role == "producer":
            keys = [k for k in args.keys.split(",") if k] or None
            asyncio.run(producer_main(
                args.port, bool(args.persistent), args.seconds, args.rate,
                keys, args.shape))
        else:
            asyncio.run(consumer_main(
                args.port, bool(args.auto_ack), args.seconds, args.queue))
        return

    if "--route" in sys.argv:
        # tensorized-router microbench: compiled batch routing vs the
        # per-message trie, plus the key-shared group fan-out. --quick
        # shrinks sizes for the tier-1 smoke gate.
        quick = "--quick" in sys.argv
        result = run_route_spec(quick=quick)
        print(f"# route: {result}", file=sys.stderr)
        headline = result["sizes"].get("10000") or next(
            iter(result["sizes"].values()), {})
        parity_bad = sum(s.get("parity_mismatches", 0)
                         for s in result["sizes"].values())
        fanout_err = result.get("key_shared_fanout", {}).get("error")
        print(json.dumps({
            "metric": "route_batched_us_per_msg_10k_bindings",
            "value": headline.get("batched_torch_us_per_msg"),
            "unit": "us/msg",
            "vs_baseline": None,
            "trie_us_per_msg": headline.get("trie_us_per_msg"),
            "speedup_vs_trie": headline.get("speedup_vs_trie"),
            "parity_mismatches": parity_bad,
            "cores": os.cpu_count(),
            "route": result,
        }))
        if parity_bad or fanout_err:
            sys.exit(1)  # the tier-1 smoke must fail loudly
        return

    if "--stream" in sys.argv:
        # stream-queue scenario only: 1 producer, 3 cursors (first / next /
        # timestamp), manual ack — publish throughput + per-cursor lag
        result = run_stream_spec()
        print(f"# stream_1p3c: {result}", file=sys.stderr)
        print(json.dumps({
            "metric": "stream_published_msgs_per_s_1p3cursors",
            "value": result.get("published_per_s"),
            "unit": "msgs/s",
            "vs_baseline": None,
            "delivered_per_s_total": result.get("delivered_per_s_total"),
            "cursor_lag": result.get("cursor_lag"),
            "body_bytes": BODY_BYTES,
            "stream_1p3c": result,
            **({"error": {"stream_1p3c": result["error"]}}
               if "error" in result else {}),
        }))
        return

    if "--rpc" in sys.argv:
        # request-reply workload: 4 clients x 2 servers over exclusive
        # reply queues with correlation-id matching — closed-loop
        # round-trips/s plus a paced round-trip p99
        result = run_rpc_spec()
        print(f"# rpc_4c2s: {result}", file=sys.stderr)
        record = None
        if "error" not in result:
            record = trajectory_record("rpc_4c2s", {
                "delivered_per_s": result.get("round_trips_per_s"),
                "cpu_us_per_msg": result.get("cpu_us_per_msg"),
                "p50_us": result.get("paced_p50_us"),
                "p99_us": result.get("paced_p99_us"),
            })
        if record is not None:
            trajectory_append(record)
        print(json.dumps({
            "metric": "rpc_round_trips_per_s_4c2s",
            "value": result.get("round_trips_per_s"),
            "unit": "round-trips/s",
            "vs_baseline": None,
            "paced_p50_us": result.get("paced_p50_us"),
            "paced_p99_us": result.get("paced_p99_us"),
            "rpc_4c2s": result,
            **({"error": {"rpc_4c2s": result["error"]}}
               if "error" in result else {}),
        }))
        if "error" in result:
            sys.exit(1)
        return

    if "--dlx" in sys.argv:
        # delivery-semantics scenario: priority-fan burst drain in strict
        # priority order, then reject-driven dead-lettering with
        # exactly-once x-death assertions
        result = run_dlx_spec()
        print(f"# dlx_priority: {result}", file=sys.stderr)
        record = None
        if not result.get("error") and not result.get("violations"):
            record = trajectory_record("dlx_priority", {
                "delivered_per_s": result.get("burst_drain_per_s"),
                "cpu_us_per_msg": result.get("cpu_us_per_msg"),
            })
        if record is not None:
            trajectory_append(record)
        print(json.dumps({
            "metric": "dlx_priority_burst_drain_per_s",
            "value": result.get("burst_drain_per_s"),
            "unit": "msgs/s",
            "vs_baseline": None,
            "dlx_round_trip_per_s": result.get("dlx_round_trip_per_s"),
            "violations": result.get("violations"),
            "dlx_priority": result,
            **({"error": {"dlx_priority": result["error"]}}
               if "error" in result else {}),
        }))
        if result.get("error") or result.get("violations"):
            sys.exit(1)  # the tier-1 smoke must fail loudly
        return

    if "--semantics-soak" in sys.argv:
        # delivery-semantics chaos soak: seeded kill -9 between Tx.Commit
        # receipt and the WAL group commit (all-or-nothing recovery, no
        # post-rollback ghosts) + TTL-expiry dead-lettering under seeded
        # store faults (exactly-once); both run twice and must be
        # byte-identical per seed
        seed = 42
        if "--seed" in sys.argv:
            seed = int(sys.argv[sys.argv.index("--seed") + 1])
        from chanamq_tpu_torch.chaos.soak import run_semantics_soak

        try:
            result = asyncio.run(asyncio.wait_for(
                run_semantics_soak(seed, device=router_device()), timeout=240))
        except Exception as exc:
            result = {"seed": seed,
                      "violations": [f"{type(exc).__name__}: {exc}"]}
        print(f"# semantics_soak: {result}", file=sys.stderr)
        print(json.dumps({
            "metric": "semantics_soak_violations",
            "value": len(result.get("violations", [])),
            "unit": "violations",
            "vs_baseline": None,
            "seed": seed,
            "deterministic": result.get("deterministic"),
            "semantics_soak": {k: v for k, v in result.items()},
        }))
        if result.get("violations"):
            sys.exit(1)  # the tier-1 smoke must fail loudly
        return

    if "--semantics-overhead" in sys.argv:
        # master-switch cost: the standard transient scenario with the
        # semantics subsystem disabled (no delay service, no cycle guard,
        # plain deque ready lists) vs the default-on broker; the on-path
        # may cost at most 2%
        run_overhead(
            "semantics_overhead_pct",
            [("off", {"CHANAMQ_SEMANTICS_ENABLED": "false"}), ("on", None)],
            budget_pct=-2.0)
        return

    if "--federation" in sys.argv:
        # two-cluster federation soak: stream segments ship to a mirror
        # cluster, the link is severed mid-stream, the consumer group
        # fails over to the mirror and resumes from its mirrored cursor,
        # the link heals and the backlog drains — zero confirmed loss,
        # contiguous resume, no post-settle duplicates, and a
        # byte-identical same-seed link transition log
        seed = 42
        if "--seed" in sys.argv:
            seed = int(sys.argv[sys.argv.index("--seed") + 1])
        from chanamq_tpu_torch.chaos.soak import run_federation_soak

        t0 = time.perf_counter()
        try:
            result = asyncio.run(asyncio.wait_for(
                run_federation_soak(seed, device=router_device()), timeout=240))
        except Exception as exc:
            result = {"seed": seed,
                      "violations": [f"{type(exc).__name__}: {exc}"]}
        elapsed = time.perf_counter() - t0
        print(f"# federation_soak: {result}", file=sys.stderr)
        run = result.get("run") or {}
        # both same-seed runs ship the full stream twice over the link
        shipped = 2 * (run.get("records") or 0)
        print(json.dumps({
            "metric": "federation_soak_violations",
            "value": len(result.get("violations", [])),
            "unit": "violations",
            "vs_baseline": None,
            "seed": seed,
            "deterministic": result.get("deterministic"),
            "mirrored_records_per_s": (
                round(shipped / elapsed, 1) if elapsed > 0 else None),
            "federation_soak": {k: v for k, v in result.items()},
        }))
        if result.get("violations"):
            sys.exit(1)  # the tier-1 smoke must fail loudly
        return

    if "--federation-overhead" in sys.argv:
        # master-switch cost: federation enabled (listener up, zero links)
        # vs the default-off broker on the standard transient scenario;
        # an idle federation endpoint may cost at most 2%
        run_overhead(
            "federation_overhead_pct",
            [("off", None),
             ("on", {"CHANAMQ_FEDERATION_ENABLED": "true"})],
            budget_pct=-2.0)
        return

    if "--shard" in sys.argv:
        # sharded-node scenario: the saturated transient/autoack workload
        # against a multi-process node at 1/2/4(/N) shards — per-shard and
        # aggregate throughput, the cross-shard UDS push ratio, and a
        # paced p99 at the target count; speedup is always vs the 1-shard
        # run of the same workload
        idx = sys.argv.index("--shard")
        try:
            target = int(sys.argv[idx + 1])
        except (IndexError, ValueError):
            target = 2
        target = max(1, target)
        counts = sorted({1, target} | {c for c in (2, 4) if c < target})
        runs: dict = {}
        for c in counts:
            runs[str(c)] = run_shard_spec(c)
            print(f"# shard_{c}: {runs[str(c)]}", file=sys.stderr)
        base = runs["1"].get("delivered_per_s") or 0
        speedups = {}
        for c in counts[1:]:
            cur = runs[str(c)].get("delivered_per_s")
            speedups[str(c)] = (round(cur / base, 2)
                                if base and cur is not None else None)
        errors = {k: v["error"] for k, v in runs.items() if "error" in v}
        head = runs[str(target)]
        print(json.dumps({
            "metric": f"shard_delivered_msgs_per_s_{target}shards",
            "value": head.get("delivered_per_s"),
            "unit": "msgs/s",
            "vs_baseline": None,
            "speedup_vs_1shard": speedups,
            "cross_shard_push_ratio": head.get("cross_shard_push_ratio"),
            "paced_p99_us": head.get("paced_p99_us"),
            "per_shard": head.get("per_shard"),
            "cores": os.cpu_count(),
            "body_bytes": BODY_BYTES,
            "seconds": BENCH_SECONDS,
            "shard_runs": runs,
            **({"error": errors} if errors else {}),
        }))
        if errors:
            sys.exit(1)  # the tier-1 smoke must fail loudly
        return

    if "--wal-recovery" in sys.argv:
        # kill-9 durability smoke: any confirmed-message loss exits 1
        result = run_wal_recovery_smoke()
        print(f"# wal_recovery: {result}", file=sys.stderr)
        print(json.dumps({
            "metric": "wal_recovery_lost_confirmed",
            "value": result["lost_confirmed"],
            "unit": "messages",
            "vs_baseline": None,
            "wal_recovery": result,
        }))
        if result["lost_confirmed"] or result["confirmed"] == 0:
            sys.exit(1)
        return

    if "--wal" in sys.argv:
        # the WAL delta, measured three ways per ack mode: persistent with
        # the WAL group commit (default), persistent store-direct
        # (CHANAMQ_WAL_ENABLED=false — the pre-WAL baseline), and the
        # matching transient spec the acceptance ratio is taken against;
        # plus the paced persistent p99 with and without the WAL
        direct = {"CHANAMQ_WAL_ENABLED": "false"}
        pairs = {
            "persistent_autoack_3p1c": "transient_autoack_3p1c",
            "persistent_ack_3p1c": "transient_ack_3p1c",
        }
        runs: dict = {}
        ratios: dict = {}
        for name, twin in pairs.items():
            runs[name] = run_spec(name)
            print(f"# {name}: {runs[name]}", file=sys.stderr)
            runs[name + "_store_direct"] = run_spec(name, extra_env=direct)
            print(f"# {name}_store_direct: "
                  f"{runs[name + '_store_direct']}", file=sys.stderr)
            runs[twin] = run_spec(twin)
            print(f"# {twin}: {runs[twin]}", file=sys.stderr)
            got = runs[name].get("delivered_per_s")
            base = runs[twin].get("delivered_per_s")
            ratios[name] = (round(got / base, 3)
                            if got and base else None)
        rate_base = runs["persistent_autoack_3p1c"].get("published_per_s")
        if rate_base:
            rate = max(1000, int(rate_base * 0.25))
            runs[PACED_PERSISTENT_SPEC] = run_spec(
                PACED_PERSISTENT_SPEC, rate=rate)
            runs[PACED_PERSISTENT_SPEC]["rate"] = rate
            runs[PACED_PERSISTENT_SPEC + "_store_direct"] = run_spec(
                PACED_PERSISTENT_SPEC, rate=rate, extra_env=direct)
            runs[PACED_PERSISTENT_SPEC + "_store_direct"]["rate"] = rate
            for label in (PACED_PERSISTENT_SPEC,
                          PACED_PERSISTENT_SPEC + "_store_direct"):
                print(f"# {label}: {runs[label]}", file=sys.stderr)
        errors = {n: r["error"] for n, r in runs.items() if "error" in r}
        print(json.dumps({
            "metric": "wal_persistent_vs_transient_ratio",
            "value": ratios.get("persistent_ack_3p1c"),
            "unit": "ratio",
            "vs_baseline": None,
            "ratios": ratios,
            "paced_persistent_p99_us":
                runs.get(PACED_PERSISTENT_SPEC, {}).get("p99_us"),
            "paced_persistent_p99_us_store_direct":
                runs.get(PACED_PERSISTENT_SPEC + "_store_direct",
                         {}).get("p99_us"),
            "body_bytes": BODY_BYTES,
            "seconds": BENCH_SECONDS,
            "specs": runs,
            **({"error": errors} if errors else {}),
        }))
        if errors:
            sys.exit(1)
        return

    if "--chaos" in sys.argv:
        # seeded chaos soak: the 3-node RF=2 workload of
        # chanamq_tpu_torch/chaos/soak.py under the default fault plan
        # (partition + owner crash + slow store), with every node's store
        # WAL-fronted (CHAOS_WAL=0 reverts to MemoryStore) so confirms
        # gate on the real group-fsync engine. Same seed -> same plan
        # fingerprint and fault schedule; any invariant violation exits
        # non-zero so tier-1 gates on it.
        seed = 42
        if "--seed" in sys.argv:
            seed = int(sys.argv[sys.argv.index("--seed") + 1])
        messages = int(os.environ.get("CHAOS_MESSAGES", "160"))
        wal = os.environ.get("CHAOS_WAL", "1") != "0"
        from chanamq_tpu_torch.chaos.soak import run_soak

        try:
            result = asyncio.run(asyncio.wait_for(
                run_soak(seed, messages=messages, wal=wal,
                         device=router_device()), timeout=150))
        except Exception as exc:
            result = {"seed": seed,
                      "violations": [f"{type(exc).__name__}: {exc}"]}
        print(f"# chaos_soak: {result}", file=sys.stderr)
        print(json.dumps({
            "metric": "chaos_soak_violations",
            "value": len(result.get("violations", [])),
            "unit": "violations",
            "vs_baseline": None,
            "seed": seed,
            "fingerprint": result.get("fingerprint"),
            "confirmed": result.get("confirmed"),
            "duplicates": result.get("duplicates"),
            "promotions": result.get("promotions"),
            "chaos_soak": {k: v for k, v in result.items() if k != "chaos"},
        }))
        if result.get("violations"):
            sys.exit(1)  # the tier-1 smoke must fail loudly
        return

    if "--elastic" in sys.argv:
        # elasticity chaos soak: 3-node cluster + joiner on private
        # per-node stores (chanamq_tpu_torch/chaos/soak.py run_elastic_soak) —
        # join-triggered rebalance, graceful drain/decommission, kill -9
        # mid-drain, and a healed partition fencing off a stale owner.
        # The episode runs TWICE with the same seed and the normalized
        # decision/evacuation logs must be byte-identical; any invariant
        # violation (confirmed loss, dual holders, unfenced stale ship,
        # non-contiguous stream resume) exits non-zero.
        seed = 11
        if "--seed" in sys.argv:
            seed = int(sys.argv[sys.argv.index("--seed") + 1])
        from chanamq_tpu_torch.chaos.soak import run_elastic_soak

        try:
            result = asyncio.run(asyncio.wait_for(
                run_elastic_soak(seed, device=router_device()), timeout=240))
        except Exception as exc:
            result = {"seed": seed,
                      "violations": [f"{type(exc).__name__}: {exc}"]}
        runs = [{k: v for k, v in run.items() if k != "log_bytes"}
                for run in result.get("runs", [])]
        print(f"# elastic_soak: violations={result.get('violations')} "
              f"log_sha256={result.get('log_sha256')}", file=sys.stderr)
        print(json.dumps({
            "metric": "elastic_soak_violations",
            "value": len(result.get("violations", [])),
            "unit": "violations",
            "vs_baseline": None,
            "seed": seed,
            "log_sha256": result.get("log_sha256"),
            "runs": runs,
            "violations": result.get("violations", []),
        }))
        if result.get("violations"):
            sys.exit(1)  # the tier-1 smoke must fail loudly
        return

    if "--overload" in sys.argv:
        # overload soak: a deterministic memory-pressure chaos rule drives
        # the flow ladder to the refuse stage under a saturating publisher
        # (chanamq_tpu_torch/chaos/soak.py run_overload_soak). Reports the peak
        # accounted bytes vs the hard limit, paged-body count and the
        # throttle episode latency; any invariant violation (peak over the
        # ceiling, confirmed loss, no refusals, no recovery) exits 1.
        seed = 7
        if "--seed" in sys.argv:
            seed = int(sys.argv[sys.argv.index("--seed") + 1])
        messages = int(os.environ.get("OVERLOAD_MESSAGES", "160"))
        from chanamq_tpu_torch.chaos.soak import run_overload_soak

        try:
            result = asyncio.run(asyncio.wait_for(
                run_overload_soak(seed, messages=messages,
                                  device=router_device()), timeout=120))
        except Exception as exc:
            result = {"seed": seed,
                      "violations": [f"{type(exc).__name__}: {exc}"]}
        print(f"# overload_soak: {result}", file=sys.stderr)
        print(json.dumps({
            "metric": "overload_peak_accounted_bytes",
            "value": result.get("peak_accounted_bytes"),
            "unit": "bytes",
            "vs_baseline": None,
            "seed": seed,
            "hard_limit": result.get("hard_limit"),
            "under_hard_limit": bool(result.get("under_hard_limit")),
            "paged_bodies": result.get("paged_bodies"),
            "publishes_refused": result.get("publishes_refused"),
            "throttle_latency_s": result.get("throttle_latency_s"),
            "overload_soak": {k: v for k, v in result.items()
                              if k != "chaos"},
        }))
        if result.get("violations") or not result.get("under_hard_limit"):
            sys.exit(1)  # the tier-1 smoke must fail loudly
        return

    if "--control-overhead" in sys.argv:
        # predictive-control cost: the headline transient/autoAck spec
        # with the telemetry stack on, vs the same plus the control plane
        # ticking at 100 ms (10x the default rate). The hot path never
        # sees the control plane — gather is one loop callback, the
        # evaluation runs on its own executor — so the claim is the same
        # <= 2% budget the telemetry sampler is held to.
        base_env = {"CHANAMQ_TELEMETRY_ENABLED": "true",
                    "CHANAMQ_TELEMETRY_INTERVAL": "100ms"}
        run_overhead("control_overhead_pct", [
            ("off", dict(base_env)),
            ("on", {**base_env,
                    "CHANAMQ_CONTROL_ENABLED": "true",
                    "CHANAMQ_CONTROL_INTERVAL": "100ms"}),
        ], budget_pct=-2.0)
        return

    if "--control" in sys.argv:
        # predictive-control spike soak: one seeded burst ramp replayed
        # uncontrolled, controlled (twice, same seed) and dry-run
        # (chanamq_tpu_torch/chaos/soak.py run_control_soak). The controlled
        # runs must peak strictly below the uncontrolled maximum stage
        # with strictly fewer refusals, the same-seed decision logs must
        # compare byte-identical, the dry run must mutate nothing, and
        # no run may lose a confirmed message; any violation exits 1.
        seed = 7
        if "--seed" in sys.argv:
            seed = int(sys.argv[sys.argv.index("--seed") + 1])
        from chanamq_tpu_torch.chaos.soak import run_control_soak

        try:
            result = asyncio.run(asyncio.wait_for(
                run_control_soak(seed, device=router_device()), timeout=180))
        except Exception as exc:
            result = {"seed": seed,
                      "violations": [f"{type(exc).__name__}: {exc}"]}
        print(f"# control_soak: {result}", file=sys.stderr)
        off = result.get("off") or {}
        on = result.get("on") or {}
        print(json.dumps({
            "metric": "control_spike_stage_delta",
            "value": (off.get("max_stage") - on.get("max_stage")
                      if off.get("max_stage") is not None
                      and on.get("max_stage") is not None else None),
            "unit": "stages",
            "vs_baseline": None,
            "seed": seed,
            "off_max_stage": off.get("max_stage"),
            "on_max_stage": on.get("max_stage"),
            "off_refused": off.get("publishes_refused"),
            "on_refused": on.get("publishes_refused"),
            "off_peak_bytes": off.get("peak_bytes"),
            "on_peak_bytes": on.get("peak_bytes"),
            "decision_log_sha256": on.get("log_sha256"),
            "control_soak": result,
        }))
        if result.get("violations") or not on:
            sys.exit(1)  # the tier-1 smoke must fail loudly
        return

    if "--churn" in sys.argv:
        # connection-churn leak check: N connect/declare-exclusive/publish/
        # disconnect cycles (half abrupt aborts), then the memory
        # accountant must be back at zero (chanamq_tpu_torch/chaos/soak.py
        # run_connection_churn). Any leaked accounted byte exits 1.
        cycles = int(os.environ.get("CHURN_CYCLES", "500"))
        from chanamq_tpu_torch.chaos.soak import run_connection_churn

        try:
            result = asyncio.run(asyncio.wait_for(
                run_connection_churn(cycles, device=router_device()), timeout=180))
        except Exception as exc:
            result = {"cycles": cycles,
                      "violations": [f"{type(exc).__name__}: {exc}"]}
        print(f"# connection_churn: {result}", file=sys.stderr)
        print(json.dumps({
            "metric": "churn_leaked_accounted_bytes",
            "value": result.get("leaked_bytes"),
            "unit": "bytes",
            "vs_baseline": None,
            "cycles": result.get("cycles"),
            "aborted": result.get("aborted"),
            "peak_accounted_bytes": result.get("peak_accounted_bytes"),
            "connection_churn": result,
        }))
        if result.get("violations"):
            sys.exit(1)  # the tier-1 smoke must fail loudly
        return

    if "--cluster" in sys.argv:
        # cluster scenario only: 2 in-process nodes, burst publish via the
        # non-owner + remote consume + paced remote latency — the
        # interconnect fast path as its own BENCH line
        result = run_cluster_spec()
        print(f"# cluster_2node: {result}", file=sys.stderr)
        print(json.dumps({
            "metric": "cluster_publish_via_nonowner_msgs_per_s",
            "value": result.get("publish_via_nonowner_msgs_per_s"),
            "unit": "msgs/s",
            "vs_baseline": None,
            "remote_consume_msgs_per_s":
                result.get("remote_consume_msgs_per_s"),
            "remote_p50_us": result.get("remote_p50_us"),
            "remote_p99_us": result.get("remote_p99_us"),
            "body_bytes": BODY_BYTES,
            "cluster_2node": result,
            **({"error": {"cluster_2node": result["error"]}}
               if "error" in result else {}),
        }))
        if "error" in result:
            sys.exit(1)  # the tier-1 smoke must fail loudly
        return

    if "--trace-overhead" in sys.argv:
        # tracing-cost scenario: the headline transient/autoAck spec run
        # three times — tracing off, the default 1% sample rate, and
        # everything-sampled — reporting the throughput delta vs off.
        # The broker is a subprocess, so tracing is switched via the
        # CHANAMQ_* env overrides it reads at boot. No budget gate: the
        # r1.0 run is expected to cost real throughput.
        run_overhead("trace_overhead_pct_at_r0.01", [
            ("off", None),
            ("r0.01", {"CHANAMQ_TRACE_ENABLED": "true",
                       "CHANAMQ_TRACE_SAMPLE_RATE": "0.01"}),
            ("r1.0", {"CHANAMQ_TRACE_ENABLED": "true",
                      "CHANAMQ_TRACE_SAMPLE_RATE": "1.0"}),
        ], value_label="r0.01")
        return

    if "--otel-overhead" in sys.argv:
        # OTLP-export cost: tracing on at the default 1% sample rate in
        # BOTH variants so the delta isolates what the otel layer adds —
        # the per-publish header probe, the finish-hook enqueue, and the
        # background flusher cycling against a dead collector endpoint
        # (port 1 refuses instantly, so every flush exercises the
        # ReconnectBackoff path, the worst production-adjacent case).
        # Held to the same <= 2% budget as every observability subsystem.
        run_overhead("otel_overhead_pct", [
            ("trace", {"CHANAMQ_TRACE_ENABLED": "true",
                       "CHANAMQ_TRACE_SAMPLE_RATE": "0.01"}),
            ("trace+otel", {"CHANAMQ_TRACE_ENABLED": "true",
                            "CHANAMQ_TRACE_SAMPLE_RATE": "0.01",
                            "CHANAMQ_OTEL_ENABLED": "true",
                            "CHANAMQ_OTEL_ENDPOINT":
                                "http://127.0.0.1:1/v1/traces"}),
        ], budget_pct=-2.0)
        return

    if "--telemetry-overhead" in sys.argv:
        # per-entity sampling cost: the headline transient/autoAck spec
        # with telemetry off vs on at a 100 ms tick (10x the default
        # rate). The hot path only pays the incremental gauge/counter
        # bumps; the sampler walk runs on the timer — the claim is a
        # <= 2% throughput delta, asserted here so tier-1 gates on it.
        run_overhead("telemetry_overhead_pct", [
            ("off", None),
            ("on", {"CHANAMQ_TELEMETRY_ENABLED": "true",
                    "CHANAMQ_TELEMETRY_INTERVAL": "100ms"}),
        ], budget_pct=-2.0)
        return

    if "--profile-overhead" in sys.argv:
        # cost-ledger cost: the headline spec with the profiler off vs on
        # (ledger + watchdog armed, stack sampler off — the production
        # always-on configuration). Every seam accumulates at batch
        # granularity precisely so this delta stays inside the same <= 2%
        # budget the other observability subsystems are held to.
        run_overhead("profile_overhead_pct", [
            ("off", None),
            ("on", {"CHANAMQ_PROFILE_ENABLED": "true",
                    "CHANAMQ_PROFILE_SAMPLE_HZ": "0"}),
        ], budget_pct=-2.0)
        return

    if "--slo-overhead" in sys.argv:
        # SLO-engine cost: telemetry on in BOTH variants (at the same
        # 100 ms tick --telemetry-overhead uses) so the delta isolates
        # what the SLO layer adds per tick — the SLI sampler's counter
        # deltas plus the burn-rate ring update, a few hundred integer
        # ops. Held to the same <= 2% budget as every observability
        # subsystem.
        run_overhead("slo_overhead_pct", [
            ("telemetry", {"CHANAMQ_TELEMETRY_ENABLED": "true",
                           "CHANAMQ_TELEMETRY_INTERVAL": "100ms"}),
            ("telemetry+slo", {"CHANAMQ_TELEMETRY_ENABLED": "true",
                               "CHANAMQ_TELEMETRY_INTERVAL": "100ms",
                               "CHANAMQ_SLO_ENABLED": "true"}),
        ], budget_pct=-2.0)
        return

    if "--event-overhead" in sys.argv:
        # event-bus + firehose cost with nothing bound — the always-on
        # production configuration. Every emit is an O(1) topic-trie
        # miss and a drop-counter bump; every publish/deliver pays one
        # tap call that routes to zero queues. <= 2% budget.
        run_overhead("event_overhead_pct", [
            ("off", None),
            ("on", {"CHANAMQ_EVENTS_ENABLED": "true",
                    "CHANAMQ_FIREHOSE_ENABLED": "true"}),
        ], budget_pct=-2.0)
        return

    if "--tenant" in sys.argv:
        # noisy-neighbor tenancy soak: three tenants on one node
        # (chanamq_tpu_torch/chaos/soak.py run_tenant_soak) — an aggressor
        # floods past its publish-rate token bucket and a memory-share
        # floor pins a backlog tenant, while the victim tenant's paced
        # p99 and tenant-scoped SLO budgets must stay intact and the
        # tenant-filtered event/firehose streams must carry exactly the
        # expected traffic. The episode runs TWICE with the same seed
        # and the tenancy decision logs must be byte-identical; any
        # violation exits non-zero.
        seed = 5
        if "--seed" in sys.argv:
            seed = int(sys.argv[sys.argv.index("--seed") + 1])
        from chanamq_tpu_torch.chaos.soak import run_tenant_soak

        try:
            result = asyncio.run(asyncio.wait_for(
                run_tenant_soak(seed, device=router_device()), timeout=240))
        except Exception as exc:
            result = {"seed": seed,
                      "violations": [f"{type(exc).__name__}: {exc}"]}
        print(f"# tenant_soak: violations={result.get('violations')} "
              f"log_sha256={result.get('log_sha256')}", file=sys.stderr)
        print(json.dumps({
            "metric": "tenant_soak_violations",
            "value": len(result.get("violations", [])),
            "unit": "violations",
            "vs_baseline": None,
            "seed": seed,
            "log_sha256": result.get("log_sha256"),
            "runs": result.get("runs", []),
            "violations": result.get("violations", []),
        }))
        if result.get("violations"):
            sys.exit(1)  # the tier-1 smoke must fail loudly
        return

    if "--tenant-churn" in sys.argv:
        # tenant-churn leak check: N define/remove rounds against a live
        # registry, every 100th with a full authenticated AMQP sub-cycle
        # (vhost create / connect / declare / publish-confirmed / delete)
        # — at the end every registry slot, auth view, accounted byte and
        # vhost must be exactly at baseline (chanamq_tpu_torch/chaos/soak.py
        # run_tenant_churn). Any leaked slot or byte exits 1.
        cycles = int(os.environ.get("TENANT_CHURN_CYCLES", "10000"))
        from chanamq_tpu_torch.chaos.soak import run_tenant_churn

        try:
            result = asyncio.run(asyncio.wait_for(
                run_tenant_churn(cycles, device=router_device()), timeout=240))
        except Exception as exc:
            result = {"cycles": cycles,
                      "violations": [f"{type(exc).__name__}: {exc}"]}
        print(f"# tenant_churn: {result}", file=sys.stderr)
        print(json.dumps({
            "metric": "tenant_churn_leaked_bytes",
            "value": result.get("leaked_bytes"),
            "unit": "bytes",
            "vs_baseline": None,
            "cycles": result.get("cycles"),
            "amqp_cycles": result.get("amqp_cycles"),
            "registry_slots": result.get("registry_slots"),
            "tenant_churn": result,
        }))
        if result.get("violations"):
            sys.exit(1)  # the tier-1 smoke must fail loudly
        return

    if "--tenant-overhead" in sys.argv:
        # tenancy cost with one quota-less tenant owning "/" — the
        # connection resolves its tenant once at Connection.Open; the
        # publish hot path then pays one attribute load + None check
        # (no rate quota -> no bucket spend) and the delivery path one
        # histogram-presence check. Held to the same <= 2% budget as
        # every other subsystem.
        run_overhead("tenant_overhead_pct", [
            ("off", None),
            ("on", {"CHANAMQ_TENANT_ENABLED": "true",
                    "CHANAMQ_TENANT_TENANTS":
                        '{"t0": {"vhosts": ["/"]}}'}),
        ], budget_pct=-2.0)
        return

    if "--profile" in sys.argv:
        # attribution smoke: ledger + sampler on, /admin/profile scraped
        # around the load window — gates on >=5 stages with traffic,
        # >=90% of broker CPU attributed to the top-level windows, and a
        # non-empty collapsed-stack payload
        result = run_profile_smoke()
        print(f"# profile: {result}", file=sys.stderr)
        active = result.get("stages_active") or []
        attributed = result.get("attributed_pct")
        failures = []
        if "error" in result:
            failures.append(result["error"])
        else:
            if len(active) < 5:
                failures.append(f"only {len(active)} stages saw traffic")
            if attributed is None or attributed < 90.0:
                failures.append(
                    f"attribution {attributed}% below the 90% gate")
            if not result.get("stack_lines"):
                failures.append("empty collapsed-stack payload")
        print(json.dumps({
            "metric": "profile_attributed_cpu_pct",
            "value": attributed,
            "unit": "%",
            "vs_baseline": None,
            "stages_active": active,
            "delivered_per_s": result.get("delivered_per_s"),
            "distinct_stacks": result.get("distinct_stacks"),
            "stack_lines": result.get("stack_lines"),
            "gc_pauses": result.get("gc_pauses"),
            "profile": result,
            **({"error": "; ".join(failures)} if failures else {}),
        }))
        if failures:
            sys.exit(1)  # the tier-1 smoke must fail loudly
        return

    if "--regress" in sys.argv:
        # bench-trajectory regression gate: best-of-N of the headline spec
        # vs the latest comparable line in BENCH_trajectory.jsonl. Never
        # appends unless --record is given (or no baseline exists yet), so
        # two consecutive --regress runs judge against the SAME baseline.
        record = "--record" in sys.argv
        scenario = os.environ.get("BENCH_REGRESS_SPEC",
                                  "transient_autoack_3p3c")
        attempts = max(1, int(os.environ.get("BENCH_REGRESS_RUNS", "2")))
        best = None
        run_errors = []
        for i in range(attempts):
            run = run_spec(scenario)
            print(f"# regress run {i + 1}/{attempts}: {run}",
                  file=sys.stderr)
            if "error" in run:
                run_errors.append(run["error"])
                continue
            rec = trajectory_record(scenario, run)
            if rec is not None and (
                    best is None or rec["us_per_msg"] < best["us_per_msg"]):
                best = rec
        if best is None:
            print(json.dumps({
                "metric": "bench_regress_us_per_msg", "value": None,
                "unit": "us/msg", "vs_baseline": None,
                "scenario": scenario,
                "error": "; ".join(run_errors) or "no clean run"}))
            sys.exit(1)
        traj_stats: dict = {}
        base = trajectory_baseline(scenario, stats=traj_stats)
        corrupt = traj_stats.get("corrupt_lines", 0)
        if corrupt:
            print(f"# regress: skipped {corrupt} corrupt trajectory "
                  f"line(s) in {TRAJECTORY_PATH}", file=sys.stderr)
        if base is None:
            # first run in this environment: seed the trajectory so the
            # next invocation has a baseline — nothing to gate against
            trajectory_append(best)
            print(json.dumps({
                "metric": "bench_regress_us_per_msg",
                "value": best["us_per_msg"],
                "unit": "us/msg", "vs_baseline": None,
                "scenario": scenario, "seeded": True,
                "cpu_us_per_msg": best["cpu_us_per_msg"],
                "trajectory": TRAJECTORY_PATH,
                "corrupt_lines_skipped": corrupt,
            }))
            return
        verdict = regress_evaluate(best, base)
        # the judged-against baseline, stated in full: without the rev +
        # fingerprint a red gate can't be traced back to the run that
        # set the bar
        print(f"# regress baseline: rev={base.get('rev')} "
              f"ts={base.get('ts')} env={base.get('env')} "
              f"us_per_msg={base.get('us_per_msg')} "
              f"cpu_us_per_msg={base.get('cpu_us_per_msg')}",
              file=sys.stderr)
        if record:
            trajectory_append(best)
        print(json.dumps({
            "metric": "bench_regress_us_per_msg",
            "value": best["us_per_msg"],
            "unit": "us/msg",
            "vs_baseline": round(
                (best["us_per_msg"] - base["us_per_msg"])
                / base["us_per_msg"] * 100, 2) if base.get("us_per_msg")
                else None,
            "scenario": scenario,
            "recorded": record,
            "trajectory": TRAJECTORY_PATH,
            "corrupt_lines_skipped": corrupt,
            "base_env": base.get("env"),
            **verdict,
        }))
        if verdict["regressed"]:
            sys.exit(1)  # a confirmed wall+CPU regression fails the gate
        return

    if "--replicate" in sys.argv:
        # replication scenario only: factor-2 sync confirms on private
        # per-node stores (lag + confirm latency as its own BENCH line)
        result = run_replicate_spec()
        print(f"# replicate_2node: {result}", file=sys.stderr)
        print(json.dumps({
            "metric": "replicated_sync_confirm_p99_us",
            "value": result.get("sync_confirm_p99_us"),
            "unit": "us",
            "vs_baseline": None,
            "repl_lag_events": result.get("repl_lag_events"),
            "sync_publish_msgs_per_s":
                result.get("sync_publish_msgs_per_s"),
            "body_bytes": BODY_BYTES,
            "replicate_2node": result,
            **({"error": {"replicate_2node": result["error"]}}
               if "error" in result else {}),
        }))
        return

    which = os.environ.get("BENCH_SPECS", "all")
    if which == "a":
        names = ["transient_autoack_3p3c"]
    elif which == "all":
        names = list(SPECS) + list(TOPO_SPECS)
    else:
        names = [n.strip() for n in which.split(",")
                 if n.strip() in SPECS or n.strip() in TOPO_SPECS]
        if not names:
            print(f"# BENCH_SPECS={which!r} matched no spec; running all",
                  file=sys.stderr)
            names = list(SPECS) + list(TOPO_SPECS)
    results = {}
    for name in names:
        results[name] = run_spec(name)
        print(f"# {name}: {results[name]}", file=sys.stderr)
    headline = results[names[0]]
    paced_shape = "burst"
    if "--paced-shape" in sys.argv:
        paced_shape = sys.argv[sys.argv.index("--paced-shape") + 1]
        if paced_shape not in ("burst", "smooth"):
            print(f"# unknown --paced-shape {paced_shape!r}; using burst",
                  file=sys.stderr)
            paced_shape = "burst"
    if which != "a":
        # paced latency runs at ~25% of the measured PUBLISHED throughput
        # (not delivered: a fan-out headline's delivered rate counts every
        # copy and would oversaturate the 1p1c spec), or the env override.
        # --paced-shape smooth paces per message instead of 10 ms
        # micro-bursts and records under its own scenario name: the burst
        # shape's queueing delay floors the measured p99 near 10 ms, so
        # sub-ms broker latency is only visible in the smooth series.
        for paced_name, env_key, base in (
                (PACED_SPEC, "BENCH_PACED_RATE", headline),
                (PACED_PERSISTENT_SPEC, "BENCH_PACED_PERSISTENT_RATE",
                 results.get("persistent_autoack_3p1c", {}))):
            rate_env = os.environ.get(env_key)
            if rate_env is not None:
                rate = int(rate_env)
            elif base.get("published_per_s"):
                rate = max(1000, int(base["published_per_s"] * 0.25))
            else:
                print(f"# {paced_name}: skipped (no base throughput and "
                      f"no {env_key})", file=sys.stderr)
                continue
            key = (paced_name if paced_shape == "burst"
                   else f"{paced_name}_smooth")
            results[key] = run_spec(paced_name, rate=rate,
                                    shape=paced_shape)
            results[key]["rate"] = rate
            print(f"# {key}: {results[key]}", file=sys.stderr)
    cluster = None
    if which == "all":
        cluster = run_cluster_spec()
        print(f"# cluster_2node: {cluster}", file=sys.stderr)
    # every clean spec run extends the bench trajectory, so the numbers
    # quoted in BENCH.md/README always have a recorded provenance line
    # and `bench.py --regress` has baselines to gate against
    if os.environ.get("BENCH_TRAJECTORY", "1") != "0":
        for name, result in results.items():
            if "error" not in result:
                rec = trajectory_record(name, result)
                if rec is not None:
                    trajectory_append(rec)
    line = {
        "metric": "amqp_delivered_msgs_per_s_transient_autoack_3p3c",
        "value": headline.get("delivered_per_s"),
        "unit": "msgs/s",
        "vs_baseline": None,  # reference published no numbers (BASELINE.md)
        "p99_publish_to_deliver_us": headline.get("p99_us"),
        "paced_p50_us": results.get(PACED_SPEC, {}).get("p50_us"),
        "paced_p99_us": results.get(PACED_SPEC, {}).get("p99_us"),
        "paced_persistent_p99_us":
            results.get(PACED_PERSISTENT_SPEC, {}).get("p99_us"),
        "body_bytes": BODY_BYTES,
        "seconds": BENCH_SECONDS,
        "specs": results,
    }
    if cluster is not None:
        line["cluster_2node"] = cluster
    spec_errors = {n: r["error"] for n, r in results.items() if "error" in r}
    if cluster is not None and "error" in cluster:
        spec_errors["cluster_2node"] = cluster["error"]
    if spec_errors:
        line["error"] = spec_errors
    print(json.dumps(line))


if __name__ == "__main__":
    main()
