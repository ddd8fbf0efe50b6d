"""The chaos soak: a 3-node replicated workload under a seeded fault plan.

Shared by ``python -m chanamq_tpu_torch.bench --chaos`` and
``tests/test_torch_chaos.py`` so the bench smoke and the test suite assert
the same invariants. Every runner takes ``device``, the router device of
each broker it builds (``cuda`` by default, as the port's entry points;
the CPU only when a caller asks for it):

1. **No confirmed message lost** — every body whose publisher confirm
   arrived is delivered to the consumer at least once.
2. **No double-delivery after settle** — duplicates during failover are
   at-least-once reality and merely counted; once the workload settles
   (everything delivered, surviving owner's queue empty, observation
   window passed) no further delivery may arrive.
3. **Exactly one failover promotion** — the owner crash promotes exactly
   one replica, cluster-wide.
4. **Cursors resume at committed offsets** — a stream consumer that
   detaches and reattaches at "next" resumes at committed+1 and reads
   contiguously to the tail.
5. **Reconnect stays inside the backoff budget** — the publisher finishes
   every message despite injected disconnects/partitions, and no stream's
   backoff delay ever exceeds the configured ceiling.
6. **Health gates and alerts are deterministic** — both nodes must report
   ready (telemetry/health.py) before any load is offered, and a scripted
   backlog + stalled-consumer phase on the surviving node must fire
   exactly the expected alert rules: the telemetry services are
   tick-driven by the harness (no timers), so the alert engine sees the
   same series every run and the firing set is exact, like the fault
   schedule itself.

Topology: three nodes A, B, C with private stores (MemoryStore by
default; ``wal=True`` gives every node a WAL-fronted SQLite store so the
group-fsync confirm gate sits in the durability path under chaos),
replicate factor 2, sync confirms. Queue ``rq`` is owned by A with its
replica placed on B, but published AND consumed via B, so every message
crosses the data plane twice (push B->A, deliver A->B) and every confirm
gates on A's mutation-log ship back to B. Mid-run a crash rule kills A;
B must promote its replica and finish the workload locally while C looks
on — exactly one promotion cluster-wide (the replica holder), but BOTH
survivors observe the DOWN and re-hash the ring once each. The stream
queue lives on B (replica on C) and survives the crash.

Determinism: the publisher consults the plan once per message at the
``soak.tick`` site, so the crash fires at a fixed publish index for a
given seed. Transport-site rules use invocation windows, making their
schedule a pure function of the seed as well (see plan.py).
"""

from __future__ import annotations

import asyncio
from typing import Optional

from . import ChaosStore, FaultPlan, FaultRule, _LazyRuntime, clear, install

# logical crash-target name the plan uses; the harness maps it to node A
CRASH_TARGET = "owner"

BACKOFF_BUDGET_S = 5.0  # ReconnectBackoff max_s: no delay may exceed it


def default_plan(seed: int, owner: str, messages: int) -> FaultPlan:
    """The full seeded soak: partitions + node crash + slow store +
    transport latency/disconnects. Windows are invocation-indexed so the
    schedule is deterministic per seed; the crash rides the publisher's
    ``soak.tick`` so it lands at a fixed publish index. Transport faults
    that can strand state on A (lost settles, dropped deliver batches)
    are windowed BEFORE the crash: failover requeues them from B's
    replica, which is exactly the recovery the soak must prove."""
    crash_at = max(10, int(messages * 0.55))
    return FaultPlan(seed, [
        FaultRule(name="crash-owner", kind="crash", sites=["soak.tick"],
                  after=crash_at, count=1, nodes=[CRASH_TARGET]),
        FaultRule(name="partition-to-owner", kind="partition",
                  sites=["data.send"], nodes=[owner], after=20, until=45),
        FaultRule(name="drop-deliver", kind="drop", sites=["data.event"],
                  count=2, after=5, until=crash_at),
        FaultRule(name="disconnect-data", kind="disconnect",
                  sites=["data.read"], probability=0.05, count=2,
                  until=crash_at),
        FaultRule(name="wire-latency", kind="latency",
                  sites=["data.send", "rpc.call"], probability=0.05,
                  delay_ms=3),
        FaultRule(name="slow-store", kind="latency", sites=["store.flush"],
                  probability=0.3, delay_ms=8),
    ])


async def run_soak(
    seed: int, *, messages: int = 160, stream_records: int = 40,
    plan: Optional[FaultPlan] = None, metrics_sink=None,
    uds: bool = False, wal: bool = False, device: str = "cuda",
) -> dict:
    """Run the workload under the plan; returns a report whose
    ``violations`` list is empty iff every invariant held.

    ``uds=True`` runs the interconnect over Unix-domain sockets — the
    exact transport sibling shards use (shard/) — so the crash becomes
    the shard-crash drill: same plan, same invariants, plus ownership
    re-hashes observed by each survivor.

    ``wal=True`` backs every node with a WAL-fronted SQLite store
    (wal/engine.py over a private temp dir): confirms then gate on the
    cross-channel group fsync, and the slow-store rule stalls the WAL
    commit barrier itself — proving the no-confirmed-loss invariant with
    the real durability engine in the path, not a memory stand-in.

    ``device`` is every node's router device."""
    import os
    import shutil
    import tempfile

    from ..amqp.properties import BasicProperties
    from ..client.client import AMQPClient
    from ..store.memory import MemoryStore
    from ..broker.broker import Broker
    from ..broker.server import BrokerServer
    from ..cluster.node import ClusterNode
    from ..telemetry import TelemetryService
    from ..telemetry.alerts import default_rules as alert_defaults

    uds_dir = tempfile.mkdtemp(prefix="chanamq-soak-") if uds else None
    wal_dir = tempfile.mkdtemp(prefix="chanamq-soak-wal-") if wal else None
    wal_count = 0

    def make_store():
        if not wal:
            return MemoryStore()
        nonlocal wal_count
        from ..store.sqlite import SqliteStore
        from ..wal import WalStore
        wal_count += 1
        path = os.path.join(wal_dir, f"node{wal_count}.db")
        return WalStore(SqliteStore(path), flush_ms=1.0, checkpoint_ms=200.0)

    async def start_node(seeds, uds_path=None):
        srv = BrokerServer(
            broker=Broker(store=make_store(), router_device=device),
            host="127.0.0.1", port=0, heartbeat_s=0)
        await srv.start()
        cl = ClusterNode(srv.broker, "127.0.0.1", 0, seeds,
                         heartbeat_interval_s=0.2, failure_timeout_s=1.5,
                         replicate_factor=2, replicate_sync=True,
                         replicate_ack_timeout_ms=2000,
                         uds_path=uds_path)
        await cl.start()
        # tick-driven telemetry: the harness calls sample_tick at scripted
        # points instead of starting the timer task, so the alert engine's
        # input series — and therefore its firings — are exact. Node-scoped
        # rules get unreachable thresholds (loop lag and replication lag
        # depend on host timing, which would make firings flaky).
        srv.broker.telemetry = TelemetryService(
            srv.broker, interval_s=1.0, ring_ticks=64,
            rules=alert_defaults(
                backlog_growth=50.0, backlog_window=5, stall_ticks=3,
                repl_lag=1e12, loop_lag_ms=1e12))
        return srv, cl

    a_srv = a_cl = b_srv = b_cl = c_srv = c_cl = None
    conns: list = []
    violations: list[str] = []
    try:
        a_path = os.path.join(uds_dir, "a.sock") if uds_dir else None
        b_path = os.path.join(uds_dir, "b.sock") if uds_dir else None
        c_path = os.path.join(uds_dir, "c.sock") if uds_dir else None
        a_srv, a_cl = await start_node([], uds_path=a_path)
        b_srv, b_cl = await start_node([a_cl.name], uds_path=b_path)
        c_srv, c_cl = await start_node([a_cl.name], uds_path=c_path)
        if uds:
            # ephemeral cluster ports: names exist only after start, so
            # the sibling map is patched in afterwards (real shards use
            # fixed base+index ports and get the map at construction)
            for cl, path in ((a_cl, a_path), (b_cl, b_path), (c_cl, c_path)):
                for other, opath in ((a_cl, a_path), (b_cl, b_path),
                                     (c_cl, c_path)):
                    if other is not cl:
                        cl.uds_map[other.name] = opath
        clusters = (a_cl, b_cl, c_cl)
        for _ in range(100):
            if all(len(cl.membership.alive_members()) == 3
                   for cl in clusters):
                break
            await asyncio.sleep(0.05)
        else:
            raise RuntimeError("3-node membership did not converge")

        # -- health gate (invariant 6a): all nodes ready before any load
        health_gate: dict[str, bool] = {}
        for srv, cl in ((a_srv, a_cl), (b_srv, b_cl), (c_srv, c_cl)):
            srv.broker.telemetry.sample_tick(1.0)
            health = srv.broker.telemetry.health()
            health_gate[cl.name] = health["ready"]
            if not health["ready"]:
                violations.append(
                    f"health gate: {cl.name} not ready before load: "
                    f"{health['reasons']}")

        # placement is pinned, not just ownership: rq's replica must sit
        # on B (the consumer's node) so the crash promotes where the
        # consumer already is, and sq's on C so the stream's sync-confirm
        # path never gates on the dead node
        def placed(prefix, owner, replica):
            return next(
                f"{prefix}{i}" for i in range(2000)
                if a_cl.ring.preference_entity("q", "/", f"{prefix}{i}", 2)
                == [owner.name, replica.name])

        rq = placed("cq", a_cl, b_cl)
        sq = placed("cs", b_cl, c_cl)

        if plan is None:
            plan = default_plan(seed, a_cl.name, messages)
        runtime = install(plan, metrics=metrics_sink or b_srv.broker.metrics)
        fingerprint = plan.fingerprint()
        # store seams on both nodes (the slow-store rule hits the flush
        # barrier); the lazy shim keeps them live across install/clear
        a_srv.broker.store = ChaosStore(a_srv.broker.store, _LazyRuntime())
        b_srv.broker.store = ChaosStore(b_srv.broker.store, _LazyRuntime())
        c_srv.broker.store = ChaosStore(c_srv.broker.store, _LazyRuntime())

        crashed = asyncio.Event()

        def crash_owner() -> None:
            async def _die():
                # abrupt stop: no drain ordering — B must detect the
                # silence (no leave protocol) and promote
                for part in (a_cl, a_srv):
                    try:
                        await part.stop()
                    except Exception:
                        pass
                crashed.set()
            asyncio.get_event_loop().create_task(_die())

        runtime.on_crash(CRASH_TARGET, crash_owner)

        # -- consumer on B (remote consumer of A's queue, then local
        #    consumer of the promoted replica after the crash)
        persistent = BasicProperties(delivery_mode=2)
        deliveries: dict[str, int] = {}
        settle_mark = asyncio.Event()
        post_settle: list[str] = []
        delivered_event = asyncio.Event()

        c_conn = await AMQPClient.connect("127.0.0.1", b_srv.bound_port)
        conns.append(c_conn)
        c_ch = await c_conn.channel()
        await c_ch.basic_qos(prefetch_count=64)

        def on_msg(msg):
            body = bytes(msg.body).decode()
            deliveries[body] = deliveries.get(body, 0) + 1
            if settle_mark.is_set():
                post_settle.append(body)
            c_ch.basic_ack(msg.delivery_tag)
            delivered_event.set()

        p_conn = await AMQPClient.connect("127.0.0.1", b_srv.bound_port)
        conns.append(p_conn)
        p_ch = await p_conn.channel()
        await p_ch.confirm_select()
        await p_ch.queue_declare(rq, durable=True)
        for _ in range(100):
            if ("/", rq) in b_cl.queue_metas:
                break
            await asyncio.sleep(0.05)
        await c_ch.basic_consume(rq, on_msg, consumer_tag="soak-consumer")

        # -- publisher: one confirm-gated message at a time, reconnecting
        #    through aborts/partitions; soak.tick drives the crash index
        confirmed: set[int] = set()
        attempts = 0
        max_backoff_seen = 0.0

        def observe_backoff() -> None:
            nonlocal max_backoff_seen
            for cl in (b_cl,):
                for plane in cl._dataplanes.values():
                    for st in plane.stats()["backoff"]:
                        max_backoff_seen = max(max_backoff_seen,
                                               st["delay_s"])

        async def reconnect_publisher():
            nonlocal p_conn, p_ch
            try:
                await p_conn.close()
            except Exception:
                pass
            p_conn = await AMQPClient.connect("127.0.0.1",
                                              b_srv.bound_port)
            conns.append(p_conn)
            p_ch = await p_conn.channel()
            await p_ch.confirm_select()

        for i in range(messages):
            runtime.decide("soak.tick")  # deterministic crash index
            body = f"m{i:06d}".encode()
            for attempt in range(60):
                attempts += 1
                try:
                    await p_ch.basic_publish_confirmed(
                        body, routing_key=rq, properties=persistent,
                        timeout=8)
                    confirmed.add(i)
                    break
                except Exception:
                    observe_backoff()
                    await asyncio.sleep(0.25)
                    try:
                        await reconnect_publisher()
                    except Exception:
                        pass  # next attempt retries the dial
            else:
                violations.append(
                    f"publish m{i:06d} never confirmed within the "
                    f"reconnect budget")
                break
        observe_backoff()

        # -- drain: every confirmed body delivered at least once, then the
        #    surviving owner's queue runs empty (requeued strays included)
        want = {f"m{i:06d}" for i in confirmed}

        def surviving_queue():
            for srv in (b_srv, c_srv, a_srv):
                if srv is None:
                    continue
                vhost = srv.broker.vhosts.get("/")
                queue = vhost.queues.get(rq) if vhost else None
                if queue is not None and queue.consumer_count:
                    return queue
            return None

        deadline = asyncio.get_event_loop().time() + 45
        while asyncio.get_event_loop().time() < deadline:
            queue = surviving_queue()
            if (want <= set(deliveries) and queue is not None
                    and queue.message_count == 0
                    and not queue.outstanding):
                break
            delivered_event.clear()
            try:
                await asyncio.wait_for(delivered_event.wait(), 0.25)
            except asyncio.TimeoutError:
                pass
        missing = sorted(want - set(deliveries))
        if missing:
            violations.append(
                f"confirmed-but-lost: {len(missing)} messages "
                f"(first: {missing[:5]})")

        # -- settle: duplicates beyond this point violate invariant 2
        settle_mark.set()
        await asyncio.sleep(0.7)
        duplicates = sum(n - 1 for n in deliveries.values() if n > 1)
        if post_settle:
            violations.append(
                f"{len(post_settle)} deliveries after settle "
                f"(first: {post_settle[:5]})")

        # -- promotion accounting (A's metrics survive its stop)
        promotions = (a_srv.broker.metrics.repl_promotions
                      + b_srv.broker.metrics.repl_promotions
                      + c_srv.broker.metrics.repl_promotions)
        # ownership re-hash accounting: each DOWN event a node observes
        # re-hashes the ring once and bumps shard_handoffs; with 3 nodes
        # BOTH survivors observe the crash (one re-hash each), but only
        # the replica holder (B) promotes — so a crash run must show
        # exactly two re-hashes and exactly one promotion cluster-wide,
        # and a clean run none of either
        handoffs = (a_srv.broker.metrics.shard_handoffs
                    + b_srv.broker.metrics.shard_handoffs
                    + c_srv.broker.metrics.shard_handoffs)
        expect_crash = any(r.kind == "crash" for r in plan.rules)
        if expect_crash:
            if not crashed.is_set():
                violations.append("crash rule never fired")
            if promotions != 1:
                violations.append(
                    f"expected exactly 1 promotion, saw {promotions}")
            if handoffs != 2:
                violations.append(
                    f"expected exactly 2 ownership re-hashes "
                    f"(one per survivor), saw {handoffs}")
        else:
            if promotions:
                violations.append(f"unexpected promotion(s): {promotions}")
            if handoffs:
                violations.append(
                    f"unexpected ownership re-hash(es): {handoffs}")

        if max_backoff_seen > BACKOFF_BUDGET_S:
            violations.append(
                f"backoff delay {max_backoff_seen:.2f}s exceeded the "
                f"{BACKOFF_BUDGET_S}s budget")

        # -- stream cursor resume (on B, which survived)
        stream = await _stream_cursor_check(
            b_srv, sq, stream_records, violations)

        # -- key-shared group ordering through a member disconnect (on B)
        key_shared = await _key_shared_group_check(
            b_srv, placed("ks", b_cl, c_cl), violations)

        # -- deterministic alert firings (invariant 6b) on the survivor
        alerts = await _alert_phase(b_srv, b_cl, violations)

        return {
            "seed": seed,
            "fingerprint": fingerprint,
            "nodes": 3,
            "store": "wal+sqlite" if wal else "memory",
            "replicate_factor": 2,
            "messages": messages,
            "confirmed": len(confirmed),
            "publish_attempts": attempts,
            "delivered_unique": len(set(deliveries) & want),
            "duplicates": duplicates,
            "post_settle_duplicates": len(post_settle),
            "promotions": promotions,
            "handoffs": handoffs,
            "interconnect": "uds" if uds else "tcp",
            "crashed": crashed.is_set(),
            "max_backoff_s": round(max_backoff_seen, 3),
            "stream": stream,
            "key_shared": key_shared,
            "health_gate": health_gate,
            "alerts": alerts,
            "chaos": runtime.status(),
            "violations": violations,
        }
    finally:
        clear()
        for conn in conns:
            try:
                await conn.close()
            except Exception:
                pass
        for part in (c_cl, c_srv, b_cl, b_srv, a_cl, a_srv):
            if part is not None:
                try:
                    await part.stop()
                except Exception:
                    pass
        if wal_dir is not None:
            shutil.rmtree(wal_dir, ignore_errors=True)


# the scripted alert phase must fire exactly these rules, every run
EXPECTED_ALERT_RULES = ("backlog-growth", "consumer-stall")

# the overload soak's scripted pressure phase must fire exactly this rule
OVERLOAD_ALERT_RULES = ("memory-pressure",)


def overload_plan(seed: int, *, pre_ticks: int = 20,
                  pressure_ticks: int = 80,
                  inflate_bytes: int = 3_900_000) -> FaultPlan:
    """The overload soak's fault plan: one ``pressure`` rule riding the
    broker's ``flow.tick`` sweep site. The window is invocation-indexed
    (sweep tick N), so for a given plan the accountant sees the same
    inflation series every run: zero for ``pre_ticks`` ticks, then
    ``inflate_bytes`` for ``pressure_ticks`` ticks, then zero again.
    The default inflation sits between the refuse watermark and the hard
    limit of the soak's broker, so the ladder jumps straight to the
    refuse stage and the headroom left for real accounted bytes is what
    the peak-under-hard-limit invariant exercises."""
    return FaultPlan(seed, [
        FaultRule(name="memory-pressure", kind="pressure",
                  sites=["flow.tick"], after=pre_ticks,
                  until=pre_ticks + pressure_ticks,
                  inflate_bytes=inflate_bytes),
    ])


async def run_overload_soak(
    seed: int, *, messages: int = 160, body_bytes: int = 1024,
    plan: Optional[FaultPlan] = None, device: str = "cuda",
) -> dict:
    """Single-node overload soak: a deterministic memory-pressure chaos
    rule drives the flow ladder to the refuse stage while a flooding
    publisher hammers the broker at far beyond the consumer's drain rate.
    Returns a report whose ``violations`` list is empty iff:

    1. **Accounted bytes never exceed the hard limit** — the ladder's
       whole point: paging + throttling + refusal keep the accountant's
       peak (chaos inflation included) under ``flow.hard-limit``.
    2. **Zero confirmed-message loss** — every body whose publisher
       confirm arrived is delivered, refusals and channel closes
       notwithstanding (a refused publish is never confirmed).
    3. **Publishes are actually refused at the refuse stage** (406
       PRECONDITION_FAILED channel close) while the attached consumer
       keeps draining the backlog.
    4. **channel.flow stop/resume round-trips on the wire** — the
       well-behaved publisher sees exactly Flow(active=False) on
       escalation and Flow(active=True) on recovery, and publishes its
       remaining quota after the resume.
    5. **Full recovery to the low watermark** — once the pressure window
       closes, the ladder cascades back to stage 0 and the accounted
       total settles at/below the low watermark.
    6. **Deterministic alerting and readiness** — the harness-ticked
       telemetry fires exactly ``memory-pressure`` (and resolves it),
       and /admin/health readiness drops only during the refuse stage.
    """
    import time

    from ..broker.broker import Broker
    from ..broker.server import BrokerServer
    from ..client.client import AMQPClient
    from ..flow import STAGE_REFUSE, STAGE_THROTTLE
    from ..store.memory import MemoryStore
    from ..telemetry import TelemetryService
    from ..telemetry.alerts import default_rules as alert_defaults

    broker = Broker(
        store=MemoryStore(),
        message_sweep_interval_s=0.05,    # fast flow ticks for the soak
        queue_max_resident=8,             # base passivation stays on
        flow_high_watermark=128 * 1024,
        flow_hard_limit=4 * 1024 * 1024,  # refuse = 90% of this
        flow_page_resident=2,             # stage>=1 pages queues to 2 bodies
        flow_publish_credit=16 * 1024,
        flow_consumer_buffer=4 * 1024 * 1024,
        router_device=device,
    )
    flow = broker.flow
    if plan is None:
        plan = overload_plan(seed)
    srv = BrokerServer(broker=broker, host="127.0.0.1", port=0,
                       heartbeat_s=0)
    # harness-ticked telemetry: every rule except memory-pressure gets an
    # unreachable threshold so the firing set is a pure function of the
    # scripted pressure window
    broker.telemetry = TelemetryService(
        broker, interval_s=1.0, ring_ticks=64,
        rules=alert_defaults(backlog_growth=1e12, stall_ticks=10**6,
                             repl_lag=1e12, loop_lag_ms=1e12,
                             memory_stage=3.5))
    svc = broker.telemetry

    # throttle episode wall-clock, observed at the broker's own ladder
    throttle_t: dict[str, float] = {}

    def stage_watch(old: int, new: int) -> None:
        if new >= STAGE_THROTTLE and old < STAGE_THROTTLE:
            throttle_t.setdefault("start", time.perf_counter())
        if new < STAGE_THROTTLE <= old:
            throttle_t["end"] = time.perf_counter()

    flow.listeners.append(stage_watch)

    violations: list[str] = []
    conns: list = []
    qn = "overload_q"
    pad = b"x" * body_bytes
    phase_a = min(64, max(8, messages // 3))
    phase_resume = min(32, max(4, messages // 5))
    p2_count = max(1, messages - phase_a - phase_resume)

    async def wait_for(predicate, timeout: float, what: str) -> bool:
        deadline = asyncio.get_event_loop().time() + timeout
        while not predicate():
            if asyncio.get_event_loop().time() > deadline:
                violations.append(f"timeout waiting for {what}")
                return False
            await asyncio.sleep(0.01)
        return True

    try:
        await srv.start()
        runtime = install(plan, metrics=broker.metrics)
        fingerprint = plan.fingerprint()

        # -- event bus + SLO engine (the observability demo): an AMQP
        #    consumer on amq.chanamq.event watches the ladder escalate
        #    (flow.stage.*), the memory-pressure alert fire, and the
        #    readiness SLO burn/clear — all as ordinary messages. The SLO
        #    spec's windows are tiny because the harness drives exactly 2
        #    not-ready ticks at the refuse stage and 4 ready ticks after
        #    recovery: both pairs must fire at the stage and clear by the
        #    final tick, every run.
        import json as json_mod

        from .. import events as events_mod
        from ..slo import SLOEngine, SLOSpec

        svc.set_slo(SLOEngine([SLOSpec(
            "readiness", "readiness", objective=0.999,
            fast_windows=(2, 4), slow_windows=(4, 8),
            fast_burn=10.0, slow_burn=10.0, budget_window=64)]))
        ev_conn = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        conns.append(ev_conn)
        ev_ch = await ev_conn.channel()
        await ev_ch.queue_declare("ovl-events")
        for pattern in ("flow.#", "alert.#", "slo.#"):
            await ev_ch.queue_bind("ovl-events", "amq.chanamq.event",
                                   pattern)
        observed_events: list[str] = []

        def on_bus(msg):
            observed_events.append(json_mod.loads(bytes(msg.body))["event"])
            ev_ch.basic_ack(msg.delivery_tag)

        await ev_ch.basic_consume("ovl-events", on_bus,
                                  consumer_tag="ovl-events")
        events_mod.install(events_mod.EventBus(broker))

        deliveries: dict[bytes, int] = {}

        # -- well-behaved publisher P1: floods a backlog before the
        #    pressure window, then honors channel.flow
        p1 = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        conns.append(p1)
        p1_ch = await p1.channel()
        await p1_ch.confirm_select()
        await p1_ch.queue_declare(qn)
        for i in range(phase_a):
            p1_ch.basic_publish(b"p1-%05d" % i + pad, routing_key=qn)
        await p1_ch.wait_unconfirmed_below(1, timeout=15)
        confirmed: set[bytes] = {b"p1-%05d" % i for i in range(phase_a)}

        # -- the pressure window opens: the ladder must jump to refuse
        await wait_for(lambda: flow.stage >= STAGE_REFUSE, 15,
                       "refuse stage under chaos pressure")
        stage4_total = flow.total

        # readiness drops only now, with the stage as the reason
        svc.sample_tick(1.0)
        svc.sample_tick(1.0)
        health_mid = svc.health()
        if health_mid["ready"]:
            violations.append("health stayed ready at the refuse stage")
        if not any("memory pressure" in r for r in health_mid["reasons"]):
            violations.append(
                f"refuse-stage health reasons lack memory pressure: "
                f"{health_mid['reasons']}")

        # -- flooding publisher P2: 10x+ the drain rate by construction
        #    (saturated in-process bursts, no pacing). Refusals close its
        #    channel with 406; it reopens and retries until everything it
        #    ever got confirmed is accounted, nothing more.
        refusals_seen = 0

        async def p2_run() -> set[bytes]:
            nonlocal refusals_seen
            conn = await AMQPClient.connect("127.0.0.1", srv.bound_port)
            conns.append(conn)
            ch = None
            sent: dict[int, int] = {}    # publish seq -> message index
            todo = list(range(p2_count))
            done: set[bytes] = set()
            deadline = asyncio.get_event_loop().time() + 60
            while todo or sent:
                if asyncio.get_event_loop().time() > deadline:
                    violations.append(
                        f"P2 never finished: {len(todo)} todo, "
                        f"{len(sent)} unresolved")
                    break
                if ch is None or ch.closed:
                    if ch is not None:
                        # a 406 refusal closed the channel: seqs no longer
                        # in `unconfirmed` were acked before the close and
                        # stay confirmed; the rest were never executed
                        refusals_seen += 1
                        pending = set(ch.unconfirmed)
                        for seq, idx in sent.items():
                            if seq in pending:
                                todo.append(idx)
                            else:
                                done.add(b"p2-%05d" % idx)
                        sent = {}
                        await asyncio.sleep(0.05)
                    ch = await conn.channel()
                    await ch.confirm_select()
                while todo and len(ch.unconfirmed) < 32:
                    idx = todo.pop()
                    seq = ch.basic_publish(b"p2-%05d" % idx + pad,
                                           routing_key=qn)
                    sent[seq] = idx
                try:
                    await ch.wait_unconfirmed_below(1, timeout=5)
                except Exception:
                    continue  # closed (refused) or still gated: resolve above
                done.update(b"p2-%05d" % idx for idx in sent.values())
                sent = {}
            return done

        p2_task = asyncio.create_task(p2_run())
        await wait_for(lambda: broker.metrics.flow_publishes_refused > 0,
                       10, "a refused publish at the refuse stage")

        # stage >= 1 tightened the resident cap: before the consumer can
        # drain the backlog away, the sweep must page bodies beyond
        # flow.page-resident out to the store
        await wait_for(lambda: broker.metrics.flow_paged_bodies > 0, 10,
                       "flow-paged bodies under pressure")

        # -- consumer attaches mid-refusal: draining must keep working
        #    while publishers are being refused
        c_conn = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        conns.append(c_conn)
        c_ch = await c_conn.channel()
        await c_ch.basic_qos(prefetch_count=64)

        def on_msg(msg):
            body = bytes(msg.body[:8])
            deliveries[body] = deliveries.get(body, 0) + 1
            c_ch.basic_ack(msg.delivery_tag)

        await c_ch.basic_consume(qn, on_msg, consumer_tag="overload")
        await wait_for(
            lambda: sum(deliveries.values()) >= phase_a // 2, 15,
            "consumer drain progress during the refuse stage")
        drained_under_refuse = (flow.stage >= STAGE_REFUSE,
                                sum(deliveries.values()))
        if not drained_under_refuse[0]:
            violations.append(
                "pressure window ended before the drain-under-refuse "
                "observation (window too short for this host)")

        # -- the window closes: full recovery, publisher resume included
        await wait_for(lambda: flow.stage == 0, 30,
                       "recovery to stage 0 after the pressure window")
        confirmed |= await asyncio.wait_for(p2_task, 60)
        for _ in range(4):
            svc.sample_tick(1.0)
        health_end = svc.health()
        if not health_end["ready"]:
            violations.append(
                f"health not ready after recovery: {health_end['reasons']}")

        # the well-behaved publisher saw exactly stop -> resume and can
        # publish its remaining quota afterwards
        await wait_for(lambda: p1_ch.flow_events == [False, True], 10,
                       "channel.flow stop/resume pair on the idle publisher")
        if p1_ch.flow_events != [False, True]:
            violations.append(
                f"publisher flow events not [stop, resume]: "
                f"{p1_ch.flow_events}")
        for i in range(phase_resume):
            p1_ch.basic_publish(b"p1-%05d" % (phase_a + i) + pad,
                                routing_key=qn)
        await p1_ch.wait_unconfirmed_below(1, timeout=15)
        confirmed |= {b"p1-%05d" % (phase_a + i) for i in range(phase_resume)}

        # -- zero confirmed loss: every confirmed body delivered
        await wait_for(lambda: confirmed <= set(deliveries), 30,
                       "every confirmed message delivered")
        missing = sorted(confirmed - set(deliveries))
        if missing:
            violations.append(
                f"confirmed-but-lost: {len(missing)} messages "
                f"(first: {[m.decode() for m in missing[:5]]})")
        duplicates = sum(n - 1 for n in deliveries.values() if n > 1)

        # -- the hard invariants on the accountant itself
        if flow.peak_total > flow.hard_limit:
            violations.append(
                f"accounted peak {flow.peak_total} exceeded the hard "
                f"limit {flow.hard_limit}")
        await wait_for(lambda: flow.total <= flow.low_watermark, 10,
                       "accounted total back at/below the low watermark")
        if broker.metrics.flow_publishes_refused == 0:
            violations.append("no publish was ever refused")
        if refusals_seen == 0:
            violations.append("the flooder never observed a 406 refusal")

        # -- exact alert firings: memory-pressure and nothing else
        snapshot = svc.engine.snapshot()
        fired = tuple(snapshot["fired_rules"])
        if fired != OVERLOAD_ALERT_RULES:
            violations.append(
                f"alert firings not exact: expected {OVERLOAD_ALERT_RULES}, "
                f"got {fired}")
        if snapshot["firing"]:
            violations.append(
                f"alerts still firing after recovery: "
                f"{[i['rule'] for i in snapshot['firing']]}")

        # -- the event-bus/SLO demo assertions: the consumer saw the
        #    escalation, the alert and the burn; the budget drew down;
        #    the burn cleared once the post-recovery ticks went ready
        slo_snap = svc.slo.snapshot()
        slo_budget = slo_snap["slos"][0]["budget_remaining"]
        required_events = (
            "flow.stage.4",                       # ladder hit refuse
            "alert.fired.memory-pressure",
            "slo.burn-rate.readiness",
        )
        deadline = asyncio.get_event_loop().time() + 10
        while (not all(ev in observed_events for ev in required_events)
               and asyncio.get_event_loop().time() < deadline):
            await asyncio.sleep(0.05)
        event_stream_ok = True
        for ev in required_events:
            if ev not in observed_events:
                event_stream_ok = False
                violations.append(
                    f"event-bus consumer never saw {ev!r} "
                    f"(got {observed_events})")
        if slo_budget >= 1.0:
            violations.append(
                f"slo budget never drew down: {slo_budget}")
        if slo_snap["firing"]:
            violations.append(
                f"slo pairs still burning after recovery: "
                f"{[f['slo'] + ':' + f['pair'] for f in slo_snap['firing']]}")
        if slo_snap["fired_total"] < 2 or slo_snap["cleared_total"] \
                != slo_snap["fired_total"]:
            violations.append(
                f"slo burn/clear not exact: fired={slo_snap['fired_total']} "
                f"cleared={slo_snap['cleared_total']} (want both pairs "
                f"fired and cleared)")

        m = broker.metrics
        return {
            "seed": seed,
            "fingerprint": fingerprint,
            "messages": messages,
            "confirmed": len(confirmed),
            "delivered_unique": len(set(deliveries) & confirmed),
            "duplicates": duplicates,
            "drained_under_refuse": drained_under_refuse[1],
            "peak_accounted_bytes": flow.peak_total,
            "hard_limit": flow.hard_limit,
            "under_hard_limit": flow.peak_total <= flow.hard_limit,
            "refuse_stage_total_bytes": stage4_total,
            "final_stage": flow.stage,
            "final_total_bytes": flow.total,
            "low_watermark": flow.low_watermark,
            "publishes_refused": m.flow_publishes_refused,
            "refusal_channel_closes": refusals_seen,
            "paged_bodies": m.flow_paged_bodies,
            "paged_bytes": m.flow_paged_bytes,
            "flow_throttles": m.flow_throttles,
            "flow_resumes": m.flow_resumes,
            "escalations": m.flow_escalations,
            "deescalations": m.flow_deescalations,
            "chaos_pressure_ticks": m.chaos_pressure,
            "throttle_latency_s": round(
                throttle_t.get("end", 0.0) - throttle_t["start"], 3)
                if "start" in throttle_t and "end" in throttle_t else None,
            "hold_wait_ms": round(m.flow_hold_wait_ns / 1e6, 3),
            "hold_releases": m.flow_hold_releases,
            "health_mid": {"ready": health_mid["ready"],
                           "stage": health_mid["checks"]
                           ["memory_pressure"]["stage_label"]},
            "health_end": {"ready": health_end["ready"]},
            "alerts": {"fired_rules": list(fired),
                       "fired_total": snapshot["fired_total"],
                       "resolved_total": snapshot["resolved_total"]},
            "events": {"observed": observed_events,
                       "event_stream_ok": event_stream_ok,
                       "published": m.events_published_total,
                       "dropped": m.events_dropped_total},
            "slo": {"budget_remaining": slo_budget,
                    "fired_total": slo_snap["fired_total"],
                    "cleared_total": slo_snap["cleared_total"],
                    "slo_burned": slo_budget < 1.0},
            "chaos": runtime.status(),
            "violations": violations,
        }
    finally:
        from .. import events as events_mod
        events_mod.install(None)
        clear()
        for conn in conns:
            try:
                await conn.close()
            except Exception:
                pass
        try:
            await srv.stop()
        except Exception:
            pass


# -- predictive-control spike soak -----------------------------------------

# seeded burst ramp: doubling bursts guarantee the two in-flight bursts
# after the reactive throttle crossing (the "frames already on the wire"
# lag) dwarf the refuse-enter gap, so the uncontrolled run always lands
# at the refuse stage while the pre-armed run stops two bursts earlier
# and peaks inside the throttle band — for every seed's +/-10% jitter.
_CTRL_BURSTS = 7
_CTRL_BURST_BASE = 12 * 1024
_CTRL_SPIKE_TICKS = 10
_CTRL_BURST_LAG = 2          # bursts that still land after a stop decision
_CTRL_BODY_PAD = 1024        # + 8-byte tag = 1032 accounted bytes/message
_CTRL_PRE = 32               # confirmed publishes before the spike
_CTRL_POST = 8               # confirmed publishes after recovery
_CTRL_PROBES = 3             # refusal-probe publishes at the peak
_CTRL_CREDIT = 16 * 1024     # publish credit the pre-arm must shrink/restore


def control_spike_sizes(seed: int) -> list[int]:
    """The seeded injection schedule: a doubling ramp with +/-10% jitter.
    Pure function of the seed — both on-runs replay it identically."""
    import random
    rng = random.Random(seed)
    sizes = []
    for i in range(_CTRL_BURSTS):
        sizes.append(int(_CTRL_BURST_BASE * (2 ** i) * rng.uniform(0.9, 1.1)))
    return sizes


async def _control_spike_run(seed: int, mode: str,
                             device: str = "cuda") -> dict:
    """One seeded spike episode. mode: "off" (no control plane), "on"
    (control applying decisions), "dry" (control logging but provably
    mutating nothing). Returns a report with per-run violations plus the
    raw decision-log bytes for cross-run comparison."""
    from ..amqp.properties import BasicProperties
    from ..broker.broker import Broker
    from ..broker.server import BrokerServer
    from ..client.client import AMQPClient
    from ..control import ControlService
    from ..flow import STAGE_THROTTLE
    from ..store.memory import MemoryStore
    from ..telemetry import TelemetryService
    from ..telemetry.alerts import default_rules as alert_defaults

    broker = Broker(
        store=MemoryStore(),
        # no background sweeps: accounting moves only on the synchronous
        # publish/ack path, so the gate-total series (and therefore the
        # decision log) is a pure function of the seed
        message_sweep_interval_s=3600.0,
        # keep every body resident (no passivation, pager opted out): the
        # spike must confront the admission ladder head-on, not drain
        # into the store through the stage-1 pager mid-ramp
        queue_max_resident=1_000_000,
        flow_page_resident=0,
        flow_high_watermark=256 * 1024,
        flow_refuse_watermark=700 * 1024,
        flow_hard_limit=4 * 1024 * 1024,
        flow_publish_credit=_CTRL_CREDIT,
        flow_consumer_buffer=4 * 1024 * 1024,
        router_device=device,
    )
    flow = broker.flow
    srv = BrokerServer(broker=broker, host="127.0.0.1", port=0,
                       heartbeat_s=0)
    # harness-ticked telemetry (the control plane reads its ring); every
    # alert threshold is unreachable so firings can't vary the run
    broker.telemetry = TelemetryService(
        broker, interval_s=1.0, ring_ticks=64,
        rules=alert_defaults(backlog_growth=1e12, stall_ticks=10**6,
                             repl_lag=1e12, loop_lag_ms=1e12,
                             memory_stage=1e12))
    svc = broker.telemetry

    control = None
    if mode != "off":
        control = ControlService(
            broker, interval_s=1.0, dry_run=(mode == "dry"),
            admission=True, rebalance=False, prefetch=False,
            horizon_s=12.0, arm_ticks=2, cooldown_s=6.0,
            credit_factor=0.5, credit_min=4096, log_size=512)

    max_stage = {"v": 0}
    flow.listeners.append(
        lambda old, new: max_stage.__setitem__("v", max(max_stage["v"], new)))

    violations: list[str] = []
    conns: list = []
    qn = "ctrl_q"
    pad = b"x" * _CTRL_BODY_PAD
    msg_bytes = _CTRL_BODY_PAD + 8
    props = BasicProperties()
    deliveries: dict[bytes, int] = {}
    floor_max = 0

    async def wait_for(predicate, timeout: float, what: str) -> bool:
        deadline = asyncio.get_event_loop().time() + timeout
        while not predicate():
            if asyncio.get_event_loop().time() > deadline:
                violations.append(f"[{mode}] timeout waiting for {what}")
                return False
            await asyncio.sleep(0.01)
        return True

    try:
        await srv.start()

        # -- pre-phase: a confirmed baseline backlog (the zero-loss set)
        p1 = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        conns.append(p1)
        p1_ch = await p1.channel()
        await p1_ch.confirm_select()
        await p1_ch.queue_declare(qn)
        for i in range(_CTRL_PRE):
            p1_ch.basic_publish(b"p1-%05d" % i + pad, routing_key=qn)
        await p1_ch.wait_unconfirmed_below(1, timeout=15)
        confirmed: set[bytes] = {b"p1-%05d" % i for i in range(_CTRL_PRE)}

        # -- spike: seeded doubling bursts, injected synchronously so the
        # accountant sees the exact same byte series every run. The
        # injector stops once it observes stage >= THROTTLE at a tick
        # start, but the next _CTRL_BURST_LAG bursts still land — the
        # in-flight frames a real publisher has already sent. The earlier
        # the ladder throttles, the lower the peak: that delta is what
        # separates the pre-armed run from the reactive one.
        sizes = control_spike_sizes(seed)
        injected = 0
        stop_tick = None
        for t in range(_CTRL_SPIKE_TICKS):
            if stop_tick is None and flow.stage >= STAGE_THROTTLE:
                stop_tick = t
            if t < len(sizes) and (stop_tick is None
                                   or t < stop_tick + _CTRL_BURST_LAG):
                for _ in range(max(1, sizes[t] // msg_bytes)):
                    routed, _ = broker.publish_sync(
                        "/", "", qn, props, b"inj-%04d" % injected + pad)
                    if not routed:
                        violations.append(f"[{mode}] injected publish "
                                          f"{injected} not routed")
                    injected += 1
            svc.sample_tick(1.0)
            if control is not None:
                await control.step(1.0)
                floor_max = max(floor_max, flow.floor)
            await asyncio.sleep(0.01)
        spike_peak = flow.peak_total

        # -- refusal probe at the peak: an uncontrolled run sits at the
        # refuse stage (406 channel close); a pre-armed run sits at the
        # throttle floor and accepts the probe under the shrunk credit
        pb = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        conns.append(pb)
        pb_ch = await pb.channel()
        for i in range(_CTRL_PROBES):
            try:
                pb_ch.basic_publish(b"pb-%05d" % i + pad, routing_key=qn)
            except Exception:
                break  # channel already closed by a 406
        if mode == "on":
            await asyncio.sleep(0.3)
            if broker.metrics.flow_publishes_refused:
                violations.append(
                    f"[{mode}] pre-armed run refused "
                    f"{broker.metrics.flow_publishes_refused} publishes")
        else:
            await wait_for(
                lambda: broker.metrics.flow_publishes_refused > 0, 10,
                "a refused publish at the uncontrolled peak")

        # -- drain: consumer attaches, backlog empties to a quiescent gate
        c_conn = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        conns.append(c_conn)
        c_ch = await c_conn.channel()
        await c_ch.basic_qos(prefetch_count=64)

        def on_msg(msg):
            deliveries[bytes(msg.body[:8])] = \
                deliveries.get(bytes(msg.body[:8]), 0) + 1
            c_ch.basic_ack(msg.delivery_tag)

        await c_ch.basic_consume(qn, on_msg, consumer_tag="ctrl")
        await wait_for(lambda: flow.components.get("bodies", 0) == 0, 30,
                       "full backlog drain")

        # -- recovery: at the quiescent barrier (gate total is exactly 0,
        # so the relax inputs are identical every run) tick the control
        # plane until the engine disarms — the relax decision
        if control is not None:
            for _ in range(10):
                if not control.engine.snapshot()["armed"]:
                    break
                await control.step(1.0)
                floor_max = max(floor_max, flow.floor)
            if control.engine.snapshot()["armed"]:
                violations.append(f"[{mode}] engine never disarmed at the "
                                  f"quiescent barrier")
        await wait_for(lambda: flow.stage == 0, 15,
                       "stage-0 recovery after the drain")
        await wait_for(lambda: p1_ch.flow_events == [False, True], 10,
                       "channel.flow stop/resume pair on the publisher")

        # -- post-phase: confirms flow again after the episode
        for i in range(_CTRL_POST):
            p1_ch.basic_publish(b"p1-%05d" % (_CTRL_PRE + i) + pad,
                                routing_key=qn)
        await p1_ch.wait_unconfirmed_below(1, timeout=15)
        confirmed |= {b"p1-%05d" % (_CTRL_PRE + i)
                      for i in range(_CTRL_POST)}
        await wait_for(lambda: confirmed <= set(deliveries), 30,
                       "every confirmed message delivered")
        missing = sorted(confirmed - set(deliveries))
        if missing:
            violations.append(
                f"[{mode}] confirmed-but-lost: {len(missing)} messages "
                f"(first: {[m.decode() for m in missing[:5]]})")
        if flow.peak_total > flow.hard_limit:
            violations.append(
                f"[{mode}] accounted peak {flow.peak_total} exceeded the "
                f"hard limit {flow.hard_limit}")

        m = broker.metrics
        return {
            "mode": mode,
            "seed": seed,
            "injected": injected,
            "max_stage": max_stage["v"],
            "spike_peak_bytes": spike_peak,
            "peak_bytes": flow.peak_total,
            "publishes_refused": m.flow_publishes_refused,
            "decisions": m.control_decisions,
            "applied": m.control_applied,
            "suppressed": m.control_suppressed,
            "dry_runs": m.control_dry_run,
            "control_errors": m.control_errors,
            "floor_max": floor_max,
            "floor_end": flow.floor,
            "credit_end": broker.flow_publish_credit,
            "confirmed": len(confirmed),
            "delivered_unique": len(set(deliveries) & confirmed),
            "log_bytes": (control.decision_log_bytes()
                          if control is not None else b""),
            "violations": violations,
        }
    finally:
        if control is not None:
            try:
                await control.stop()
            except Exception:
                pass
        for conn in conns:
            try:
                await conn.close()
            except Exception:
                pass
        try:
            await srv.stop()
        except Exception:
            pass


async def run_control_soak(seed: int, *, device: str = "cuda") -> dict:
    """Predictive-control spike soak: the same seeded byte-for-byte burst
    ramp is replayed four times — uncontrolled, controlled, controlled
    again (same seed), and dry-run — and the runs are compared. The
    report's ``violations`` list is empty iff:

    1. **The pre-armed run beats the reactive ladder** — strictly lower
       maximum flow stage and strictly fewer refused publishes than the
       uncontrolled run (which must actually reach the refuse stage, or
       the spike proved nothing).
    2. **Zero confirmed-message loss in every run.**
    3. **The decision log is deterministic** — the two same-seed
       controlled runs serialize byte-identically, and non-trivially
       (at least pre-arm + relax).
    4. **Dry-run mutates nothing** — decisions are logged and counted,
       but the stage floor never moves, the publish credit is untouched,
       nothing is applied, and the broker behaves exactly like the
       uncontrolled run (same max stage, refusals still happen).
    """
    import hashlib

    off = await _control_spike_run(seed, "off", device)
    on = await _control_spike_run(seed, "on", device)
    on2 = await _control_spike_run(seed, "on", device)
    dry = await _control_spike_run(seed, "dry", device)

    violations: list[str] = []
    for run in (off, on, on2, dry):
        violations.extend(run.pop("violations"))

    from ..flow import STAGE_REFUSE, STAGE_THROTTLE
    if off["publishes_refused"] == 0 or off["max_stage"] < STAGE_REFUSE:
        violations.append(
            f"uncontrolled run never hit the refuse stage "
            f"(max_stage={off['max_stage']}, "
            f"refused={off['publishes_refused']})")
    for run in (on, on2):
        if run["max_stage"] >= off["max_stage"]:
            violations.append(
                f"pre-armed max stage {run['max_stage']} not strictly "
                f"below uncontrolled {off['max_stage']}")
        if run["publishes_refused"] >= max(1, off["publishes_refused"]):
            violations.append(
                f"pre-armed run refused {run['publishes_refused']} "
                f"publishes (uncontrolled: {off['publishes_refused']})")
        if run["max_stage"] > STAGE_THROTTLE:
            violations.append(
                f"pre-armed run escalated past the throttle floor "
                f"(max_stage={run['max_stage']})")
        if run["applied"] < 2:
            violations.append(
                f"controlled run applied only {run['applied']} decisions "
                f"(expected pre-arm + relax)")
        if run["floor_end"] != 0 or run["credit_end"] != _CTRL_CREDIT:
            violations.append(
                f"relax did not restore state: floor={run['floor_end']} "
                f"credit={run['credit_end']}")
    if not on["log_bytes"]:
        violations.append("controlled run produced an empty decision log")
    if on["log_bytes"] != on2["log_bytes"]:
        violations.append(
            "same-seed decision logs differ between controlled runs")
    if dry["decisions"] < 1 or dry["dry_runs"] < 1:
        violations.append("dry-run logged no decisions")
    if dry["applied"] != 0:
        violations.append(
            f"dry-run applied {dry['applied']} decisions")
    if dry["floor_max"] != 0:
        violations.append(
            f"dry-run moved the stage floor (floor_max={dry['floor_max']})")
    if dry["credit_end"] != _CTRL_CREDIT:
        violations.append(
            f"dry-run changed the publish credit ({dry['credit_end']})")
    if dry["max_stage"] != off["max_stage"] or dry["publishes_refused"] == 0:
        violations.append(
            f"dry-run behavior diverged from uncontrolled "
            f"(max_stage={dry['max_stage']} vs {off['max_stage']}, "
            f"refused={dry['publishes_refused']})")

    def digest(run: dict) -> None:
        raw = run.pop("log_bytes")
        run["log_sha256"] = hashlib.sha256(raw).hexdigest()
        run["log_len"] = len(raw)

    for run in (off, on, on2, dry):
        digest(run)
    return {
        "seed": seed,
        "sizes": control_spike_sizes(seed),
        "off": off,
        "on": on,
        "on_repeat": on2,
        "dry": dry,
        "violations": violations,
    }


async def run_connection_churn(cycles: int = 500, *,
                               bodies_per_cycle: int = 3,
                               body_bytes: int = 2048,
                               device: str = "cuda") -> dict:
    """Connection-churn leak check: `cycles` connect / declare-exclusive /
    publish-confirmed / disconnect rounds (every other one an abrupt
    socket abort instead of a clean Connection.Close), then assert the
    memory accountant is back to zero — the exclusive queues die with
    their connections, so any surviving accounted byte is a leak in the
    hold/release or queue-teardown accounting."""
    from ..broker.broker import Broker
    from ..broker.server import BrokerServer
    from ..client.client import AMQPClient
    from ..store.memory import MemoryStore

    broker = Broker(store=MemoryStore(), queue_max_resident=64,
                    message_sweep_interval_s=0.05,
                    flow_high_watermark=64 * 1024,
                    router_device=device)
    flow = broker.flow
    srv = BrokerServer(broker=broker, host="127.0.0.1", port=0,
                       heartbeat_s=0)
    violations: list[str] = []
    body = b"c" * body_bytes
    aborted = 0
    try:
        await srv.start()
        for i in range(cycles):
            conn = await AMQPClient.connect("127.0.0.1", srv.bound_port)
            try:
                ch = await conn.channel()
                await ch.confirm_select()
                qn = f"churn_{i}"
                await ch.queue_declare(qn, exclusive=True)
                for _ in range(bodies_per_cycle):
                    ch.basic_publish(body, routing_key=qn)
                await ch.wait_unconfirmed_below(1, timeout=10)
                if i % 2:
                    # abrupt death: no Connection.Close — teardown
                    # accounting must still release everything
                    try:
                        conn.reader._transport.abort()
                        aborted += 1
                    except Exception:
                        await conn.close()
                else:
                    await conn.close()
            except Exception as exc:
                violations.append(f"cycle {i}: {type(exc).__name__}: {exc}")
                try:
                    await conn.close()
                except Exception:
                    pass
                break

        deadline = asyncio.get_event_loop().time() + 15
        while broker.connections and \
                asyncio.get_event_loop().time() < deadline:
            await asyncio.sleep(0.02)
        if broker.connections:
            violations.append(
                f"{len(broker.connections)} connection(s) never torn down")
        # a couple of sweep ticks so the polled components resample
        await asyncio.sleep(0.15)

        leaked = broker.resident_bytes + broker.held_bytes
        if leaked:
            violations.append(
                f"accounted-bytes leak after churn: resident="
                f"{broker.resident_bytes} held={broker.held_bytes}")
        live_queues = sum(len(v.queues) for v in broker.vhosts.values())
        if live_queues:
            violations.append(
                f"{live_queues} exclusive queue(s) survived their "
                f"connections")
        gate_components = {
            k: v for k, v in flow.components.items()
            if k in ("bodies", "held") and v}
        if gate_components:
            violations.append(
                f"flow accountant still charged after churn: "
                f"{gate_components}")
        return {
            "cycles": cycles,
            "aborted": aborted,
            "bodies_per_cycle": bodies_per_cycle,
            "body_bytes": body_bytes,
            "leaked_bytes": leaked,
            "final_total_bytes": flow.total,
            "peak_accounted_bytes": flow.peak_total,
            "final_stage": flow.stage,
            "live_queues": sum(len(v.queues) for v in broker.vhosts.values()),
            "violations": violations,
        }
    finally:
        try:
            await srv.stop()
        except Exception:
            pass


async def _alert_phase(srv, cl, violations: list[str]) -> dict:
    """Invariant 6b: drive the surviving node's telemetry through a
    scripted backlog (publish with no consumer -> backlog-growth) and a
    stalled consumer (prefetch 1, never acks -> consumer-stall), ticking
    the sampler by hand. The engine's input is then a pure function of
    the workload, so the set of fired rules must match
    EXPECTED_ALERT_RULES exactly — no more, no fewer.

    Invariant 6c (event bus): a plain AMQP consumer bound ``alert.#`` +
    ``lifecycle.#`` on ``amq.chanamq.event`` must receive exactly the
    engine's fire/resolve transitions as messages — same rules, same
    order — and zero lifecycle events (nothing drains in this soak).
    Deterministic mod the wall-clock ``ts`` stamp in each body."""
    import json as json_mod

    from .. import events as events_mod
    from ..client.client import AMQPClient

    svc = srv.broker.telemetry
    aq = next(f"ca{i}" for i in range(200)
              if cl.queue_owner("/", f"ca{i}") == cl.name)
    eq = next(f"ce{i}" for i in range(200)
              if cl.queue_owner("/", f"ce{i}") == cl.name)
    conn = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    bus_events: list[dict] = []
    try:
        ch = await conn.channel()
        await ch.confirm_select()
        await ch.queue_declare(aq)

        # event consumer FIRST, bus installed after its own connection
        # setup so the collected stream starts exactly at the phase start
        e_ch = await conn.channel()
        await e_ch.queue_declare(eq)
        await e_ch.queue_bind(eq, "amq.chanamq.event", "alert.#")
        await e_ch.queue_bind(eq, "amq.chanamq.event", "lifecycle.#")

        def on_event(msg):
            bus_events.append(json_mod.loads(bytes(msg.body)))
            e_ch.basic_ack(msg.delivery_tag)

        await e_ch.basic_consume(eq, on_event, consumer_tag="soak-events")
        events_mod.install(events_mod.EventBus(srv.broker))

        # baseline tick: the queue's ring slot needs one pre-backlog
        # sample for the growth window to measure against
        svc.sample_tick(1.0)
        for i in range(120):
            ch.basic_publish(f"a{i:04d}".encode(), routing_key=aq)
        await ch.wait_unconfirmed_below(1, timeout=15)
        # two post-backlog ticks: +120 depth inside the 5-tick window on
        # both -> breach streak reaches for_ticks=2 -> backlog-growth fires
        svc.sample_tick(1.0)
        svc.sample_tick(1.0)

        # stalled consumer: prefetch 1, never acks. The first delivery
        # lands before the next tick (deliver_rate blips once), then the
        # queue has depth > 0, consumers > 0 and zero deliver rate for
        # stall_ticks=3 straight ticks -> consumer-stall fires
        first = asyncio.Event()
        await ch.basic_qos(prefetch_count=1)
        await ch.basic_consume(aq, lambda msg: first.set(),
                               consumer_tag="stalled")
        await asyncio.wait_for(first.wait(), 10)
        for _ in range(4):
            svc.sample_tick(1.0)

        snapshot = svc.engine.snapshot()
        fired = tuple(snapshot["fired_rules"])
        if fired != EXPECTED_ALERT_RULES:
            violations.append(
                f"alert firings not exact: expected {EXPECTED_ALERT_RULES}, "
                f"got {fired}")

        # invariant 6c: the consumed event stream mirrors the engine's own
        # transition history exactly (order and rules), with no lifecycle
        # noise. Emits are synchronous at the tick; only the AMQP delivery
        # to our consumer is async, so give it a bounded settle window.
        expected_stream = [
            ("fired" if ev["event"] == "fired" else "cleared", ev["rule"])
            for ev in svc.engine.history]
        deadline = asyncio.get_event_loop().time() + 10
        while (len(bus_events) < len(expected_stream)
               and asyncio.get_event_loop().time() < deadline):
            await asyncio.sleep(0.05)
        got_stream = [tuple(ev["event"].split(".", 1)[-1].split(".", 1))
                      if ev["event"].startswith("alert.")
                      else ("lifecycle", ev["event"])
                      for ev in bus_events]
        lifecycle_seen = [ev["event"] for ev in bus_events
                          if ev["event"].startswith("lifecycle.")]
        if lifecycle_seen:
            violations.append(
                f"unexpected lifecycle events on the bus: {lifecycle_seen}")
        if got_stream != expected_stream:
            violations.append(
                f"event-bus alert stream mismatch: expected "
                f"{expected_stream}, got {got_stream}")
        return {
            "queue": aq,
            "fired_rules": list(fired),
            "fired_total": snapshot["fired_total"],
            "resolved_total": snapshot["resolved_total"],
            "firing_now": [
                f"{i['rule']}:{i['entity']}" for i in snapshot["firing"]],
            "bus_events": [ev["event"] for ev in bus_events],
            "bus_stream_exact": got_stream == expected_stream,
        }
    finally:
        events_mod.install(None)
        try:
            await conn.close()
        except Exception:
            pass


async def _elastic_run(seed: int, device: str = "cuda") -> dict:
    """One elasticity episode: 3-node cluster + joiner, join-triggered
    rebalance, graceful drain, kill -9 mid-drain, and a fenced stale
    owner — all on PRIVATE per-node stores. Returns a report plus the
    normalized decision/evacuation log bytes for same-seed comparison."""
    import hashlib

    from ..amqp.properties import BasicProperties
    from ..client.client import AMQPClient
    from ..broker.broker import Broker
    from ..broker.server import BrokerServer
    from ..cluster.membership import LEFT
    from ..cluster.node import ClusterNode
    from ..control import ControlService
    from ..store.memory import MemoryStore
    from ..telemetry import TelemetryService
    from ..telemetry.alerts import default_rules as alert_defaults

    # node names are host:port and feed the hash ring, so every placement
    # choice (follower sets, evacuation targets, promotion winners) is a
    # function of the ports. Ephemeral ports would make same-seed runs
    # diverge; fixed seed-derived ports (below the 32768+ ephemeral range)
    # make the whole episode replayable byte-for-byte. Only the cluster
    # RPC port matters — the AMQP listener stays ephemeral.
    cluster_base = 23000 + (seed % 512) * 8

    async def start_node(seeds, port):
        # flow ladder present (the control plane projects against it) but
        # with watermarks far above the workload: stage stays 0 throughout
        broker = Broker(store=MemoryStore(),
                        flow_high_watermark=1 << 40,
                        flow_hard_limit=1 << 42,
                        router_device=device)
        srv = BrokerServer(broker=broker, host="127.0.0.1", port=0,
                           heartbeat_s=0)
        await srv.start()
        cl = ClusterNode(srv.broker, "127.0.0.1", port, seeds,
                         heartbeat_interval_s=0.2, failure_timeout_s=1.5,
                         replicate_factor=2, replicate_sync=True,
                         replicate_ack_timeout_ms=2000,
                         drain_budget_s=20.0)
        await cl.start()
        return srv, cl

    async def until(predicate, timeout, what):
        deadline = asyncio.get_event_loop().time() + timeout
        while not predicate():
            if asyncio.get_event_loop().time() > deadline:
                violations.append(f"timeout waiting for {what}")
                return False
            await asyncio.sleep(0.05)
        return True

    persistent = BasicProperties(delivery_mode=2)
    violations: list[str] = []
    conns: list = []
    a_srv = a_cl = b_srv = b_cl = c_srv = c_cl = d_srv = d_cl = None
    control = None
    try:
        a_srv, a_cl = await start_node([], cluster_base)
        b_srv, b_cl = await start_node([a_cl.name], cluster_base + 1)
        c_srv, c_cl = await start_node([a_cl.name], cluster_base + 2)
        await until(
            lambda: all(len(cl.membership.alive_members()) == 3
                        for cl in (a_cl, b_cl, c_cl)),
            10, "3-node membership")

        # -- queue placement, pinned by role so same-seed runs make the
        #    same logical decisions despite ephemeral node names
        def placed(ring, prefix, *roles):
            want = [cl.name for cl in roles]
            return next(
                f"{prefix}{i}" for i in range(4000)
                if ring.preference_entity(
                    "q", "/", f"{prefix}{i}", len(want))[:len(want)] == want)

        eq = [placed(a_cl.ring, f"eq{j}x", a_cl, b_cl) for j in range(3)]
        cq = [placed(a_cl.ring, f"cq{j}x", c_cl, b_cl) for j in range(2)]

        # -- control plane on A, harness-stepped (no timers): tick 1 now
        #    so the join observed later counts as elasticity, not boot.
        #    The eq queues are declared BEFORE the first sample so tick 2
        #    sees real publish-rate deltas (a queue's first sample
        #    baselines its counters at zero rate)
        a_srv.broker.telemetry = TelemetryService(
            a_srv.broker, interval_s=1.0, ring_ticks=64,
            rules=alert_defaults(
                backlog_growth=1e12, stall_ticks=10**6, repl_lag=1e12,
                loop_lag_ms=1e12, memory_stage=1e12))
        control = ControlService(
            a_srv.broker, interval_s=1.0, dry_run=False,
            admission=False, rebalance=True, prefetch=False)
        decl = await AMQPClient.connect("127.0.0.1", a_srv.bound_port)
        conns.append(decl)
        decl_ch = await decl.channel()
        for qname in eq:
            await decl_ch.queue_declare(qname, durable=True)
        await decl.close()
        a_srv.broker.telemetry.sample_tick(1.0)
        await control.step(1.0)

        # -- confirmed backlog (the zero-loss set); body length is fixed
        #    so byte-counters (and the load EWMA in the decision log) are
        #    a pure function of message COUNTS, not of searched names
        confirmed: dict[str, set] = {}
        mseq = 0

        async def fill(srv, qname, count):
            nonlocal mseq
            conn = await AMQPClient.connect("127.0.0.1", srv.bound_port)
            conns.append(conn)
            ch = await conn.channel()
            await ch.confirm_select()
            await ch.queue_declare(qname, durable=True)
            bodies = set()
            for _ in range(count):
                body = b"m%06d" % mseq
                mseq += 1
                ch.basic_publish(body, routing_key=qname,
                                 properties=persistent)
                bodies.add(body.decode())
            await ch.wait_unconfirmed_below(1, timeout=20)
            confirmed[qname] = bodies
            await conn.close()

        # distinct per-queue rates make the engine's busiest-queue pick
        # unambiguous: eq[0] is always the join-seeding move
        await fill(a_srv, eq[0], 30)
        await fill(a_srv, eq[1], 20)
        await fill(a_srv, eq[2], 10)
        await fill(c_srv, cq[0], 12)
        await fill(c_srv, cq[1], 12)

        # -- crash plan: drain.tick fires once per evacuation attempt;
        #    A's drain burns invocations 1-2 (eq[1], eq[2] — eq[0] will
        #    have moved to the joiner), C's drain hits 3 (cq[0]) and the
        #    crash lands on 4: C dies holding cq[1], half-drained
        plan = FaultPlan(seed, [
            FaultRule(name="kill-during-drain", kind="crash",
                      sites=["drain.tick"], after=3, count=1,
                      nodes=["victim"]),
        ])
        runtime = install(plan, metrics=b_srv.broker.metrics)
        fingerprint = plan.fingerprint()
        crashed = asyncio.Event()

        def crash_victim() -> None:
            crashed.set()
            task = c_cl.lifecycle._task
            if task is not None:
                task.cancel()  # deterministic: cq[1] never hands off

            async def _die():
                for part in (c_cl, c_srv):
                    try:
                        await part.stop()
                    except Exception:
                        pass
            asyncio.get_event_loop().create_task(_die())

        runtime.on_crash("victim", crash_victim)

        # -- phase: join. D comes up; the control plane seeds it with the
        #    busiest movable queue through the normal holdership machinery
        d_srv, d_cl = await start_node([a_cl.name], cluster_base + 3)
        await until(
            lambda: all(len(cl.membership.alive_members()) == 4
                        for cl in (a_cl, b_cl, c_cl, d_cl)),
            10, "4-node membership")
        a_srv.broker.telemetry.sample_tick(1.0)
        control.note_member_join(d_cl.name)
        decisions = await control.step(1.0)
        join_moves = [d for d in decisions
                      if d["kind"] == "rebalance.move"
                      and d["action"].get("join")]
        if len(join_moves) != 1:
            violations.append(
                f"expected exactly 1 join-rebalance decision, "
                f"saw {len(join_moves)}")
        elif join_moves[0]["action"]["name"] != eq[0] \
                or join_moves[0]["action"]["target"] != d_cl.name:
            violations.append(
                f"join move picked {join_moves[0]['action']} "
                f"(wanted busiest {eq[0]} -> joiner)")
        await until(
            lambda: d_cl.queue_metas.get(("/", eq[0]), {}).get("holder")
            == d_cl.name and eq[0] in d_srv.broker.vhosts["/"].queues,
            10, "join move to materialize on the joiner")

        # fencing-phase queue: owned by B with its replica on the joiner,
        # declared on the 4-node ring so the follower really is D
        fq = placed(b_cl.ring, "fqx", b_cl, d_cl)
        await fill(b_srv, fq, 8)

        # -- phase: graceful drain of A (zero-loss evacuation, then LEFT)
        a_cl.lifecycle.drain()
        a_report = await a_cl.lifecycle.wait(30)
        if a_report["state"] != "drained" or a_report["queues_moved"] != 2 \
                or a_report["failed"] or a_report["pinned"]:
            violations.append(f"drain of A did not complete: {a_report}")
        await until(
            lambda: b_cl.membership.lifecycle_of(a_cl.name) == LEFT
            and d_cl.membership.lifecycle_of(a_cl.name) == LEFT,
            10, "A's `left` state to gossip")
        if a_cl.name in b_cl.membership.placement_members():
            violations.append("left node still placement-eligible on B")

        # -- phase: kill -9 mid-drain. C evacuates cq[0], dies before
        #    cq[1]; B (the replica) must promote the remainder
        promotions_before = (a_srv.broker.metrics.repl_promotions
                            + b_srv.broker.metrics.repl_promotions
                            + c_srv.broker.metrics.repl_promotions
                            + d_srv.broker.metrics.repl_promotions)
        c_cl.lifecycle.drain()
        try:
            await c_cl.lifecycle.wait(20)
        except (asyncio.CancelledError, asyncio.TimeoutError):
            pass
        if not crashed.is_set():
            violations.append("kill-during-drain rule never fired")

        # C's drain hands cq[0] to its best-synced replica — after the
        # join reshuffle that can be B (the original follower) or D (the
        # re-picked one); either way it must land on exactly one live node
        def _cq0_landed() -> bool:
            holder = b_cl.queue_metas.get(("/", cq[0]), {}).get("holder")
            if holder == b_cl.name:
                return cq[0] in b_srv.broker.vhosts["/"].queues
            if holder == d_cl.name:
                return cq[0] in d_srv.broker.vhosts["/"].queues
            return False

        await until(_cq0_landed, 10,
                    "evacuated cq[0] to land on a live node (B or D)")
        # the unmoved remainder cq[1] must be promoted by whichever node
        # held its replica when C died (B originally; D after the join
        # reshuffle re-picked followers)
        def _cq1_promoted() -> bool:
            holder = b_cl.queue_metas.get(("/", cq[1]), {}).get("holder")
            if holder == b_cl.name:
                return cq[1] in b_srv.broker.vhosts["/"].queues
            if holder == d_cl.name:
                return cq[1] in d_srv.broker.vhosts["/"].queues
            return False

        await until(_cq1_promoted, 10,
                    "a survivor to promote the unmoved remainder cq[1]")
        failovers = (a_srv.broker.metrics.repl_promotions
                     + b_srv.broker.metrics.repl_promotions
                     + c_srv.broker.metrics.repl_promotions
                     + d_srv.broker.metrics.repl_promotions
                     - promotions_before)
        if failovers != 1:
            violations.append(
                f"expected exactly 1 failover promotion from the "
                f"mid-drain crash, saw {failovers}")

        # -- phase: partition heals into a fenced stale owner. B is
        #    isolated control-plane-wise (heartbeats cancelled, inbound
        #    pings and meta broadcasts fail) while its data plane still
        #    reaches D; D promotes fq and bumps its epoch; B — still
        #    thinking it owns — ships the stale epoch and must be refused.
        #    First let every live follower ack B's log heads: any copy D
        #    promotes during the partition is then content-complete. Acks
        #    piggyback on ships, and a wholesale resync finishes silently
        #    — probe the follower's applied seq like prepare_handoff does
        async def _b_heads_synced() -> bool:
            repl_mgr = b_cl.replication
            for (vhost, name), r in list(repl_mgr._logs.items()):
                for follower, acked in list(r.followers.items()):
                    if not b_cl.membership.is_alive(follower):
                        continue
                    if acked >= r.seq:
                        continue
                    try:
                        reply = await repl_mgr.client_for(follower).call(
                            "repl.probe",
                            {"vhost": vhost, "queue": name,
                             "owner": b_cl.name},
                            timeout_s=1.0)
                        applied = int(reply.get("applied", 0))
                        if applied > acked:
                            r.followers[follower] = applied
                    except Exception:
                        return False
                if r.live_ack_floor() < r.seq:
                    return False
            return True

        sync_deadline = asyncio.get_event_loop().time() + 10
        while not await _b_heads_synced():
            if asyncio.get_event_loop().time() > sync_deadline:
                violations.append(
                    "timeout waiting for B's followers to sync to head "
                    "before the partition")
                break
            await asyncio.sleep(0.05)
        b_mem = b_cl.membership
        if b_mem._task is not None:
            b_mem._task.cancel()
            b_mem._task = None
        # freeze B's anti-entropy too: a pull from D mid-partition would
        # hand it the promoted holdership through the side door and it
        # would stand down before ever shipping a stale epoch
        if b_cl._anti_entropy_task is not None:
            b_cl._anti_entropy_task.cancel()
            b_cl._anti_entropy_task = None

        async def _refuse_rpc(payload):
            raise OSError("isolated for the fencing phase")

        b_cl.rpc.register("cluster.ping", _refuse_rpc)
        b_cl.rpc.register("meta.apply", _refuse_rpc)
        await until(
            lambda: d_cl.queue_metas.get(("/", fq), {}).get("holder")
            == d_cl.name and fq in d_srv.broker.vhosts["/"].queues,
            15, "D to promote fq after B is isolated")
        stale_conn = await AMQPClient.connect("127.0.0.1",
                                              b_srv.bound_port)
        conns.append(stale_conn)
        stale_ch = await stale_conn.channel()
        await stale_ch.confirm_select()
        for i in range(3):
            # stale-owner publishes: B appends locally and ships with its
            # old epoch; confirms must NOT come back (D refuses the ship)
            try:
                await stale_ch.basic_publish_confirmed(
                    b"stale%02d" % i, routing_key=fq,
                    properties=persistent, timeout=1.5)
                violations.append(
                    f"stale owner B got publish {i} confirmed while "
                    f"fenced off")
            except Exception:
                pass
        refusals = d_srv.broker.metrics.lifecycle_stale_epoch_refused
        if refusals < 1:
            violations.append(
                "no stale-epoch ship was refused during the partition")
        # heal: B rejoins, learns the higher-epoch holdership via
        # anti-entropy, and stands down
        b_cl.rpc.register("cluster.ping", b_mem._on_ping)
        b_cl.rpc.register("meta.apply", b_cl._h_meta_apply)
        b_mem._task = asyncio.get_event_loop().create_task(
            b_mem._heartbeat_loop())
        b_cl._anti_entropy_task = asyncio.get_event_loop().create_task(
            b_cl._anti_entropy_loop())
        await until(
            lambda: b_cl.membership.is_alive(d_cl.name)
            and d_cl.membership.is_alive(b_cl.name),
            10, "partition to heal")
        await until(
            lambda: b_cl.queue_metas.get(("/", fq), {}).get("holder")
            == d_cl.name, 10, "healed B to adopt D's fenced holdership")

        # -- quiesce: exactly one live holder per queue, cluster-wide.
        #    Promotions taken while B was dark resolve through the epoch
        #    merge (B stands down on every queue D out-claimed), so give
        #    anti-entropy a bounded window to converge before asserting
        live = [(a_srv, a_cl), (b_srv, b_cl), (d_srv, d_cl)]

        def claimants(qname):
            claims = []
            for srv, cl in live:
                meta = cl.queue_metas.get(("/", qname), {})
                vhost = srv.broker.vhosts.get("/")
                queue = vhost.queues.get(qname) if vhost else None
                if meta.get("holder") == cl.name and queue is not None \
                        and not queue.deleted:
                    claims.append((srv, cl))
            return claims

        everything = eq + cq + [fq]
        await until(
            lambda: all(len(claimants(q)) == 1 for q in everything),
            15, "exactly one live holder per queue at quiesce")
        owners: dict[str, tuple] = {}
        for qname in everything:
            claims = claimants(qname)
            if len(claims) != 1:
                violations.append(
                    f"queue {qname}: {len(claims)} live holders at "
                    f"quiesce (want exactly 1)")
            if claims:
                owners[qname] = claims[0]

        # -- zero confirmed loss: every confirmed body is consumable from
        #    the queue's current holder
        lost = 0
        for qname, bodies in confirmed.items():
            holder = owners.get(qname)
            if holder is None:
                lost += len(bodies)
                continue
            srv, _cl = holder
            got: set = set()
            done = asyncio.Event()
            conn = await AMQPClient.connect("127.0.0.1", srv.bound_port)
            conns.append(conn)
            ch = await conn.channel()
            await ch.basic_qos(prefetch_count=256)

            def on_msg(msg, got=got, want=bodies, done=done, ch=ch):
                got.add(bytes(msg.body).decode())
                ch.basic_ack(msg.delivery_tag)
                if want <= got:
                    done.set()

            await ch.basic_consume(qname, on_msg,
                                   consumer_tag="elastic-verify")
            try:
                await asyncio.wait_for(done.wait(), 10)
            except asyncio.TimeoutError:
                pass
            missing = bodies - got
            if missing:
                lost += len(missing)
                violations.append(
                    f"queue {qname}: {len(missing)} confirmed messages "
                    f"lost (first: {sorted(missing)[:3]})")
            await conn.close()

        # -- stream cursors survive the churn: a stream on B (never
        #    drained, crash-promoted, isolated AND healed) must still
        #    resume contiguously at committed+1
        sq = next(f"esx{i}" for i in range(4000)
                  if b_cl.ring.owner_entity("q", "/", f"esx{i}")
                  == b_cl.name)
        stream = await _stream_cursor_check(b_srv, sq, 30, violations)

        # -- normalized decision/evacuation log: two same-seed runs must
        #    serialize byte-identically once node names and searched queue
        #    names are replaced by their logical roles
        raw = (control.decision_log_bytes() + b"\n"
               + a_cl.lifecycle.evacuation_log_bytes())
        text = raw.decode()
        aliases = [(a_cl.name, "<A>"), (b_cl.name, "<B>"),
                   (c_cl.name, "<C>"), (d_cl.name, "<D>")]
        aliases += [(name, f"<eq{j}>") for j, name in enumerate(eq)]
        aliases += [(name, f"<cq{j}>") for j, name in enumerate(cq)]
        aliases.append((fq, "<fq>"))
        for actual, alias in sorted(aliases, key=lambda kv: -len(kv[0])):
            text = text.replace(actual, alias)
        log_bytes = text.encode()

        metrics_all = [s.broker.metrics for s in (a_srv, b_srv, c_srv,
                                                  d_srv)]
        return {
            "seed": seed,
            "fingerprint": fingerprint,
            "nodes": 4,
            "store": "memory (private per node)",
            "replicate_factor": 2,
            "confirmed": sum(len(v) for v in confirmed.values()),
            "queues": len(eq) + len(cq) + 1,
            "join_moves": len(join_moves),
            "drain_a": a_report,
            "crashed": crashed.is_set(),
            "failover_promotions": failovers,
            "stale_epoch_refused": refusals,
            "evacuated": sum(m.lifecycle_queues_evacuated
                             for m in metrics_all),
            "evacuation_retries": sum(m.lifecycle_evacuation_retries
                                      for m in metrics_all),
            "rollbacks": sum(m.lifecycle_rollbacks for m in metrics_all),
            "join_rebalances": sum(m.lifecycle_join_rebalances
                                   for m in metrics_all),
            "stale_holders_cleared": sum(m.lifecycle_stale_holders_cleared
                                         for m in metrics_all),
            "lost": lost,
            "stream": stream,
            "log_bytes": log_bytes,
            "log_sha256": hashlib.sha256(log_bytes).hexdigest(),
            "violations": violations,
        }
    finally:
        clear()
        if control is not None:
            try:
                await control.stop()
            except Exception:
                pass
        for conn in conns:
            try:
                await conn.close()
            except Exception:
                pass
        for part in (d_cl, d_srv, c_cl, c_srv, b_cl, b_srv, a_cl, a_srv):
            if part is not None:
                try:
                    await part.stop()
                except Exception:
                    pass


async def run_elastic_soak(seed: int, *, device: str = "cuda") -> dict:
    """Elasticity chaos soak (``bench.py --elastic``): the same seeded
    episode — join-triggered rebalance, graceful drain to ``left``,
    kill -9 mid-drain, partition healing into a fenced stale owner — run
    TWICE with the same seed. The report's ``violations`` list is empty
    iff every run held:

    1. **Zero confirmed loss** — every confirm-gated body is consumable
       from its queue's final holder, across a join move, two drains, a
       crash promotion, and a fenced partition.
    2. **Exactly one live holder per queue at quiesce** — no queue ends
       split-brained or orphaned.
    3. **Fencing works** — the healed stale owner's ships were refused
       (``lifecycle_stale_epoch_refused``) and it adopted the
       higher-epoch holdership instead of clobbering it.
    4. **Stream cursors resume contiguously** on the surviving node.
    5. **The decision/evacuation log is deterministic** — the two runs'
       normalized logs compare byte-identical, and non-trivially.
    """
    first = await _elastic_run(seed, device)
    second = await _elastic_run(seed, device)
    violations = list(first.pop("violations"))
    violations.extend(second.pop("violations"))
    log1 = first.pop("log_bytes")
    log2 = second.pop("log_bytes")
    if not log1:
        violations.append("first run produced an empty "
                          "decision/evacuation log")
    if log1 != log2:
        violations.append(
            "same-seed decision/evacuation logs differ between runs")
    return {
        "seed": seed,
        "runs": [first, second],
        "log_sha256": first.get("log_sha256"),
        "violations": violations,
    }


async def _stream_cursor_check(
    srv, sq: str, records: int, violations: list[str]
) -> dict:
    """Invariant 4: publish a stream, ack half under one tag, detach,
    reattach at "next" — deliveries must resume at committed+1 and run
    contiguously to the tail."""
    from ..amqp.properties import BasicProperties
    from ..client.client import AMQPClient

    conn = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    try:
        pch = await conn.channel()
        await pch.confirm_select()
        await pch.queue_declare(
            sq, durable=True, arguments={"x-queue-type": "stream"})
        props = BasicProperties(delivery_mode=2)
        for i in range(records):
            pch.basic_publish(f"s{i:06d}".encode(), routing_key=sq,
                              properties=props)
        await pch.wait_unconfirmed_below(1, timeout=30)

        half = records // 2
        first_leg: list = []
        got_half = asyncio.Event()
        ch1 = await conn.channel()
        await ch1.basic_qos(prefetch_count=records + 8)

        def leg1(msg):
            first_leg.append((msg.delivery_tag, bytes(msg.body).decode()))
            if len(first_leg) == half:
                got_half.set()

        await ch1.basic_consume(
            sq, leg1, consumer_tag="soak-cursor",
            arguments={"x-stream-offset": "first"})
        await asyncio.wait_for(got_half.wait(), 15)
        # commit the cursor through record half-1, then detach
        ch1.basic_ack(first_leg[half - 1][0], multiple=True)
        await asyncio.sleep(0.3)  # let the commit land
        await ch1.basic_cancel("soak-cursor")

        second_leg: list = []
        done = asyncio.Event()
        ch2 = await conn.channel()
        await ch2.basic_qos(prefetch_count=records + 8)

        def leg2(msg):
            second_leg.append(bytes(msg.body).decode())
            if len(second_leg) >= records - half:
                done.set()

        await ch2.basic_consume(
            sq, leg2, consumer_tag="soak-cursor",
            arguments={"x-stream-offset": "next"})
        try:
            await asyncio.wait_for(done.wait(), 15)
        except asyncio.TimeoutError:
            pass
        expected = [f"s{i:06d}" for i in range(half, records)]
        resumed_ok = second_leg[:len(expected)] == expected \
            and len(second_leg) >= len(expected)
        if not resumed_ok:
            violations.append(
                f"stream cursor did not resume contiguously at committed+1 "
                f"(expected s{half:06d}.., got {second_leg[:3]})")
        return {
            "records": records,
            "committed_through": half - 1,
            "resumed_at": second_leg[0] if second_leg else None,
            "contiguous": resumed_ok,
        }
    finally:
        try:
            await conn.close()
        except Exception:
            pass


async def _key_shared_group_check(srv, qname: str, violations: list[str]) -> dict:
    """Invariant 7: a key-shared group member disconnecting with
    deliveries in flight must NOT reorder any key. Its records requeue and
    redeliver to the survivor before any later record of the same keys, so
    the survivor's per-key ack sequence is strictly increasing and the
    group ends complete (every published record acked exactly once)."""
    from ..client.client import AMQPClient

    keys = [f"k{i}" for i in range(4)]
    per_key_records = 6
    total = per_key_records * len(keys)
    group_args = {"x-group": "soak-ks", "x-group-type": "key-shared",
                  "x-stream-offset": "first"}

    pub = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    victim = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    survivor = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    try:
        pch = await pub.channel()
        await pch.queue_declare(
            qname, durable=True, arguments={"x-queue-type": "stream"})
        await pch.exchange_declare(qname + "-x", "fanout")
        await pch.queue_bind(qname, qname + "-x", "")

        # the victim takes a prefetch window and never acks
        vch = await victim.channel()
        await vch.basic_qos(prefetch_count=6)
        victim_held = asyncio.Event()
        victim_got: list = []

        def victim_cb(msg):
            victim_got.append(msg.routing_key)
            if len(victim_got) >= 6:
                victim_held.set()

        await vch.basic_consume(qname, victim_cb, consumer_tag="ks-victim",
                                arguments=dict(group_args))

        sch = await survivor.channel()
        acked: list = []  # (key, seq) in ack order
        complete = asyncio.Event()

        def survivor_cb(msg):
            acked.append((msg.routing_key, int(bytes(msg.body))))
            sch.basic_ack(msg.delivery_tag)
            if len(acked) >= total:
                complete.set()

        await sch.basic_consume(qname, survivor_cb,
                                consumer_tag="ks-survivor",
                                arguments=dict(group_args))

        await pch.confirm_select()
        for seq in range(per_key_records):
            for key in keys:
                pch.basic_publish(str(seq).encode(), exchange=qname + "-x",
                                  routing_key=key)
        await pch.wait_unconfirmed_below(1, timeout=30)
        try:
            await asyncio.wait_for(victim_held.wait(), 15)
        except asyncio.TimeoutError:
            violations.append("key-shared: victim member never saturated "
                              "its prefetch window")
        early = len(acked)  # every key stuck to the victim: should be 0
        await victim.close()  # mid-flight disconnect: requeue + rebalance
        try:
            await asyncio.wait_for(complete.wait(), 15)
        except asyncio.TimeoutError:
            violations.append(
                f"key-shared: survivor drained only {len(acked)}/{total} "
                "records after the member disconnect")
        ordered = True
        per_key: dict[str, list] = {}
        for key, seq in acked:
            per_key.setdefault(key, []).append(seq)
        for key, seqs in per_key.items():
            if seqs != sorted(set(seqs)):
                ordered = False
                violations.append(
                    f"key-shared: key {key} acked out of order after "
                    f"redelivery: {seqs}")
        want = sorted(list(range(per_key_records)) * len(keys))
        if sorted(s for v in per_key.values() for s in v) != want:
            violations.append(
                "key-shared: records lost or duplicated across the "
                "disconnect")
        return {
            "records": total,
            "keys": len(keys),
            "victim_held": len(victim_got),
            "acked_before_disconnect": early,
            "per_key_ordered": ordered,
        }
    finally:
        for conn in (pub, victim, survivor):
            try:
                await conn.close()
            except Exception:
                pass


async def _tenant_run(seed: int, device: str = "cuda") -> dict:
    """One noisy-neighbor episode on a three-tenant node. Returns a report
    plus the normalized tenancy decision-log bytes for same-seed
    comparison (run_tenant_soak runs this twice).

    Cast: ``aggr`` floods past a publish-rate quota (token bucket sized so
    the bucket gates on exactly the 16th publish and each registry tick
    refills exactly 8 publishes' worth of tokens); ``vict`` has no quota
    and must see clean paced latency, an untouched SLO budget, and a
    tenant-filtered firehose while the aggressor is parked; ``mem``
    breaches a memory-share floor with a confirmed backlog and only a
    drain lifts it. Every registry tick is harness-driven (the broker
    sweep is parked at 1 h), so the decision log is a pure function of
    message counts — byte-identical across same-seed runs."""
    import hashlib
    import json as json_mod

    from .. import events as events_mod
    from .. import tenancy as tenancy_mod
    from ..broker.broker import Broker
    from ..broker.server import BrokerServer
    from ..client.client import AMQPClient
    from ..events.bus import EventBus, Firehose
    from ..slo import SLOSpec, attach_tenant_latency
    from ..slo.engine import SLOEngine
    from ..store.memory import MemoryStore
    from ..telemetry import TelemetryService
    from ..telemetry.alerts import default_rules as alert_defaults
    from ..tenancy.registry import TenantRegistry

    BODY = 1024
    COST = BODY + 512            # held-cost formula: body + flat overhead
    RATE = 8 * COST              # refill: exactly 8 publishes per tick
    BURST = 16 * COST            # bucket: the 16th publish closes the gate
    rounds = 2 + seed % 3        # drain rounds (8 held publishes each)
    extra = 8 * rounds           # flood depth beyond the gate
    MEM_BODY = 2048
    HIGH = 256 * 1024            # memory high watermark the shares read
    # mem's share = 65536: 40 x 2048 = 81920 breaches it; exit at 52428

    violations: list[str] = []

    async def until(predicate, timeout, what):
        deadline = asyncio.get_event_loop().time() + timeout
        while not predicate():
            if asyncio.get_event_loop().time() > deadline:
                violations.append(f"timeout waiting for {what}")
                return False
            await asyncio.sleep(0.02)
        return True

    broker = Broker(store=MemoryStore(),
                    message_sweep_interval_s=3600.0,  # manual ticks only
                    memory_high_watermark=HIGH,
                    flow_high_watermark=8 << 20,  # node ladder stays at 0
                    router_device=device)
    # base (non-tenant) operator account: tenant users are confined to
    # their tenant's vhosts, so the "/" event/firehose consumer needs a
    # server-wide identity once tenant users force authentication on
    srv = BrokerServer(broker=broker, host="127.0.0.1", port=0,
                       heartbeat_s=0, users={"ops": "ops-pw"})
    registry = TenantRegistry(broker)
    registry.define("aggr", {
        "vhosts": ["vaggr"], "users": {"aggr": "pw-a"},
        "quota": {"publish-rate": RATE, "publish-burst": BURST}})
    registry.define("vict", {"vhosts": ["vvict"], "users": {"vict": "pw-v"}})
    registry.define("mem", {
        "vhosts": ["vmem"], "users": {"mem": "pw-m"},
        "quota": {"memory-share": 0.25}})
    broker.tenancy = registry
    tenancy_mod.install(registry)

    # tenant-scoped SLOs: vict's latency objective gets its own histogram
    # (attach_tenant_latency) and an independent error budget the
    # aggressor must not be able to burn
    specs = [
        SLOSpec("vict-latency", "delivery-latency", threshold_ms=250.0,
                fast_windows=(5, 30), slow_windows=(60, 240),
                budget_window=240, tenant="vict"),
        SLOSpec("vict-publish", "publish-success",
                fast_windows=(5, 30), slow_windows=(60, 240),
                budget_window=240, tenant="vict"),
    ]
    engine = SLOEngine(specs)
    svc = TelemetryService(
        broker, interval_s=1.0, ring_ticks=64,
        rules=alert_defaults(backlog_growth=1e12, stall_ticks=10**6,
                             repl_lag=1e12, loop_lag_ms=1e12,
                             memory_stage=1e12),
        slo=engine)
    broker.telemetry = svc
    attach_tenant_latency(engine, registry)

    conns: list = []
    bus_events: list[dict] = []
    taps: list = []
    try:
        await srv.start()
        for vh in ("vaggr", "vvict", "vmem"):
            await broker.create_vhost(vh)

        # -- observability consumers FIRST (ops identity on "/"): the
        #    decision stream, one tenant-scoped union binding, and the
        #    vict-filtered firehose
        ops = await AMQPClient.connect(
            "127.0.0.1", srv.bound_port, username="ops", password="ops-pw")
        conns.append(ops)
        ech = await ops.channel()
        await ech.queue_declare("tev", exclusive=True)
        await ech.queue_bind("tev", "amq.chanamq.event", "tenant.throttle.*")
        await ech.queue_bind("tev", "amq.chanamq.event", "tenant.resume.*")
        await ech.queue_bind("tev", "amq.chanamq.event",
                             "tenant.aggr.queue.declared")

        def on_event(msg):
            bus_events.append(json_mod.loads(bytes(msg.body)))
            ech.basic_ack(msg.delivery_tag)

        await ech.basic_consume("tev", on_event, consumer_tag="soak-ev")

        fch = await ops.channel()
        await fch.queue_declare("tfh", exclusive=True)
        await fch.queue_bind("tfh", "amq.chanamq.trace", "publish.#")
        await fch.queue_bind("tfh", "amq.chanamq.trace", "publish")
        await fch.queue_bind("tfh", "amq.chanamq.trace", "deliver.#")

        def on_tap(msg):
            taps.append(msg.routing_key)
            fch.basic_ack(msg.delivery_tag)

        await fch.basic_consume("tfh", on_tap, consumer_tag="soak-fh")
        events_mod.install(EventBus(broker),
                           Firehose(broker, tenant_filter="vict"))

        # -- aggressor: 16 paced publishes exactly drain the burst; the
        #    16th spend lands tokens on 0 and closes the gate
        aggr = await AMQPClient.connect(
            "127.0.0.1", srv.bound_port, vhost="vaggr",
            username="aggr", password="pw-a")
        conns.append(aggr)
        ach = await aggr.channel()
        await ach.confirm_select()
        await ach.queue_declare("aq")
        for i in range(16):
            ach.basic_publish(b"a" * BODY, routing_key="aq")
            await ach.wait_unconfirmed_below(1, timeout=10)
        aggr_t = registry.tenants["aggr"]
        if not aggr_t.rate_gated:
            violations.append("aggressor bucket did not gate on the 16th "
                              f"publish (tokens={aggr_t.tokens})")
        # published=15: the counter increments after the gating spend, so
        # the 16th publish is in flight when the throttle is ledgered
        if not registry.decision_log or registry.decision_log[0] != {
                "decision": "throttle", "tenant": "aggr",
                "reason": "publish-rate", "tick": 0, "tokens": 0,
                "resident": 0, "floor": 0, "published": 15}:
            violations.append(
                f"unexpected first decision: {registry.decision_log[:1]}")

        # flood past the gate: every one of these parks at the hold gate
        for _ in range(extra):
            ach.basic_publish(b"a" * BODY, routing_key="aq")

        def held_publishes(tenant):
            # only publishes: the client's FlowOk reply to the advisory
            # Channel.Flow can FIFO-park behind a held publish too
            return sum(
                1 for c in tenant.conns for cmds in c._held.values()
                for cmd in cmds if type(cmd.method).__name__ == "Publish")

        await until(lambda: held_publishes(aggr_t) == extra, 10,
                    f"{extra} held aggressor publishes")

        # -- victim, while the aggressor is parked: paced publish->deliver
        #    latency plus its own SLO budget must be untouched
        vict = await AMQPClient.connect(
            "127.0.0.1", srv.bound_port, vhost="vvict",
            username="vict", password="pw-v")
        conns.append(vict)
        vch = await vict.channel()
        await vch.confirm_select()
        await vch.queue_declare("vq")
        loop = asyncio.get_event_loop()
        lat: list[float] = []
        got = asyncio.Event()

        def on_vict(msg):
            lat.append(loop.time() - t0)
            vch.basic_ack(msg.delivery_tag)
            got.set()

        await vch.basic_consume("vq", on_vict, consumer_tag="v")
        svc.sample_tick(1.0)  # latency baseline tick (delta buckets)
        for i in range(24):
            got.clear()
            t0 = loop.time()
            vch.basic_publish(b"v" * BODY, routing_key="vq")
            await asyncio.wait_for(got.wait(), 10)
        svc.sample_tick(1.0)
        svc.sample_tick(1.0)
        p99 = sorted(lat)[max(0, int(len(lat) * 0.99) - 1)]
        if p99 > 0.25:
            violations.append(
                f"victim paced p99 {p99 * 1000:.1f} ms > 250 ms while the "
                "aggressor was parked")
        budgets = engine.readiness_stamp()["budget_remaining"]
        for name in ("vict-latency", "vict-publish"):
            if budgets.get(name) != 1.0:
                violations.append(
                    f"victim SLO budget burned: {name}={budgets.get(name)}")

        # -- drain: each tick refills exactly 8 publishes' tokens -> the
        #    gate lifts, 8 held publishes release and re-close it
        for r in range(1, rounds + 1):
            registry.tick(1.0)
            remaining = extra - 8 * r
            await until(lambda want=remaining:
                        len(ach.unconfirmed) == want, 10,
                        f"drain round {r}: {remaining} unconfirmed left")
        registry.tick(1.0)  # final refill lifts the gate for good
        if aggr_t.gated:
            violations.append("aggressor still gated after the final tick")
        if aggr_t.throttles != rounds + 1:
            violations.append(
                f"aggressor throttles {aggr_t.throttles} != {rounds + 1}")

        # zero confirmed loss through the gate: everything the aggressor
        # ever published is consumable
        a_got: set[int] = set()
        a_done = asyncio.Event()

        def on_aggr(msg):
            a_got.add(msg.delivery_tag)
            ach.basic_ack(msg.delivery_tag)
            if len(a_got) >= 16 + extra:
                a_done.set()

        await ach.basic_consume("aq", on_aggr, consumer_tag="a")
        try:
            await asyncio.wait_for(a_done.wait(), 15)
        except asyncio.TimeoutError:
            violations.append(
                f"aggressor drained only {len(a_got)}/{16 + extra} after "
                "the gate lifted")

        # -- memory-share floor: a confirmed 80 KiB backlog breaches mem's
        #    64 KiB share at the next tick; held publishes stay parked (a
        #    memory floor never grants credit) until a consumer drains it
        mem = await AMQPClient.connect(
            "127.0.0.1", srv.bound_port, vhost="vmem",
            username="mem", password="pw-m")
        conns.append(mem)
        mch = await mem.channel()
        await mch.confirm_select()
        await mch.queue_declare("mq")
        for _ in range(40):
            mch.basic_publish(b"m" * MEM_BODY, routing_key="mq")
        await mch.wait_unconfirmed_below(1, timeout=10)
        mem_t = registry.tenants["mem"]
        registry.tick(1.0)
        if not mem_t.memory_gated:
            violations.append(
                f"memory share not gated at {mem_t.resident_bytes} resident")
        for _ in range(8):
            mch.basic_publish(b"m" * MEM_BODY, routing_key="mq")

        await until(lambda: held_publishes(mem_t) == 8, 10,
                    "8 held mem publishes")
        registry.tick(1.0)
        if not mem_t.memory_gated:
            violations.append("memory floor lifted without a drain")

        m_count = 0
        m_done = asyncio.Event()

        # a second channel: the consume must not queue behind the held
        # publishes (holds are per-channel FIFO by design)
        mch2 = await mem.channel()

        def on_mem(msg):
            nonlocal m_count
            m_count += 1
            mch2.basic_ack(msg.delivery_tag)
            if m_count >= 48:
                m_done.set()

        await mch2.basic_consume("mq", on_mem, consumer_tag="m")
        await until(lambda: registry.tenant_resident_bytes(mem_t) == 0,
                    15, "mem backlog drain")
        registry.tick(1.0)  # resident back under the exit ratio: resume
        if mem_t.memory_gated:
            violations.append("memory floor still pinned after the drain")
        try:
            await asyncio.wait_for(m_done.wait(), 15)
        except asyncio.TimeoutError:
            violations.append(
                f"mem delivered only {m_count}/48 after the floor lifted")

        # -- event-bus and firehose assertions (delivery is async: give
        #    the streams a bounded settle window)
        expected_events = 2 * rounds + 5
        await until(lambda: len(bus_events) >= expected_events, 10,
                    f"{expected_events} bus events")
        decisions = [ev["event"] for ev in bus_events
                     if not ev["event"].startswith("tenant.aggr.queue")
                     and ev["event"] != "queue.declared"]
        want = (["tenant.throttle.aggr"]
                + ["tenant.resume.aggr", "tenant.throttle.aggr"] * rounds
                + ["tenant.resume.aggr", "tenant.throttle.mem",
                   "tenant.resume.mem"])
        if decisions != want:
            violations.append(
                f"decision event stream mismatch: {decisions} != {want}")
        union = [ev for ev in bus_events if ev["event"] == "queue.declared"]
        if len(union) != 1 or union[0].get("tenant") != "aggr" \
                or union[0].get("queue") != "aq":
            violations.append(
                f"tenant-scoped union route broken: {union}")
        if any(".vict" in ev["event"] for ev in bus_events):
            violations.append("victim tenant saw gate decisions")
        await until(lambda: len(taps) >= 48, 10, "48 firehose taps")
        bad_taps = [t for t in taps if t not in ("publish", "deliver.vq")]
        if bad_taps:
            violations.append(
                f"vict-filtered firehose tapped foreign traffic: "
                f"{sorted(set(bad_taps))}")
        if taps.count("deliver.vq") != 24 or taps.count("publish") != 24:
            violations.append(
                f"firehose tap counts off: {len(taps)} total, "
                f"{taps.count('deliver.vq')} delivers")

        log_blob = json_mod.dumps(
            registry.decision_log, separators=(",", ":"),
            sort_keys=True).encode()
        return {
            "seed": seed,
            "rounds": rounds,
            "aggr_published": aggr_t.published_total(),
            "aggr_throttles": aggr_t.throttles,
            "victim_p99_ms": round(p99 * 1000, 2),
            "victim_budgets": {k: budgets.get(k) for k in budgets},
            "mem_throttles": mem_t.throttles,
            "decisions": len(registry.decision_log),
            "bus_events": len(bus_events),
            "firehose_taps": len(taps),
            "log_sha256": hashlib.sha256(log_blob).hexdigest(),
            "log_bytes": log_blob,
            "violations": violations,
        }
    finally:
        events_mod.install(None)
        tenancy_mod.install(None)
        for conn in conns:
            try:
                await conn.close()
            except Exception:
                pass
        try:
            await srv.stop()
        except Exception:
            pass


async def run_tenant_soak(seed: int, *, device: str = "cuda") -> dict:
    """Noisy-neighbor tenancy soak (``bench.py --tenant``): the seeded
    three-tenant episode run TWICE with the same seed. ``violations`` is
    empty iff every run held:

    1. **Quota throttles the aggressor, not the victim** — the token
       bucket gates on exactly the 16th publish, each registry tick
       releases exactly 8 held publishes, and the victim's paced p99
       stays under 250 ms with its tenant SLO budgets at 1.0.
    2. **Zero confirmed loss through the gates** — every held publish is
       eventually released, confirmed and consumable.
    3. **The memory-share floor is drain-lifted only** — held publishes
       never execute while the floor is pinned.
    4. **Tenant-scoped observability is exact** — the decision event
       stream, the ``tenant.<name>.*`` union route and the
       tenant-filtered firehose each carry exactly the expected traffic.
    5. **The decision log is deterministic** — the two runs' normalized
       logs compare byte-identical, and non-trivially.
    """
    first = await _tenant_run(seed, device)
    second = await _tenant_run(seed, device)
    violations = list(first.pop("violations"))
    violations.extend(second.pop("violations"))
    log1 = first.pop("log_bytes")
    log2 = second.pop("log_bytes")
    if not log1:
        violations.append("first run produced an empty decision log")
    if log1 != log2:
        violations.append("same-seed tenancy decision logs differ")
    return {
        "seed": seed,
        "runs": [first, second],
        "log_sha256": first.get("log_sha256"),
        "violations": violations,
    }


async def run_tenant_churn(cycles: int = 10000, *,
                           amqp_every: int = 100,
                           device: str = "cuda") -> dict:
    """Tenant-churn leak check (``bench.py --tenant-churn``): ``cycles``
    define/remove rounds against a live registry — every ``amqp_every``-th
    round also creates the tenant's vhost, authenticates as its user,
    declares/publishes confirmed, disconnects and deletes the vhost. At
    the end every registry index, auth view, accounted byte and vhost
    must be exactly back at baseline: a surviving slot is a leak in the
    define/remove or detach bookkeeping."""
    from .. import tenancy as tenancy_mod
    from ..broker.broker import Broker
    from ..broker.server import BrokerServer
    from ..client.client import AMQPClient
    from ..store.memory import MemoryStore
    from ..tenancy.registry import TenantRegistry

    broker = Broker(store=MemoryStore(), message_sweep_interval_s=3600.0,
                    flow_high_watermark=8 << 20, router_device=device)
    srv = BrokerServer(broker=broker, host="127.0.0.1", port=0,
                       heartbeat_s=0)
    registry = TenantRegistry(broker)
    broker.tenancy = registry
    tenancy_mod.install(registry)
    violations: list[str] = []
    baseline_vhosts = None
    amqp_cycles = 0
    try:
        await srv.start()
        baseline_vhosts = set(broker.vhosts)
        for i in range(cycles):
            name, vh, user = f"t{i}", f"vt{i}", f"u{i}"
            tenant = registry.define(name, {
                "vhosts": [vh], "users": {user: f"pw{i}"},
                "acls": {user: {vh: ["configure", "write", "read"]}},
                "quota": {"publish-rate": 4096, "max-queues": 4}})
            if i % amqp_every == 0:
                await broker.create_vhost(vh)
                conn = await AMQPClient.connect(
                    "127.0.0.1", srv.bound_port, vhost=vh,
                    username=user, password=f"pw{i}")
                try:
                    if len(tenant.conns) != 1:
                        violations.append(
                            f"cycle {i}: authenticated connection not "
                            f"attached ({len(tenant.conns)} attached)")
                    ch = await conn.channel()
                    await ch.confirm_select()
                    await ch.queue_declare(f"q{i}")
                    for _ in range(3):
                        ch.basic_publish(b"t" * 512, routing_key=f"q{i}")
                    await ch.wait_unconfirmed_below(1, timeout=10)
                    # explicit delete: vhost teardown drops structures but
                    # the accounting gate is the queue-deletion path
                    await ch.queue_delete(f"q{i}")
                finally:
                    await conn.close()
                deadline = asyncio.get_event_loop().time() + 10
                while tenant.conns and \
                        asyncio.get_event_loop().time() < deadline:
                    await asyncio.sleep(0.005)
                if tenant.conns:
                    violations.append(
                        f"cycle {i}: connection never detached")
                    break
                await broker.delete_vhost(vh)
                amqp_cycles += 1
            if not registry.remove(name):
                violations.append(f"cycle {i}: remove({name!r}) missed")
                break

        # settle: every registry slot, auth view and accounted byte must
        # be exactly at baseline
        if registry.tenants or registry.by_vhost or registry.by_user:
            violations.append(
                f"registry slots leaked: {len(registry.tenants)} tenants, "
                f"{len(registry.by_vhost)} vhosts, "
                f"{len(registry.by_user)} users")
        if registry.auth_users(None) is not None:
            violations.append("auth_users view retains churned users")
        if registry.auth_permissions(None) is not None:
            violations.append("auth_permissions view retains allowlists")
        leaked = broker.resident_bytes + broker.held_bytes
        if leaked:
            violations.append(
                f"accounted-bytes leak: resident={broker.resident_bytes} "
                f"held={broker.held_bytes}")
        if set(broker.vhosts) != baseline_vhosts:
            violations.append(
                f"vhosts not at baseline: "
                f"{sorted(set(broker.vhosts) - baseline_vhosts)}")
        if registry.decision_log:
            violations.append(
                f"{len(registry.decision_log)} spurious gate decisions "
                "during churn")
        if broker.metrics.tenancy_quota_refusals_total:
            violations.append(
                f"{broker.metrics.tenancy_quota_refusals_total} spurious "
                "quota refusals during churn")
        return {
            "cycles": cycles,
            "amqp_cycles": amqp_cycles,
            "leaked_bytes": leaked,
            "live_vhosts": len(broker.vhosts),
            "registry_slots": (len(registry.tenants)
                               + len(registry.by_vhost)
                               + len(registry.by_user)),
            "violations": violations,
        }
    finally:
        tenancy_mod.install(None)
        try:
            await srv.stop()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# delivery-semantics soak: Tx kill -9 at the WAL commit boundary +
# TTL-expiry dead-lettering under seeded store faults
# ---------------------------------------------------------------------------


async def _tx_kill_run(seed: int, device: str = "cuda") -> dict:
    """One seeded transaction workload ending in a simulated SIGKILL
    between Tx.Commit receipt and the WAL group commit.

    A client runs a seeded mix of commits and rollbacks against a
    WAL-backed broker; at the seeded kill index the store is "killed"
    the instant the commit's tx_batch is sealed — before a single byte
    of it can reach the segment file (the commit task is cancelled and
    the write executors torn down synchronously, so the crash point is
    a pure function of the seed). A fresh broker over the same directory
    must then recover exactly the committed transactions: zero confirmed
    loss, no post-rollback ghosts, and the killed transaction absent
    as a whole (all-or-nothing)."""
    import random
    import shutil
    import tempfile
    from zlib import crc32

    from ..amqp.properties import BasicProperties
    from ..broker.broker import Broker
    from ..broker.server import BrokerServer
    from ..client.client import AMQPClient
    from ..store.sqlite import SqliteStore
    from ..wal import WalStore

    rng = random.Random((seed * 1_000_003) ^ crc32(b"tx-commit-kill"))
    root = tempfile.mkdtemp(prefix="chanamq-semsoak-")
    db = root + "/store.db"
    log: list = []
    violations: list[str] = []
    committed: list[str] = []
    rolled_back: list[str] = []
    killed_bodies: list[str] = []
    kill_at = 6 + rng.randrange(3)
    try:
        store = WalStore(SqliteStore(db), flush_ms=1.0,
                         checkpoint_ms=3_600_000.0)
        killed = asyncio.Event()
        orig_seal = store.tx_seal
        orig_flush = store.flush
        armed = False

        def seal_and_die():
            # SIGKILL simulation, synchronous with the seal: nothing that
            # happens after this line may reach disk
            store._commit_task.cancel()
            store._checkpoint_task.cancel()
            store._inner._closed = True
            store._executor.shutdown(wait=True)
            store._inner._executor.shutdown(wait=False)
            lsn = orig_seal()
            killed.set()
            return lsn

        def flush(intervals=None):
            if not killed.is_set():
                return orig_flush(intervals)

            async def _dead():
                # the killed process writes nothing durable; completing
                # the barrier (vs hanging) only lets the doomed coroutine
                # unwind so teardown is clean — the disk state is already
                # frozen by seal_and_die
                return None
            return _dead()

        srv = BrokerServer(broker=Broker(store=store, router_device=device),
                           host="127.0.0.1", port=0, heartbeat_s=0)
        await srv.start()
        conn = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await conn.channel()
        await ch.queue_declare("txq", durable=True)
        await ch.tx_select()
        persistent = BasicProperties(delivery_mode=2)
        commit_task = None
        for i in range(12):
            bodies = ["tx%d-%d" % (i, j)
                      for j in range(1 + rng.randrange(3))]
            roll = rng.random() < 0.3
            if i == kill_at:
                armed = True
                store.tx_seal = seal_and_die
                store.flush = flush
            for body in bodies:
                ch.basic_publish(body.encode(), routing_key="txq",
                                 properties=persistent)
            if i == kill_at:
                killed_bodies = bodies
                commit_task = asyncio.ensure_future(ch.tx_commit())
                await asyncio.wait_for(killed.wait(), timeout=15)
                log.append(["kill", i, len(bodies)])
                break
            if roll:
                await ch.tx_rollback()
                rolled_back.extend(bodies)
                log.append(["rollback", i, len(bodies)])
            else:
                await ch.tx_commit()
                committed.extend(bodies)
                log.append(["commit", i, len(bodies)])
        if not armed or not killed.is_set():
            violations.append("kill rule never fired")
        if commit_task is not None:
            commit_task.cancel()
        try:
            await asyncio.wait_for(conn.close(), timeout=2)
        except Exception:
            pass
        try:
            await asyncio.wait_for(srv.stop(), timeout=3)
        except Exception:
            pass

        # ---- recovery: a fresh broker over the same directory ----
        store2 = WalStore(SqliteStore(db), flush_ms=1.0,
                          checkpoint_ms=3_600_000.0)
        srv2 = BrokerServer(
            broker=Broker(store=store2, router_device=device),
            host="127.0.0.1", port=0, heartbeat_s=0)
        await srv2.start()
        try:
            conn2 = await AMQPClient.connect("127.0.0.1", srv2.bound_port)
            ch2 = await conn2.channel()
            got: list[str] = []
            deadline = asyncio.get_event_loop().time() + 5.0
            while asyncio.get_event_loop().time() < deadline:
                msg = await ch2.basic_get("txq", no_ack=True)
                if msg is None:
                    if len(got) >= len(committed):
                        break
                    await asyncio.sleep(0.02)
                    continue
                got.append(bytes(msg.body).decode())
            missing = [b for b in committed if b not in got]
            if missing:
                violations.append(
                    f"confirmed loss: {len(missing)} committed bodies "
                    f"missing after recovery ({missing[:3]}...)")
            ghosts = [b for b in got if b in rolled_back]
            if ghosts:
                violations.append(
                    f"post-rollback ghosts recovered: {ghosts[:3]}")
            kill_recovered = [b for b in killed_bodies if b in got]
            if kill_recovered and len(kill_recovered) != len(killed_bodies):
                violations.append(
                    "killed tx partially recovered: "
                    f"{len(kill_recovered)}/{len(killed_bodies)} — "
                    "the tx_batch boundary is torn")
            if got != committed + kill_recovered:
                violations.append(
                    f"recovered sequence diverges: got {len(got)} "
                    f"expected {len(committed)}")
            await conn2.close()
            log.append(["recovered", len(got), len(kill_recovered)])
        finally:
            await srv2.stop()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {
        "kill_at": kill_at,
        "committed": len(committed),
        "rolled_back": len(rolled_back),
        "killed": len(killed_bodies),
        "log": log,
        "violations": violations,
    }


async def _ttl_dlx_run(seed: int, device: str = "cuda") -> dict:
    """TTL-expiry dead-lettering under a seeded degraded-storage window
    (the single-node stand-in for a partition: flushes dropped, writes
    delayed — the durability path is unreachable, the broker keeps
    running). Every expired body must arrive in the DLQ exactly once
    with exactly one x-death entry."""
    import random
    from zlib import crc32

    from ..amqp.properties import BasicProperties
    from ..broker.broker import Broker
    from ..broker.server import BrokerServer
    from ..client.client import AMQPClient
    from ..store.memory import MemoryStore
    from .store import ChaosStore

    rng = random.Random((seed * 1_000_003) ^ crc32(b"ttl-dlx-partition"))
    messages = 40
    plan = FaultPlan(seed, [
        FaultRule(name="dlx-partition-flush", kind="drop",
                  sites=["store.flush"], after=2, count=4),
        FaultRule(name="dlx-partition-latency", kind="latency",
                  sites=["store.write", "store.delete"],
                  probability=0.25, delay_ms=2),
    ])
    install(plan)
    violations: list[str] = []
    try:
        broker = Broker(message_sweep_interval_s=0.05,
                        store=ChaosStore(MemoryStore(), _LazyRuntime()),
                        router_device=device)
        srv = BrokerServer(broker=broker, host="127.0.0.1", port=0,
                           heartbeat_s=0)
        await srv.start()
        try:
            conn = await AMQPClient.connect("127.0.0.1", srv.bound_port)
            ch = await conn.channel()
            await ch.exchange_declare("soak_dlx", "fanout", durable=True)
            await ch.queue_declare("soak_dlq", durable=True)
            await ch.queue_bind("soak_dlq", "soak_dlx", "")
            # durable queue + persistent bodies so expiry/dead-letter
            # bookkeeping actually crosses the (faulted) store sites
            await ch.queue_declare("soak_ttl", durable=True, arguments={
                "x-message-ttl": 60,
                "x-dead-letter-exchange": "soak_dlx",
                "x-dead-letter-routing-key": "dead"})
            for i in range(messages):
                props = BasicProperties(delivery_mode=2)
                if rng.random() < 0.4:  # per-message TTL below queue TTL
                    props = BasicProperties(delivery_mode=2, expiration="30")
                ch.basic_publish(b"dl%d" % i, routing_key="soak_ttl",
                                 properties=props)
            counts: dict = {}
            deadline = asyncio.get_event_loop().time() + 10.0
            while (sum(counts.values()) < messages
                   and asyncio.get_event_loop().time() < deadline):
                msg = await ch.basic_get("soak_dlq", no_ack=True)
                if msg is None:
                    await asyncio.sleep(0.02)
                    continue
                body = bytes(msg.body).decode()
                counts[body] = counts.get(body, 0) + 1
                deaths = (msg.properties.headers or {}).get("x-death") or []
                if len(deaths) != 1 or deaths[0].get("count") != 1:
                    violations.append(
                        f"{body}: x-death not exactly-once: {deaths}")
                elif deaths[0].get("reason") != "expired":
                    violations.append(
                        f"{body}: wrong death reason {deaths[0]}")
            expected = {"dl%d" % i for i in range(messages)}
            missing = sorted(expected - set(counts))
            dupes = sorted(b for b, n in counts.items() if n > 1)
            if missing:
                violations.append(
                    f"{len(missing)} expired bodies never dead-lettered "
                    f"({missing[:3]}...)")
            if dupes:
                violations.append(f"duplicate dead-letters: {dupes[:3]}")
            if broker.metrics.dlx_expired != messages:
                violations.append(
                    f"dlx_expired={broker.metrics.dlx_expired}, "
                    f"expected {messages}")
            dead_lettered = sum(counts.values())
            await conn.close()
        finally:
            await srv.stop()
    finally:
        clear()
    return {
        "messages": messages,
        "dead_lettered": dead_lettered,
        "fires": plan.total_fires,
        "violations": violations,
    }


async def run_semantics_soak(seed: int, *, device: str = "cuda") -> dict:
    """Delivery-semantics chaos soak: both seeded rules run
    TWICE with the same seed and their normalized reports must serialize
    byte-identically — the fault schedule, the tx mix, the kill index and
    the recovery outcome are all pure functions of the seed."""
    import json as _json

    tx1 = await _tx_kill_run(seed, device)
    tx2 = await _tx_kill_run(seed, device)
    dlx1 = await _ttl_dlx_run(seed, device)
    dlx2 = await _ttl_dlx_run(seed, device)

    violations: list[str] = []
    for tag, run in (("tx", tx1), ("tx-repeat", tx2),
                     ("ttl-dlx", dlx1), ("ttl-dlx-repeat", dlx2)):
        violations.extend(f"{tag}: {v}" for v in run["violations"])

    def normalize(run: dict) -> str:
        return _json.dumps(
            {k: v for k, v in run.items() if k != "violations"},
            sort_keys=True)

    if normalize(tx1) != normalize(tx2):
        violations.append("same-seed tx-kill runs are not byte-identical")
    if normalize(dlx1) != normalize(dlx2):
        violations.append("same-seed ttl-dlx runs are not byte-identical")
    return {
        "seed": seed,
        "tx": tx1,
        "ttl_dlx": dlx1,
        "deterministic": normalize(tx1) == normalize(tx2)
        and normalize(dlx1) == normalize(dlx2),
        "violations": violations,
    }


# ---------------------------------------------------------------------------
# Federation soak: two clusters, a severed link, a failed-over
# consumer, a heal — zero confirmed loss, contiguous cursor resume, no
# post-settle duplicates, and a seed-deterministic link transition log.
# ---------------------------------------------------------------------------

def _federation_sever_plan(seed: int) -> FaultPlan:
    """Every ship and every reconnect attempt fails while installed: a
    hard link sever at the federation seams (transport untouched, so the
    intra-broker clients keep working)."""
    return FaultPlan(seed, [
        FaultRule(name="sever-ship", kind="error", sites=["fed.ship"]),
        FaultRule(name="sever-connect", kind="error",
                  sites=["fed.connect"]),
    ])


async def _federation_run(seed: int, device: str = "cuda") -> dict:
    """One seeded two-cluster run. Cluster A owns stream ``fq`` and a
    federation link to cluster B; a consumer on A commits a cursor, the
    link is severed mid-stream, the consumer fails over to B's mirror and
    resumes from the mirrored cursor, the link heals and the backlog
    ships. Returns a wall-clock-free report the determinism gate can
    compare byte-for-byte across same-seed runs."""
    import random as _random
    from zlib import crc32

    from ..amqp.properties import BasicProperties
    from ..broker.broker import Broker
    from ..broker.server import BrokerServer
    from ..client.client import AMQPClient
    from ..federation import FederationService
    from ..store.memory import MemoryStore

    rng = _random.Random((seed * 1_000_003) ^ crc32(b"federation"))
    violations: list[str] = []
    phase1 = 40 + rng.randrange(20)   # records before the sever
    phase2 = 30 + rng.randrange(20)   # records published while severed
    total = phase1 + phase2
    commit_k = phase1 // 2            # cursor committed through this index
    qname = "fq"
    cursor = "fed-cursor"

    async def eventually(predicate, timeout=15.0, what="condition"):
        deadline = asyncio.get_event_loop().time() + timeout
        while not predicate():
            if asyncio.get_event_loop().time() > deadline:
                violations.append(f"timed out waiting for {what}")
                return False
            await asyncio.sleep(0.02)
        return True

    # an empty seeded plan keeps chaos.backoff_rng() deterministic for
    # the whole run, including the healed phase
    install(FaultPlan(seed, []))
    b_srv = BrokerServer(
        broker=Broker(store=MemoryStore(), router_device=device),
        host="127.0.0.1", port=0, heartbeat_s=0)
    await b_srv.start()
    fed_b = FederationService(b_srv.broker, node_name="cluster-b", port=0)
    await fed_b.start()
    a_srv = BrokerServer(
        broker=Broker(store=MemoryStore(), router_device=device),
        host="127.0.0.1", port=0, heartbeat_s=0)
    await a_srv.start()
    fed_a = FederationService(
        a_srv.broker, node_name="cluster-a", port=0,
        retry_s=0.05, idle_s=0.05,
        links=[{"name": "to-b", "host": "127.0.0.1", "port": fed_b.port,
                "queues": [qname], "window": 4}])
    await fed_a.start()
    link = fed_a.links[0]
    report: dict = {}
    try:
        conn = await AMQPClient.connect("127.0.0.1", a_srv.bound_port)
        pch = await conn.channel()
        await pch.confirm_select()
        # small segments so the run seals (and ships) many of them
        await pch.queue_declare(qname, durable=True, arguments={
            "x-queue-type": "stream",
            "x-stream-max-segment-size-bytes": 256})
        props = BasicProperties(delivery_mode=2)
        for i in range(phase1):
            pch.basic_publish(f"f{i:06d}".encode(), routing_key=qname,
                              properties=props)
        await pch.wait_unconfirmed_below(1, timeout=30)

        # consume on A and commit the cursor through commit_k
        got: list = []
        half_done = asyncio.Event()
        ch1 = await conn.channel()
        await ch1.basic_qos(prefetch_count=total + 8)

        def on_a(msg):
            got.append((msg.delivery_tag, bytes(msg.body).decode()))
            if len(got) == commit_k + 1:
                half_done.set()

        await ch1.basic_consume(qname, on_a, consumer_tag=cursor,
                                arguments={"x-stream-offset": "first"})
        await asyncio.wait_for(half_done.wait(), 15)
        ch1.basic_ack(got[commit_k][0], multiple=True)
        await asyncio.sleep(0.2)  # let the coalesced commit flush
        await ch1.basic_cancel(cursor)

        a_queue = a_srv.broker.get_queue("/", qname)
        b_queue_next = lambda: (  # noqa: E731
            b_srv.broker.vhosts["/"].queues.get(qname).next_offset
            if b_srv.broker.vhosts["/"].queues.get(qname) else 0)
        # quiesce: every sealed segment shipped, cursor mirrored — the
        # sever point is then a pure function of the seed, not of timing
        sealed_tail = a_queue._active_base
        await eventually(lambda: b_queue_next() >= sealed_tail,
                         what="pre-sever ship quiesce")
        # stream offsets are 1-based: body f{i} lives at offset i+1,
        # so acking through got[commit_k] commits offset commit_k + 1
        await eventually(
            lambda: (b_srv.broker.vhosts["/"].queues.get(qname) is not None
                     and b_srv.broker.vhosts["/"].queues[qname]
                     .committed.get(cursor) == commit_k + 1),
            what="cursor mirror")
        pre_sever_next = b_queue_next()

        # -- sever the link and keep publishing ----------------------------
        install(_federation_sever_plan(seed))
        for i in range(phase1, total):
            pch.basic_publish(f"f{i:06d}".encode(), routing_key=qname,
                              properties=props)
        await pch.wait_unconfirmed_below(1, timeout=30)
        link.wake()
        await eventually(lambda: link.state == "down", what="link down")
        if b_queue_next() != pre_sever_next:
            violations.append(
                f"severed link still shipped: mirror next "
                f"{b_queue_next()} != {pre_sever_next}")

        # -- fail the consumer group over to the mirror --------------------
        b_conn = await AMQPClient.connect("127.0.0.1", b_srv.bound_port)
        b_ch = await b_conn.channel()
        await b_ch.basic_qos(prefetch_count=total + 8)
        failover: list = []
        failover_caught_up = asyncio.Event()

        def on_b(msg):
            failover.append(bytes(msg.body).decode())
            if len(failover) >= total - commit_k - 1:
                failover_caught_up.set()

        await b_ch.basic_consume(qname, on_b, consumer_tag=cursor,
                                 arguments={"x-stream-offset": "next"})
        # the mirror can only serve what shipped before the sever:
        # offsets commit_k + 2 .. pre_sever_next - 1
        await eventually(
            lambda: len(failover) >= pre_sever_next - commit_k - 2,
            what="failover consumer catch-up to severed tail")
        resumed_at = failover[0] if failover else None
        if resumed_at != f"f{commit_k + 1:06d}":
            violations.append(
                f"failover did not resume at committed+1: got {resumed_at}")

        # -- heal: backlog ships, mirror converges on the full stream ------
        install(FaultPlan(seed, []))
        link.wake()
        await eventually(lambda: link.state == "up", what="link heal")
        # seal A's active segment so the tail records become shippable
        if a_queue._active:
            a_queue._seal_active()
        link.wake()
        await eventually(lambda: b_queue_next() >= total,
                         what="post-heal backlog ship")
        try:
            await asyncio.wait_for(failover_caught_up.wait(), 15)
        except asyncio.TimeoutError:
            violations.append(
                f"failover consumer saw {len(failover)}/{total - commit_k - 1}"
                " records after heal")

        # -- invariants -----------------------------------------------------
        expected = [f"f{i:06d}" for i in range(commit_k + 1, total)]
        if failover[:len(expected)] != expected:
            violations.append(
                f"failover delivery not contiguous: got {failover[:3]}.. "
                f"expected {expected[:3]}..")
        settle_len = len(failover)
        await asyncio.sleep(0.4)  # observation window
        if len(failover) != settle_len:
            violations.append(
                f"{len(failover) - settle_len} deliveries after settle")
        dupes = {b for b in failover if failover.count(b) > 1}
        if dupes:
            violations.append(f"duplicate failover deliveries: "
                              f"{sorted(dupes)[:3]}")

        # zero confirmed loss: a fresh reader of the mirror sees every
        # confirmed record, in order
        mirror: list = []
        mirror_done = asyncio.Event()
        m_ch = await b_conn.channel()
        await m_ch.basic_qos(prefetch_count=total + 8)

        def on_mirror(msg):
            mirror.append(bytes(msg.body).decode())
            if len(mirror) >= total:
                mirror_done.set()

        await m_ch.basic_consume(qname, on_mirror, consumer_tag="fed-audit",
                                 arguments={"x-stream-offset": "first"})
        try:
            await asyncio.wait_for(mirror_done.wait(), 15)
        except asyncio.TimeoutError:
            pass
        if mirror != [f"f{i:06d}" for i in range(total)]:
            violations.append(
                f"mirror lost confirmed records: {len(mirror)}/{total}")

        metrics = a_srv.broker.metrics
        report = {
            "records": total,
            "committed_through": commit_k,
            "pre_sever_next": pre_sever_next,
            "resumed_at": resumed_at,
            "mirror_records": len(mirror),
            "segments_shipped": metrics.federation_segments_shipped,
            "resumes": metrics.federation_resumes,
            "transitions": fed_a.transition_log(),
        }
        await b_conn.close()
        await conn.close()
    finally:
        await fed_a.stop()
        await a_srv.stop()
        await fed_b.stop()
        await b_srv.stop()
        clear()
    report["violations"] = violations
    return report


async def run_federation_soak(seed: int, *, device: str = "cuda") -> dict:
    """Federation chaos soak: the seeded sever/heal run executes TWICE
    and the normalized reports (violations aside) must serialize
    byte-identically — the publish mix, the sever point and the link
    transition log are all pure functions of the seed."""
    import json as _json

    one = await _federation_run(seed, device)
    two = await _federation_run(seed, device)
    violations = list(one["violations"])
    violations.extend(f"repeat: {v}" for v in two["violations"])

    def normalize(run: dict) -> str:
        return _json.dumps(
            {k: v for k, v in run.items() if k != "violations"},
            sort_keys=True)

    deterministic = normalize(one) == normalize(two)
    if not deterministic:
        violations.append("same-seed federation runs are not byte-identical")
    return {
        "seed": seed,
        "run": one,
        "deterministic": deterministic,
        "violations": violations,
    }
