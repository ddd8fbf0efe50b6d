"""The Broker facade: vhosts, entity lifecycle, routing, persistence glue.

Rebuilds the broker-state side of the reference's entity actors and their
store write-through (ExchangeEntity.scala:198-365, QueueEntity.scala:162-487,
MessageEntity.scala:114-198, VhostEntity.scala:20-131) as plain single-loop
state with explicit, strictly-ordered async store writes:

- control mutations (declare/bind/delete) are AWAITED before replying, so a
  positive reply implies durability — unlike the reference's partial-failure
  windows (SURVEY.md §7.3 "failover without message loss");
- hot-path bookkeeping (queue log, watermark, unacks) is fire-and-forget but
  FIFO via the store's single writer thread (store_bg), preserving order.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time
from typing import Any, Awaitable, Optional

from .. import chaos, events, profile, trace

from ..amqp.constants import ErrorCode, ExchangeType
from ..amqp.properties import BasicProperties
from ..amqp.value_codec import Timestamp
from ..cluster.idgen import IdGenerator
from ..otel.context import stamp_headers
from ..flow import (
    MemoryAccountant,
    STAGE_PAGE,
    STAGE_REFUSE,
    STAGE_THROTTLE,
)
from ..semantics import DelayService, parse_delay, would_create_cycle
from ..store.api import StoredExchange, StoredMessage, StoredQueue, StoreService
from ..store.memory import MemoryStore
from ..streams import VALID_QUEUE_TYPES, StreamQueue
from ..streams.queue import _parse_max_age_ms
from ..utils.metrics import Metrics
from .entities import Exchange, Message, Queue, VHost, now_ms

log = logging.getLogger("chanamq.broker")

DEFAULT_VHOST = "/"


class BrokerError(Exception):
    """Protocol-level error to be reported on the channel or connection."""

    def __init__(self, code: ErrorCode, message: str) -> None:
        super().__init__(message)
        self.code = code
        self.text = message


class Broker:
    """All broker state for one node."""

    # recovery loads queue metadata in chunks of this many rows so a deep
    # durable backlog never materializes all metas in RAM at once
    RECOVER_META_CHUNK = 4096

    def __init__(
        self,
        store: Optional[StoreService] = None,
        node_id: int = 0,
        message_sweep_interval_s: float = 1.0,
        queue_max_resident: int = 16384,
        memory_high_watermark: int = 0,
        memory_low_watermark: Optional[int] = None,
        consumer_timeout_ms: int = 0,
        store_max_bytes: int = 0,
        stream_segment_bytes: int = 1 << 20,
        stream_segment_age_s: float = 10.0,
        stream_cache_segments: int = 4,
        stream_delivery_batch: int = 128,
        flow_high_watermark: Optional[int] = None,
        flow_low_watermark: Optional[int] = None,
        flow_page_watermark: Optional[int] = None,
        flow_cluster_watermark: Optional[int] = None,
        flow_hard_limit: Optional[int] = None,
        flow_refuse_watermark: Optional[int] = None,
        flow_page_resident: int = 256,
        flow_publish_credit: int = 0,
        flow_consumer_buffer: int = 0,
        park_buffer: Optional[int] = None,
        router_enabled: bool = True,
        router_backend: str = "torch",
        router_device: str = "cuda",
        router_min_batch: int = 16,
        router_max_wildcards: int = 512,
        router_max_queues: int = 4096,
        router_verify: bool = False,
        semantics_enabled: bool = True,
        delay_tick_ms: int = 50,
        native_egress: bool = True,
        native_pool_buffers: int = 16,
        native_pool_buffer_kb: int = 256,
    ) -> None:
        self.store = store or MemoryStore()
        self.idgen = IdGenerator(node_id)
        self.metrics = Metrics()
        # native batch egress (chana.mq.native.*): the process-wide
        # encoder + buffer-pool singleton, or None when the native
        # pipeline is unavailable / disabled — connections snapshot this
        # at accept time and fall back to per-delivery Python rendering
        # when None
        self.egress_encoder = None
        if native_egress:
            from .. import native_ext
            self.egress_encoder = native_ext.egress_encoder(
                native_pool_buffers, native_pool_buffer_kb)
        # connections holding un-rendered delivery records; queue dispatch
        # flushes them at pass end (inside the dispatch ledger window)
        self.egress_dirty: set = set()
        self.vhosts: dict[str, VHost] = {}
        # set by chanamq_tpu.cluster.node.ClusterNode when clustering is on
        self.cluster = None
        # span attribution for message traces (chanamq_tpu/trace/):
        # ClusterNode.start() overwrites with its host:port name
        self.trace_node = "local"
        # set by chanamq_tpu.models.service.ForecastService when forecasting
        # is on (chana.mq.forecast.enabled); admin serves its snapshot
        self.forecaster = None
        # set by chanamq_tpu.telemetry.service.TelemetryService when
        # per-entity sampling is on (chana.mq.telemetry.enabled)
        self.telemetry = None
        # set by chanamq_tpu.control.ControlService when the predictive
        # control plane is on (chana.mq.control.enabled)
        self.control = None
        # set by chanamq_tpu.profile.enable_from_config when the cost
        # ledger is on (chana.mq.profile.enabled); admin serves its snapshot
        self.profile = None
        # advanced delivery semantics (chanamq_tpu/semantics/): the master
        # switch gates the per-publish x-delay probe and bind-time cycle
        # refusal; self.delay is None when off, so the disabled publish
        # path pays one attribute load
        self.semantics_enabled = semantics_enabled
        self.delay = (
            DelayService(self, tick_ms=delay_tick_ms)
            if semantics_enabled else None)
        # broker-wide entity gauges, maintained incrementally at every queue
        # mutation site (entities.py / streams/queue.py) so a sampler tick is
        # O(1) instead of a walk over every queue in every vhost
        self.queue_depth = 0
        self.queue_unacked = 0
        self.queue_consumers = 0
        # readiness drain: run_node flips this when the shutdown signal
        # lands, so /admin/health reports 503 while listeners wind down
        self.draining = False
        self.message_sweep_interval_s = message_sweep_interval_s
        # per-queue resident watermark: beyond this depth, durable+persistent
        # bodies are paged out to the store (config chana.mq.queue.max-resident,
        # the reference's passivation: MessageEntity.scala:168-198). 0 = off.
        self.queue_max_resident = queue_max_resident or 0
        # total message-body bytes resident in RAM (gauge; see account_memory)
        self.resident_bytes = 0
        # inbound publisher backpressure (reference leaned on akka-streams
        # demand + TCP, SURVEY.md §7.3): above the high watermark the memory
        # gate closes and publishing connections stop reading; it reopens
        # below the low watermark (default 80% of high). 0 disables.
        self.memory_high_watermark = memory_high_watermark or 0
        self.memory_low_watermark = (
            memory_low_watermark if memory_low_watermark is not None
            else int(self.memory_high_watermark * 0.8))
        if (self.memory_high_watermark
                and self.memory_low_watermark >= self.memory_high_watermark):
            # low >= high would make the gate flap on every accounting tick
            log.warning(
                "memory low watermark %d >= high %d; clamping to 80%% of high",
                self.memory_low_watermark, self.memory_high_watermark)
            self.memory_low_watermark = int(self.memory_high_watermark * 0.8)
        # ack timeout (chana.mq.consumer.timeout; RabbitMQ consumer_timeout,
        # default 30min there): a delivery unacked past this closes its
        # channel with PRECONDITION_FAILED and requeues. 0 disables.
        self.consumer_timeout_ms = consumer_timeout_ms or 0
        # store-growth watermark (chana.mq.store.max-bytes): when page-out
        # is absorbing a flood, RAM stays flat but the store grows without
        # bound — this gate blocks publishers on the store's live data size
        # (sampled each sweep tick), reopening below 80% of the cap. 0 = off.
        self.store_max_bytes = store_max_bytes or 0
        self.store_bytes = 0  # last sampled store size (gauge)
        # stream-queue defaults (chana.mq.stream.*): active segments seal at
        # stream_segment_bytes or after stream_segment_age_s of quiet;
        # cache_segments bounds resident sealed blobs per stream;
        # delivery_batch caps records pushed per cursor per dispatch pass
        self.stream_segment_bytes = stream_segment_bytes or (1 << 20)
        self.stream_segment_age_s = stream_segment_age_s
        self.stream_cache_segments = stream_cache_segments
        self.stream_delivery_batch = stream_delivery_batch or 128
        # publish bodies held at the gate across all connections (gauge;
        # bounded by PARK_BUF_MAX per connection x max-connections)
        self.held_bytes = 0
        # overload-protection ladder (chanamq_tpu/flow/): on whenever a
        # flow or memory high watermark is configured. The accountant's
        # stage 2 IS the legacy memory gate (blocked == stage>=2 composed
        # with the store gate); stages 1/3/4 add paging, cluster pushback
        # and publish refusal around it.
        self.flow: Optional[MemoryAccountant] = None
        self.flow_paging = False       # stage >= 1: aggressive page cap live
        self.flow_refusing = False     # stage >= 4: publishes get 406
        self.flow_page_resident = flow_page_resident or 0
        self.flow_page_resident_active = 0  # flow_page_resident while paging
        self.flow_publish_credit = flow_publish_credit or 0
        self.flow_consumer_buffer = flow_consumer_buffer or 0
        # per-connection park-buffer override (0: connection class default)
        self.park_buf_max = park_buffer or 0
        # fired as fn(old_stage, new_stage) after broker-side actuation
        # (connections send channel.flow, the cluster shrinks credit)
        self.flow_stage_listeners: set[Any] = set()
        fhw = flow_high_watermark or self.memory_high_watermark
        if fhw:
            # when the flow watermark is the derived memory watermark, the
            # low watermark must follow it too so stage 2 keeps the exact
            # legacy block/unblock boundaries
            flw = flow_low_watermark
            if flw is None and fhw == self.memory_high_watermark:
                flw = self.memory_low_watermark
            self.flow = MemoryAccountant(
                high_watermark=fhw,
                low_watermark=flw,
                page_watermark=flow_page_watermark,
                cluster_watermark=flow_cluster_watermark,
                hard_limit=flow_hard_limit,
                refuse_watermark=flow_refuse_watermark,
            )
            self.flow.listeners.append(self._on_flow_stage)
        # multi-tenancy registry (chanamq_tpu/tenancy/): None unless
        # chana.mq.tenant.enabled — every enforcement seam is one
        # attribute load + identity check when off
        self.tenancy: Optional[Any] = None
        # cross-cluster federation (chanamq_tpu/federation/): None unless
        # chana.mq.federation.enabled — the seal/commit/DLX/Tx hooks are
        # one attribute load + identity check when off
        self.federation: Optional[Any] = None
        # OTLP span exporter (chanamq_tpu/otel/): None unless
        # chana.mq.otel.enabled — trace completion pays one hook check
        self.otel: Optional[Any] = None
        self.blocked = False
        self.blocked_reason = ""  # wire-visible cause (Connection.Blocked)
        self._mem_over = False    # resident_bytes above the RAM watermark
        self._store_over = False  # store size above the store watermark
        self._memory_gate = asyncio.Event()
        self._memory_gate.set()
        # callbacks fired on block/unblock transitions (connections send
        # Connection.Blocked/Unblocked to capable clients — an extension
        # the reference never implemented, README.md:10-22)
        self.blocked_listeners: set[Any] = set()
        # live AMQPConnections (registered by serve()): the ack-timeout
        # sweep walks their channels' unacked maps — the one place EVERY
        # outstanding delivery appears, local or remotely-owned
        self.connections: set[Any] = set()
        # strong refs to fire-and-forget tasks (event loops hold tasks only
        # weakly; an unreferenced task can be GC'd before it runs)
        self._bg_tasks: set[asyncio.Task] = set()
        self._sweep_task: Optional[asyncio.Task] = None
        self._msg_delete_buf: list[int] = []
        self._started = False
        # publish route cache (SINGLE-NODE publish_sync only; the clustered
        # publish path never consults it): (vhost, exchange, routing-key)
        # -> resolved local Queue list. A flow's route repeats on every
        # message, so the hot loop skips the matcher walk AND the
        # name->Queue resolution; any topology mutation on this node
        # (declare/delete/bind/unbind) clears the cache outright — churn is
        # rare relative to publishes, and clearing frees dead Queue objects
        # immediately. Only plain key-routed single-hop exchanges cache —
        # headers matchers and e2e graphs route on more than the key.
        # High-cardinality keys (per-message-unique topics) would thrash:
        # after _ROUTE_CACHE_STRIKES overflow-clears the cache disables
        # for the broker's lifetime (same adaptive pattern as the
        # connection's publish-args cache).
        self._route_cache: Optional[dict[tuple[str, str, str], list[Queue]]] = {}
        self._route_cache_strikes = 0
        # clustered twin of _route_cache: (vhost, exchange, rk) ->
        # (local Queue objects, [(owner, names, encoded meta head)]).
        # Invalidation additionally hooks cluster metadata/membership
        # mutations (ClusterNode calls invalidate_routes on those).
        self._cluster_route_cache: Optional[
            dict[tuple[str, str, str], tuple[list, list]]] = {}
        self._cluster_route_strikes = 0
        # data-parallel batch router (chana.mq.router.*): the fused publish
        # path defers eligible messages and flushes whole read batches
        # through compiled binding tables (chanamq_tpu/router/). None when
        # disabled — every router seam is a `router is not None` check.
        self.router = None
        if router_enabled:
            from ..router.engine import TensorRouter

            self.router = TensorRouter(
                self, backend=router_backend, device=router_device,
                min_batch=router_min_batch or 16,
                max_wildcards=router_max_wildcards or 512,
                max_queues=router_max_queues or 4096,
                verify=router_verify)

    _ROUTE_CACHE_MAX = 4096
    _ROUTE_CACHE_STRIKES = 4

    def invalidate_routes(self, vhost: Optional[str] = None,
                          exchange: Optional[str] = None) -> None:
        """Topology changed: cached publish routes are stale. Mutation
        sites that know the one exchange affected pass (vhost, exchange)
        so the batch router recompiles only that table; bulk sites
        (recovery, vhost ops, queue deletion — which unbinds across
        exchanges) pass nothing and everything goes dirty. The flat route
        caches always clear outright either way."""
        if self._route_cache:
            self._route_cache.clear()
        if self._cluster_route_cache:
            self._cluster_route_cache.clear()
        if self.cluster is not None:
            self.cluster.resolve_cache.clear()
        if self.router is not None:
            self.router.invalidate(vhost, exchange)

    def flush_deferred_publishes(
        self, vhost_name: str, entries: list,
        confirm_marks: Optional[list],
    ) -> None:
        """Publish one connection's deferred fused-publish buffer: route
        the whole batch through the tensor router, then run the same
        _publish_local the inline path uses, in arrival order. Rows are
        (exchange, routing_key, props, body, header_raw, exrk_raw,
        confirmed). Never raises: defer_ok pre-validated the exchanges and
        nothing can mutate topology between deferral and flush (the
        connection flushes before every await)."""
        routes, t0, t1 = self.router.route_pending(vhost_name, entries)
        metrics = self.metrics
        prof = profile.ACTIVE
        t_enq = time.perf_counter_ns() if prof is not None else 0
        for entry, queues in zip(entries, routes):
            exchange, routing_key, props, body, header, exrk, confirmed = entry
            metrics.published(len(body))
            if trace.ACTIVE is not None:
                tr = trace.ACTIVE.begin_publish(self.trace_node,
                                                props.headers)
                if tr is not None:
                    # the whole flush routed as one kernel call: each
                    # sampled message carries the batch's ROUTE window
                    tr.span(trace.ROUTE, t0, t1, self.trace_node)
            self._publish_local(
                queues, exchange, routing_key, props, body, False,
                header, confirm_marks if confirmed else None, exrk)
        if prof is not None:
            # batch-granular ledger: one accumulate covers the whole flush
            # (route window from the router, enqueue from the loop above),
            # with calls counting messages so ns/calls reads as us/msg
            n = len(entries)
            sns, sc = prof.stage_ns, prof.stage_calls
            sns[profile.ROUTE] += t1 - t0
            sc[profile.ROUTE] += n
            sns[profile.ENQUEUE] += time.perf_counter_ns() - t_enq
            sc[profile.ENQUEUE] += n

    def spawn(self, coro: Awaitable) -> None:
        """Fire-and-forget a coroutine with a strong reference held until
        it finishes (the loop alone keeps only a weak ref)."""
        task = asyncio.get_event_loop().create_task(coro)
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)

    def account_memory(self, delta: int) -> None:
        """Track resident message-body bytes (passivation drops, hydration
        reloads, publish adds, final unrefer releases) and drive the
        overload ladder — whose throttle stage is the publisher gate —
        off the gauge."""
        self.resident_bytes += delta
        flow = self.flow
        if flow is not None:
            flow.components["bodies"] = self.resident_bytes
            flow.reevaluate()
            return
        # no flow accountant (no watermark configured anywhere): legacy
        # binary-gate bookkeeping, inert unless memory_high_watermark set
        if not self.memory_high_watermark:
            return
        if not self._mem_over and self.resident_bytes > self.memory_high_watermark:
            self._mem_over = True
            self._update_gate()
        elif self._mem_over and self.resident_bytes <= self.memory_low_watermark:
            self._mem_over = False
            self._update_gate()

    def account_held(self, delta: int) -> None:
        """Track publish bodies parked at the gate (connection hold/release/
        teardown). A separate gauge from resident_bytes — holds must never
        feed back into the gate that created them — but a real resident
        cost the flow accountant sums toward the harder stages."""
        self.held_bytes += delta
        flow = self.flow
        if flow is not None:
            flow.components["held"] = self.held_bytes
            flow.reevaluate()

    def _on_flow_stage(self, old: int, new: int) -> None:
        """Broker-side ladder actuation, then fan out to the registered
        connection/cluster listeners."""
        if new > old:
            self.metrics.flow_escalations += 1
        else:
            self.metrics.flow_deescalations += 1
        self.flow_paging = new >= STAGE_PAGE
        self.flow_page_resident_active = (
            self.flow_page_resident if self.flow_paging else 0)
        self.flow_refusing = new >= STAGE_REFUSE
        mem_over = new >= STAGE_THROTTLE
        if mem_over != self._mem_over:
            self._mem_over = mem_over
            self._update_gate()
        for listener in list(self.flow_stage_listeners):
            try:
                listener(old, new)
            except Exception:
                log.exception("flow stage listener failed")
        bus = events.ACTIVE
        if bus is not None:
            flow = self.flow
            bus.emit(f"flow.stage.{new}", {
                "old": old, "new": new,
                "stage": flow.label if flow is not None else str(new),
                "total_bytes": flow.total if flow is not None else 0,
            })

    def _update_gate(self) -> None:
        """Recompute the publisher gate from its component watermarks
        (resident RAM, store size) and fire transitions exactly once."""
        blocked = self._mem_over or self._store_over
        if blocked:
            self.blocked_reason = (
                "memory high watermark" if self._mem_over
                else "store size high watermark")
        if blocked == self.blocked:
            return
        self.blocked = blocked
        if blocked:
            self._memory_gate.clear()
        else:
            self.blocked_reason = ""
            self._memory_gate.set()
        self._notify_blocked(blocked)

    def _notify_blocked(self, blocked: bool) -> None:
        log.warning(
            "publishers %s: resident=%d/%d store=%d/%d",
            "BLOCKED" if blocked else "unblocked",
            self.resident_bytes, self.memory_high_watermark,
            self.store_bytes, self.store_max_bytes)
        for listener in list(self.blocked_listeners):
            try:
                listener(blocked)
            except Exception:
                log.exception("blocked listener failed")

    async def wait_memory_gate(self, timeout: float = 0.25) -> None:
        """One bounded wait for the memory gate. Callers loop on their own
        liveness condition (connection closing, consumer registration) so a
        parked publisher still wakes for shutdown and dead-peer teardown."""
        if not self._memory_gate.is_set():
            try:
                # no shield: cancelling Event.wait() is harmless, and a
                # shielded inner task would leak one pending task per
                # timeout tick for every parked publisher
                await asyncio.wait_for(self._memory_gate.wait(), timeout)
            except asyncio.TimeoutError:
                pass

    def account_message(self, message: Message) -> None:
        """Count a newly resident message body in the RAM gauge."""
        if message.body is not None and not message.accounted:
            self.account_memory(len(message.body))
            message.accounted = True

    def metrics_snapshot(self) -> dict:
        """Metrics counters plus broker-level gauges (the resident-memory
        gauge an operator needs to see passivation/backpressure working)."""
        snap = self.metrics.snapshot()
        snap["resident_bytes"] = self.resident_bytes
        snap["memory_blocked"] = self.blocked
        snap["memory_high_watermark"] = self.memory_high_watermark
        snap["store_bytes"] = self.store_bytes
        snap["store_max_bytes"] = self.store_max_bytes
        snap["held_bytes"] = self.held_bytes
        snap["queue_depth"] = self.queue_depth
        snap["queue_unacked"] = self.queue_unacked
        snap["queue_consumers"] = self.queue_consumers
        if self.flow is not None:
            flow = self.flow
            snap["flow_stage"] = flow.stage
            snap["flow_stage_label"] = flow.label
            snap["flow_stage_floor"] = flow.floor
            snap["flow_total_bytes"] = flow.total
            snap["flow_peak_bytes"] = flow.peak_total
            snap["flow_hard_limit"] = flow.hard_limit
            for name, value in flow.components.items():
                snap[f"flow_bytes_{name}"] = value
        if self.cluster is not None and self.cluster.replication is not None:
            snap["repl_lag_events"] = self.cluster.replication.total_lag()
        if self.telemetry is not None:
            snap.update(self.telemetry.gauges())
        if self.control is not None:
            snap.update(self.control.gauges())
        return snap

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        await self.store.open()
        await self.recover()
        if DEFAULT_VHOST not in self.vhosts:
            await self.create_vhost(DEFAULT_VHOST)
        if self.message_sweep_interval_s > 0:
            self._sweep_task = asyncio.create_task(self._sweep_loop())
        else:
            # these all piggyback on the sweep: without it they are inert —
            # say so instead of silently not protecting
            for knob, active in (
                ("chana.mq.consumer.timeout", self.consumer_timeout_ms),
                ("chana.mq.store.max-bytes", self.store_max_bytes),
            ):
                if active:
                    log.warning(
                        "%s is set but the sweep is disabled "
                        "(chana.mq.message.sweep-interval <= 0): it will "
                        "NOT be enforced", knob)
        self._started = True

    async def stop(self) -> None:
        if self._sweep_task:
            self._sweep_task.cancel()
            self._sweep_task = None
        self._flush_msg_deletes()
        # paged transient blobs are a passivation convenience, not a
        # durability promise: delete them on clean shutdown so they can't
        # accumulate as orphans (crash leftovers do linger, matching the
        # reference's Cassandra row-TTL story for passivated messages)
        paged_ids: set[int] = set()
        for vhost in self.vhosts.values():
            for queue in vhost.queues.values():
                queue.flush_store_buffers()
                # unacked deliveries hold paged messages too (a delivered-
                # but-unacked transient that was paged before hydration
                # would otherwise leave a permanent orphan blob when stop()
                # is called without connection teardown requeueing it first)
                for qm in itertools.chain(
                        queue.messages,
                        (d.queued for d in queue.outstanding.values())):
                    msg = qm.message
                    if msg.paged and not msg.persisted:
                        msg.paged = False
                        paged_ids.add(msg.id)
        if paged_ids:
            self.store_bg(self.store.delete_messages(list(paged_ids)))
        # let queued background store writes drain before closing
        await self.store.drain_nowait()
        await self.store.close()
        self._started = False

    def store_bg(self, aw: Awaitable[None]) -> None:
        """Fire-and-forget store write. Both built-in backends apply ops
        synchronously at call time (SQLite enqueues into its group-commit
        queue, MemoryStore mutates eagerly), so program order == store
        order; the store's shared tracker keeps the task alive, logs
        failures, and drains at stop()."""
        self.store._fire(aw)

    # -- recovery (reference: stash-until-Loaded preStart reloads,
    #    QueueEntity.scala:107-135, ExchangeEntity.scala:137-174) ----------

    async def recover(self) -> None:
        for name, active in await self.store.all_vhosts():
            vhost = VHost(name)
            vhost.active = active
            self.vhosts[name] = vhost
        for stored_ex in await self.store.all_exchanges():
            vhost = self.vhosts.get(stored_ex.vhost)
            if vhost is None:
                continue
            exchange = Exchange(
                stored_ex.vhost, stored_ex.name, stored_ex.type,
                durable=stored_ex.durable, auto_delete=stored_ex.auto_delete,
                internal=stored_ex.internal, arguments=stored_ex.arguments,
            )
            for routing_key, queue_name, bind_args in stored_ex.binds:
                exchange.matcher.bind(routing_key, queue_name, bind_args)
            for routing_key, dest_name, bind_args in stored_ex.ex_binds:
                exchange.ensure_ex_matcher().bind(
                    routing_key, dest_name, bind_args)
            vhost.exchanges[stored_ex.name] = exchange
        for sq in await self.store.all_queues():
            vhost = self.vhosts.get(sq.vhost)
            if vhost is None:
                continue
            vhost.queues[sq.name] = await self._load_stored_queue(sq)
        n_q = sum(len(v.queues) for v in self.vhosts.values())
        self.invalidate_routes()
        if n_q:
            log.info("recovered %d vhosts, %d queues", len(self.vhosts), n_q)

    async def _load_stored_queue(self, sq: StoredQueue) -> Queue:
        """Reconstruct one queue (pending + unacked messages) from the store
        (reference: stash-until-Loaded preStart reload, QueueEntity.scala:107-135)."""
        if sq.arguments.get("x-queue-type") == "stream":
            return await self._load_stored_stream(sq)
        queue = Queue(
            self, sq.vhost, sq.name, durable=sq.durable,
            auto_delete=sq.auto_delete, ttl_ms=sq.ttl_ms,
            arguments=sq.arguments,
        )
        queue.last_consumed = sq.last_consumed
        # pending messages + unacked (unacked become redeliverable:
        # reference re-reads queue_unacks into the pending set on reload)
        entries = list(sq.msgs) + [
            (offset, msg_id, size, exp)
            for msg_id, (offset, size, exp) in sq.unacks.items()
        ]
        entries.sort(key=lambda e: e[0])
        from .entities import QueuedMessage

        # recovery honors the passivation watermark: metadata (props header,
        # routing, refcount) loads CHUNKED so the transient meta dict never
        # double-holds the whole backlog alongside the inflated messages
        # (the reference streams per-entity, selectQueue on activation) —
        # and bodies load only for the resident head (select_message_metas
        # skips the body column)
        watermark = (queue.max_resident_override
                     if queue.max_resident_override is not None
                     else self.queue_max_resident)
        limit = watermark or len(entries)
        prio_mode = queue.max_priority is not None
        # priority queues: the post-sort head — not the lowest offsets — is
        # what dispatch serves first, so body loading waits until after the
        # sort below; plain queues keep the streaming offset-order load
        resident_ids = (set() if prio_mode
                        else set(m for (_, m, _, _) in entries[:limit]))
        max_offset = sq.last_consumed
        for start in range(0, len(entries), self.RECOVER_META_CHUNK):
            chunk = entries[start:start + self.RECOVER_META_CHUNK]
            metas = await self.store.select_message_metas(
                [msg_id for (_, msg_id, _, _) in chunk])
            bodies = await self.store.select_messages(
                [m for (_, m, _, _) in chunk
                 if m in resident_ids and m in metas])
            for offset, msg_id, size, expire_at in chunk:
                meta = metas.get(msg_id)
                if meta is None:
                    continue
                message = self._inflate(meta)
                message.refer_count = meta.refer_count
                message.persisted = True
                full = bodies.get(msg_id)
                message.body = full.body if full is not None else None
                if full is not None:
                    self.account_message(message)
                qm = QueuedMessage(message, offset, expire_at, body_size=size)
                queue.messages.append(qm)
                if message.body is None:
                    # deep-tail entry recovered without its blob: register
                    # it for batch hydration like a live passivation would
                    queue._passivated.append(qm)
                max_offset = max(max_offset, offset)
        queue.next_offset = max_offset + 1
        if prio_mode:
            # priority queues recover into (priority desc, offset) order;
            # each entry's priority comes from its recovered properties
            for qm in queue.messages:
                qm.priority = min(
                    qm.message.properties.priority or 0, queue.max_priority)
            ordered = sorted(queue.messages,
                             key=lambda q: (-q.priority, q.offset))
            queue.messages.clear()
            queue.messages.extend(ordered)
            # now load bodies for the SORTED head (what dispatch serves
            # first) and rebuild the passivated deque in matching order so
            # hydration batches align with the queue head
            head = ordered[:limit]
            head_bodies = await self.store.select_messages(
                [qm.message.id for qm in head])
            for qm in head:
                sm = head_bodies.get(qm.message.id)
                if sm is not None and qm.message.body is None:
                    qm.message.body = sm.body
                    if qm.message.header_raw is None:
                        qm.message.header_raw = sm.properties_raw
                    self.account_message(qm.message)
            queue._passivated.clear()
            queue._passivated.extend(
                qm for qm in ordered if qm.message.body is None)
        queue.ready_bytes = sum(q.body_size for q in queue.messages)
        # recovery appended to queue.messages directly (bypassing push()),
        # so credit the broker depth gauge in one bulk adjustment; recovered
        # unacks re-entered as ready messages, so no unacked adjustment
        self.queue_depth += len(queue.messages)
        if sq.unacks:
            # Recovered unacks re-enter the queue as ready messages. They
            # must survive a second crash, so convert the store rows:
            # re-insert queue_msgs, rewind the persisted watermark, then
            # drop the unack rows (FIFO store thread preserves order).
            min_unacked = min(off for (off, _, _) in sq.unacks.values())
            queue.last_consumed = min(sq.last_consumed, min_unacked - 1)
            for msg_id, (offset, size, exp) in sq.unacks.items():
                self.store_bg(self.store.insert_queue_msg(
                    sq.vhost, sq.name, offset, msg_id, size, exp))
            self.store_bg(self.store.update_queue_last_consumed(
                sq.vhost, sq.name, queue.last_consumed))
            self.store_bg(self.store.delete_queue_unacks(
                sq.vhost, sq.name, list(sq.unacks)))
        return queue

    async def _load_stored_stream(self, sq: StoredQueue) -> StreamQueue:
        """Reconstruct a stream queue: the sealed-segment index rebuilds
        from metadata only (blobs hydrate lazily when a cursor reads into
        them) and committed cursor offsets reload so reconnecting
        consumers resume where they acked."""
        queue = StreamQueue(
            self, sq.vhost, sq.name, durable=sq.durable,
            arguments=sq.arguments)
        queue.restore_segments(
            await self.store.stream_segment_metas(sq.vhost, sq.name))
        queue.committed = await self.store.select_stream_cursors(
            sq.vhost, sq.name)
        return queue

    async def activate_queue(self, vhost_name: str, name: str) -> Optional[Queue]:
        """Return the local queue, activating it from the shared store or
        replicated metadata if needed (cluster failover: the new owner
        materializes the queue on first touch, SURVEY.md §3.6)."""
        vhost = self.vhosts.get(vhost_name)
        if vhost is None:
            return None
        queue = vhost.queues.get(name)
        if queue is not None:
            return queue
        if self.cluster is not None and self.cluster.replication is not None:
            # a failover promotion may be materializing this queue from a
            # warm replica right now — racing it with the cold path below
            # would claim an empty shell over the promoted copy
            await self.cluster.replication.await_promotion(vhost_name, name)
            queue = vhost.queues.get(name)
            if queue is not None:
                return queue
        stored = await self.store.select_queue(vhost_name, name)
        if stored is not None:
            queue = await self._load_stored_queue(stored)
            # re-check: another task may have activated concurrently
            if name in vhost.queues:
                return vhost.queues[name]
            vhost.queues[name] = queue
            self.invalidate_routes()
            if self.cluster is not None:
                self.cluster.claim_queue(queue)
            return queue
        if self.cluster is not None:
            meta = self.cluster.queue_metas.get((vhost_name, name))
            if meta is not None:
                # transient clustered queue: recreate the shell (contents died
                # with the old owner, matching the reference's HA contract)
                queue = Queue(
                    self, vhost_name, name,
                    durable=bool(meta.get("durable")),
                    auto_delete=bool(meta.get("auto_delete")),
                    ttl_ms=meta.get("ttl_ms"),
                    arguments=dict(meta.get("arguments") or {}),
                )
                vhost.queues[name] = queue
                self.invalidate_routes()
                self.cluster.claim_queue(queue)
                return queue
        return None

    def _inflate(self, stored: StoredMessage) -> Message:
        _, _, props = BasicProperties.decode_header(stored.properties_raw)
        return Message(
            stored.id, props, stored.body, stored.exchange,
            stored.routing_key, stored.ttl_ms,
            header_raw=stored.properties_raw,
        )

    # -- vhosts ------------------------------------------------------------

    def vhost(self, name: str) -> VHost:
        vhost = self.vhosts.get(name)
        if vhost is None or not vhost.active:
            raise BrokerError(ErrorCode.NOT_FOUND, f"no vhost '{name}'")
        return vhost

    async def create_vhost(self, name: str) -> VHost:
        vhost = self.vhosts.get(name)
        if vhost is None:
            vhost = VHost(name)
            self.vhosts[name] = vhost
            self.invalidate_routes()
            await self.store.insert_vhost(name, True)
            if self.cluster is not None:
                self.cluster.broadcast_bg(
                    "meta.apply", {"kind": "vhost.created", "vhost": name})
            fh = events.FIREHOSE
            if fh is not None:
                fh.refresh()  # a firehose targeting this vhost can now tap
        return vhost

    async def delete_vhost(self, name: str) -> bool:
        vhost = self.vhosts.pop(name, None)
        if vhost is None:
            return False
        self.invalidate_routes()
        for queue in list(vhost.queues.values()):
            queue.deleted = True
            queue.gauges_detach()
        await self.store.delete_vhost(name)
        if self.cluster is not None:
            self.cluster.broadcast_bg(
                "meta.apply", {"kind": "vhost.deleted", "vhost": name})
        fh = events.FIREHOSE
        if fh is not None:
            fh.refresh()  # drop the deleted vhost's cached binding table
        return True

    # -- exchanges ---------------------------------------------------------

    async def declare_exchange(
        self, vhost_name: str, name: str, type: str, *,
        passive: bool = False, durable: bool = False, auto_delete: bool = False,
        internal: bool = False, arguments: Optional[dict[str, Any]] = None,
    ) -> Exchange:
        vhost = self.vhost(vhost_name)
        existing = vhost.exchanges.get(name)
        if passive:
            if existing is None:
                raise BrokerError(ErrorCode.NOT_FOUND, f"no exchange '{name}'")
            return existing
        if name.startswith("amq."):
            raise BrokerError(
                ErrorCode.ACCESS_REFUSED, f"exchange name '{name}' is reserved")
        try:
            ex_type = ExchangeType.of(type).value
        except ValueError:
            raise BrokerError(
                ErrorCode.COMMAND_INVALID, f"unknown exchange type '{type}'"
            ) from None
        alt = (arguments or {}).get("alternate-exchange")
        if alt is not None and not isinstance(alt, str):
            raise BrokerError(
                ErrorCode.PRECONDITION_FAILED, "invalid alternate-exchange")
        if existing is not None:
            if (not existing.equivalent(ex_type, durable, auto_delete, internal)
                    or existing.alternate != alt):
                # alternate-exchange is behavior-bearing: silently ignoring
                # a differing redeclare would let a client believe its AE
                # is active (RabbitMQ: 406 inequivalent arg)
                raise BrokerError(
                    ErrorCode.PRECONDITION_FAILED,
                    f"exchange '{name}' redeclared with different settings")
            return existing
        exchange = Exchange(
            vhost_name, name, ex_type, durable=durable,
            auto_delete=auto_delete, internal=internal, arguments=arguments,
        )
        vhost.exchanges[name] = exchange
        self.invalidate_routes(vhost_name, name)
        if durable:
            await self.store.insert_exchange(StoredExchange(
                vhost=vhost_name, name=name, type=ex_type, durable=durable,
                auto_delete=auto_delete, internal=internal,
                arguments=arguments or {},
            ))
        if self.cluster is not None:
            self.cluster.broadcast_bg("meta.apply", {
                "kind": "exchange.declared", "vhost": vhost_name, "name": name,
                "type": ex_type, "durable": durable,
                "auto_delete": auto_delete, "internal": internal,
                "arguments": arguments or {}, "binds": [],
            })
        return exchange

    async def delete_exchange(
        self, vhost_name: str, name: str, *, if_unused: bool = False
    ) -> None:
        vhost = self.vhost(vhost_name)
        exchange = vhost.exchanges.get(name)
        if exchange is None:
            return  # 0-9-1: deleting a missing exchange is not an error
        if name == "" or name.startswith("amq."):
            raise BrokerError(
                ErrorCode.ACCESS_REFUSED, f"exchange '{name}' is reserved")
        if if_unused and not exchange.is_unused():
            raise BrokerError(ErrorCode.PRECONDITION_FAILED, f"exchange '{name}' in use")
        del vhost.exchanges[name]
        self.invalidate_routes(vhost_name, name)
        # e2e bindings die with the exchange on BOTH sides: its own source
        # matchers go with the object; binds from other exchanges to it are
        # swept here (RabbitMQ parity)
        vhost.drop_exchange_refs(name)
        if exchange.durable:
            await self.store.delete_exchange(vhost_name, name)
        await self.store.delete_exchange_binds_dest(vhost_name, name)
        if self.cluster is not None:
            self.cluster.broadcast_bg("meta.apply", {
                "kind": "exchange.deleted", "vhost": vhost_name, "name": name})

    # -- queues ------------------------------------------------------------

    async def declare_queue(
        self, vhost_name: str, name: str, *,
        passive: bool = False, durable: bool = False, exclusive_owner: Optional[int] = None,
        auto_delete: bool = False, arguments: Optional[dict[str, Any]] = None,
        connection_id: Optional[int] = None,
    ) -> Queue:
        vhost = self.vhost(vhost_name)
        existing = vhost.queues.get(name)
        if (existing is None and self.cluster is not None
                and exclusive_owner is None
                and (vhost_name, name) in self.cluster.queue_metas
                and self.cluster.owns_queue(vhost_name, name)):
            # owned here but not yet materialized (failover / lazy activation)
            existing = await self.activate_queue(vhost_name, name)
        if passive:
            if existing is None:
                raise BrokerError(ErrorCode.NOT_FOUND, f"no queue '{name}'")
            self._check_exclusive(existing, connection_id)
            existing.touch()
            return existing
        if name.startswith("amq."):
            raise BrokerError(
                ErrorCode.ACCESS_REFUSED, f"queue name '{name}' is reserved")
        if existing is not None:
            self._check_exclusive(existing, connection_id)
            existing.touch()
            return existing
        if self.tenancy is not None:
            # tenant queue quota, checked only for NEW queues (re-declares
            # and passive declares of existing queues stay free)
            refusal = self.tenancy.queue_refusal(vhost_name)
            if refusal is not None:
                raise BrokerError(ErrorCode.PRECONDITION_FAILED, refusal)
        arguments = arguments or {}
        self._validate_queue_args(arguments)
        ttl_ms = arguments.get("x-message-ttl")
        if arguments.get("x-queue-type") == "stream":
            # streams are durable shared logs by definition (RabbitMQ
            # rejects transient/exclusive/auto-delete stream declares)
            if not durable:
                raise BrokerError(
                    ErrorCode.PRECONDITION_FAILED,
                    "stream queues must be durable")
            if exclusive_owner is not None:
                raise BrokerError(
                    ErrorCode.PRECONDITION_FAILED,
                    "stream queues cannot be exclusive")
            if auto_delete:
                raise BrokerError(
                    ErrorCode.PRECONDITION_FAILED,
                    "stream queues cannot auto-delete")
            queue: Queue = StreamQueue(
                self, vhost_name, name, durable=True, arguments=arguments)
        else:
            queue = Queue(
                self, vhost_name, name, durable=durable,
                exclusive_owner=exclusive_owner, auto_delete=auto_delete,
                ttl_ms=ttl_ms, arguments=arguments,
            )
        vhost.queues[name] = queue
        self.invalidate_routes()
        if durable and not exclusive_owner:
            await self.store.insert_queue_meta(StoredQueue(
                vhost=vhost_name, name=name, durable=durable,
                exclusive=False, auto_delete=auto_delete, ttl_ms=ttl_ms,
                last_consumed=0, arguments=arguments,
            ))
        if self.cluster is not None and exclusive_owner is None:
            self.cluster._register_meta(queue)
            epoch = self.cluster.seat_epoch(vhost_name, name)
            if self.cluster.replication is not None and not queue.is_stream:
                # per-queue replication mirrors the ready deque; stream
                # durability is the segment log itself
                self.cluster.replication.attach(queue)
            self.cluster.broadcast_bg("meta.apply", {
                "kind": "queue.declared", "vhost": vhost_name, "name": name,
                "durable": durable, "auto_delete": auto_delete,
                "ttl_ms": ttl_ms, "arguments": arguments,
                "holder": self.cluster.name, "epoch": epoch,
            })
        bus = events.ACTIVE
        if bus is not None:
            bus.emit("queue.declared", {
                "vhost": vhost_name, "queue": name, "durable": durable,
                "exclusive": exclusive_owner is not None,
                "auto_delete": auto_delete,
            })
        return queue

    def _check_exclusive(self, queue: Queue, connection_id: Optional[int]) -> None:
        if queue.exclusive_owner is not None and queue.exclusive_owner != connection_id:
            raise BrokerError(
                ErrorCode.RESOURCE_LOCKED,
                f"queue '{queue.name}' is exclusive to another connection")

    def get_queue(
        self, vhost_name: str, name: str, connection_id: Optional[int] = None
    ) -> Queue:
        vhost = self.vhost(vhost_name)
        queue = vhost.queues.get(name)
        if queue is None:
            raise BrokerError(ErrorCode.NOT_FOUND, f"no queue '{name}'")
        self._check_exclusive(queue, connection_id)
        return queue

    def queue_site(
        self, vhost_name: str, name: str, connection_id: Optional[int] = None
    ) -> tuple[str, Optional[Queue]]:
        """Locate a queue: ("local", queue) | ("activate", None) — owned here
        but not yet materialized | ("remote", None) | ("none", None)."""
        vhost = self.vhost(vhost_name)
        queue = vhost.queues.get(name)
        if queue is not None:
            self._check_exclusive(queue, connection_id)
            return ("local", queue)
        if self.cluster is not None and (vhost_name, name) in self.cluster.queue_metas:
            if self.cluster.owns_queue(vhost_name, name):
                return ("activate", None)
            return ("remote", None)
        return ("none", None)

    def _queue_is_durable(self, vhost_name: str, name: str) -> bool:
        vhost = self.vhosts.get(vhost_name)
        if vhost is not None and name in vhost.queues:
            return vhost.queues[name].durable
        if self.cluster is not None:
            meta = self.cluster.queue_metas.get((vhost_name, name))
            if meta is not None:
                return bool(meta.get("durable"))
        return False

    def _require_queue_exists(
        self, vhost_name: str, name: str, connection_id: Optional[int]
    ) -> None:
        site, _ = self.queue_site(vhost_name, name, connection_id)
        if site == "none":
            raise BrokerError(ErrorCode.NOT_FOUND, f"no queue '{name}'")

    @staticmethod
    def _validate_queue_args(arguments: dict[str, Any]) -> None:
        """Queue-argument extensions (beyond the reference's x-message-ttl):
        dead-letter routing, length/byte caps, idle expiry. Invalid values
        fail the declare with PRECONDITION_FAILED, RabbitMQ-style."""
        qtype = arguments.get("x-queue-type")
        if qtype is not None and qtype not in VALID_QUEUE_TYPES:
            raise BrokerError(
                ErrorCode.PRECONDITION_FAILED,
                f"invalid x-queue-type '{qtype}' "
                f"(one of {'/'.join(VALID_QUEUE_TYPES)})")
        for arg_name in ("x-message-ttl", "x-max-length", "x-max-length-bytes"):
            v = arguments.get(arg_name)
            if v is not None and (not isinstance(v, int) or v < 0):
                raise BrokerError(
                    ErrorCode.PRECONDITION_FAILED, f"invalid {arg_name}")
        if qtype == "stream":
            try:
                _parse_max_age_ms(arguments.get("x-max-age"))
            except ValueError as exc:
                raise BrokerError(
                    ErrorCode.PRECONDITION_FAILED, str(exc)) from None
            seg_bytes = arguments.get("x-stream-max-segment-size-bytes")
            if seg_bytes is not None and (
                    not isinstance(seg_bytes, int)
                    or isinstance(seg_bytes, bool) or seg_bytes <= 0):
                raise BrokerError(
                    ErrorCode.PRECONDITION_FAILED,
                    "invalid x-stream-max-segment-size-bytes")
            for incompatible in ("x-max-priority", "x-message-ttl",
                                 "x-dead-letter-exchange", "x-expires",
                                 "x-single-active-consumer"):
                if arguments.get(incompatible) is not None:
                    raise BrokerError(
                        ErrorCode.PRECONDITION_FAILED,
                        f"{incompatible} cannot combine with "
                        "x-queue-type=stream")
            if arguments.get("x-queue-mode") == "lazy":
                raise BrokerError(
                    ErrorCode.PRECONDITION_FAILED,
                    "x-queue-mode=lazy cannot combine with "
                    "x-queue-type=stream")
        elif arguments.get("x-max-age") is not None:
            raise BrokerError(
                ErrorCode.PRECONDITION_FAILED,
                "x-max-age requires x-queue-type=stream")
        expires = arguments.get("x-expires")
        if expires is not None and (not isinstance(expires, int) or expires <= 0):
            raise BrokerError(
                ErrorCode.PRECONDITION_FAILED, "invalid x-expires")
        dlx = arguments.get("x-dead-letter-exchange")
        if dlx is not None and not isinstance(dlx, str):
            raise BrokerError(
                ErrorCode.PRECONDITION_FAILED, "invalid x-dead-letter-exchange")
        dlx_rk = arguments.get("x-dead-letter-routing-key")
        if dlx_rk is not None and not isinstance(dlx_rk, str):
            raise BrokerError(
                ErrorCode.PRECONDITION_FAILED,
                "invalid x-dead-letter-routing-key")
        if dlx_rk is not None and dlx is None:
            raise BrokerError(
                ErrorCode.PRECONDITION_FAILED,
                "x-dead-letter-routing-key requires x-dead-letter-exchange")
        overflow = arguments.get("x-overflow")
        if overflow is not None and overflow != "drop-head":
            raise BrokerError(
                ErrorCode.PRECONDITION_FAILED,
                "only x-overflow=drop-head is supported")
        mode = arguments.get("x-queue-mode")
        if mode is not None and mode not in ("default", "lazy"):
            raise BrokerError(
                ErrorCode.PRECONDITION_FAILED, "invalid x-queue-mode")
        sac = arguments.get("x-single-active-consumer")
        if sac is not None and not isinstance(sac, bool):
            raise BrokerError(
                ErrorCode.PRECONDITION_FAILED,
                "invalid x-single-active-consumer")
        max_prio = arguments.get("x-max-priority")
        if max_prio is not None and (
                not isinstance(max_prio, int) or not 1 <= max_prio <= 255):
            raise BrokerError(
                ErrorCode.PRECONDITION_FAILED, "invalid x-max-priority")
        if max_prio is not None and mode == "lazy":
            raise BrokerError(
                ErrorCode.PRECONDITION_FAILED,
                "x-max-priority cannot combine with x-queue-mode=lazy")

    async def bind_queue(
        self, vhost_name: str, queue_name: str, exchange_name: str,
        routing_key: str, arguments: Optional[dict] = None,
        connection_id: Optional[int] = None,
    ) -> None:
        vhost = self.vhost(vhost_name)
        self._require_queue_exists(vhost_name, queue_name, connection_id)
        exchange = vhost.exchanges.get(exchange_name)
        if exchange is None:
            raise BrokerError(ErrorCode.NOT_FOUND, f"no exchange '{exchange_name}'")
        if exchange_name == "":
            raise BrokerError(
                ErrorCode.ACCESS_REFUSED, "cannot bind to the default exchange")
        if self.tenancy is not None:
            # tenant binding quota, counted live off the matchers
            # (conservative: at the cap even an idempotent re-bind refuses)
            refusal = self.tenancy.binding_refusal(vhost_name)
            if refusal is not None:
                raise BrokerError(ErrorCode.PRECONDITION_FAILED, refusal)
        added = exchange.matcher.bind(routing_key, queue_name, arguments)
        if added:
            self.invalidate_routes(vhost_name, exchange_name)
        if added and exchange.durable and self._queue_is_durable(vhost_name, queue_name):
            await self.store.insert_bind(
                vhost_name, exchange_name, queue_name, routing_key, arguments)
        if added and self.cluster is not None:
            self.cluster.broadcast_bg("meta.apply", {
                "kind": "bind.added", "vhost": vhost_name,
                "exchange": exchange_name, "queue": queue_name,
                "key": routing_key, "args": arguments,
            })

    async def bind_exchange(
        self, vhost_name: str, destination: str, source: str,
        routing_key: str, arguments: Optional[dict] = None,
    ) -> None:
        """Exchange-to-exchange binding (EXCEEDS the reference, which stubs
        Exchange.Bind with a TODO log, FrameStage.scala:1023-1027): messages
        accepted by `source` whose routing key/headers match the binding
        flow on to `destination`, which routes them further. Durable when
        both ends are durable."""
        vhost = self.vhost(vhost_name)
        src = vhost.exchanges.get(source)
        if src is None:
            raise BrokerError(ErrorCode.NOT_FOUND, f"no exchange '{source}'")
        dst = vhost.exchanges.get(destination)
        if dst is None:
            raise BrokerError(ErrorCode.NOT_FOUND, f"no exchange '{destination}'")
        if source == "" or destination == "":
            raise BrokerError(
                ErrorCode.ACCESS_REFUSED, "cannot bind the default exchange")
        if self.semantics_enabled and would_create_cycle(
                vhost, source, destination):
            # bind-time refusal (semantics/graph.py): the runtime walk is
            # cycle-safe, but a cyclic graph blocks router closure
            # flattening and is almost certainly a client bug — refuse at
            # declare time like RabbitMQ does for argument conflicts
            bus = events.ACTIVE
            if bus is not None:
                bus.emit("exchange.cycle_refused", {
                    "vhost": vhost_name, "source": source,
                    "destination": destination, "key": routing_key,
                }, vhost_name=vhost_name)
            raise BrokerError(
                ErrorCode.PRECONDITION_FAILED,
                f"binding exchange '{source}' to '{destination}' "
                "would create a cycle")
        added = src.ensure_ex_matcher().bind(routing_key, destination, arguments)
        if added:
            # an e2e bind turns a cached single-hop route stale AND makes
            # the source uncacheable (ex_matcher now set)
            self.invalidate_routes(vhost_name, source)
        if added and src.durable and dst.durable:
            await self.store.insert_exchange_bind(
                vhost_name, source, destination, routing_key, arguments)
        if added and self.cluster is not None:
            self.cluster.broadcast_bg("meta.apply", {
                "kind": "exbind.added", "vhost": vhost_name,
                "source": source, "destination": destination,
                "key": routing_key, "args": arguments,
            })

    async def unbind_exchange(
        self, vhost_name: str, destination: str, source: str,
        routing_key: str, arguments: Optional[dict] = None,
    ) -> None:
        vhost = self.vhost(vhost_name)
        src = vhost.exchanges.get(source)
        if src is None:
            raise BrokerError(ErrorCode.NOT_FOUND, f"no exchange '{source}'")
        removed = (src.ex_matcher is not None
                   and src.ex_matcher.unbind(routing_key, destination, arguments))
        if removed:
            self.invalidate_routes(vhost_name, source)
        if removed and src.durable:
            await self.store.delete_exchange_bind(
                vhost_name, source, destination, routing_key)
        if removed and self.cluster is not None:
            self.cluster.broadcast_bg("meta.apply", {
                "kind": "exbind.removed", "vhost": vhost_name,
                "source": source, "destination": destination,
                "key": routing_key, "args": arguments,
            })
        if removed and src.auto_delete and src.is_unused():
            await self.delete_exchange(vhost_name, source)

    async def unbind_queue(
        self, vhost_name: str, queue_name: str, exchange_name: str,
        routing_key: str, arguments: Optional[dict] = None,
        connection_id: Optional[int] = None,
    ) -> None:
        vhost = self.vhost(vhost_name)
        self._require_queue_exists(vhost_name, queue_name, connection_id)
        exchange = vhost.exchanges.get(exchange_name)
        if exchange is None:
            raise BrokerError(ErrorCode.NOT_FOUND, f"no exchange '{exchange_name}'")
        removed = exchange.matcher.unbind(routing_key, queue_name, arguments)
        if removed:
            self.invalidate_routes(vhost_name, exchange_name)
        if removed and exchange.durable:
            await self.store.delete_bind(
                vhost_name, exchange_name, queue_name, routing_key)
        if removed and self.cluster is not None:
            self.cluster.broadcast_bg("meta.apply", {
                "kind": "bind.removed", "vhost": vhost_name,
                "exchange": exchange_name, "queue": queue_name,
                "key": routing_key, "args": arguments,
            })
        if removed and exchange.auto_delete and exchange.is_unused():
            await self.delete_exchange(vhost_name, exchange_name)

    async def delete_queue(
        self, vhost_name: str, name: str, *,
        if_unused: bool = False, if_empty: bool = False,
        connection_id: Optional[int] = None,
    ) -> int:
        vhost = self.vhost(vhost_name)
        queue = vhost.queues.get(name)
        if queue is None and self.cluster is not None \
                and (vhost_name, name) in self.cluster.queue_metas:
            if self.cluster.owns_queue(vhost_name, name):
                queue = await self.activate_queue(vhost_name, name)
            else:
                return await self.cluster.remote_delete(
                    vhost_name, name, if_unused=if_unused, if_empty=if_empty)
        if queue is None:
            return 0
        self._check_exclusive(queue, connection_id)
        if if_unused and queue.consumer_count > 0:
            raise BrokerError(ErrorCode.PRECONDITION_FAILED, f"queue '{name}' in use")
        if if_empty and queue.message_count > 0:
            raise BrokerError(ErrorCode.PRECONDITION_FAILED, f"queue '{name}' not empty")
        return await self._remove_queue(vhost, queue)

    async def _remove_queue(self, vhost: VHost, queue: Queue) -> int:
        queue.deleted = True
        del vhost.queues[queue.name]
        self.invalidate_routes()
        count = (queue.message_count if queue.is_stream
                 else len(queue.messages))
        # drop the queue's contribution to the broker entity gauges before
        # the manual consumer/message teardown below (which bypasses the
        # incremental sites), and stop any post-delete settles double-counting
        queue.gauges_detach()
        # unbind everywhere (reference broadcasts QueueDeleted on pub-sub);
        # auto-delete sources go through delete_exchange so e2e bindings on
        # both sides are swept and the deletion replicates cluster-wide
        for exchange in list(vhost.exchanges.values()):
            if exchange.matcher.unbind_queue(queue.name) and exchange.auto_delete \
                    and exchange.is_unused() and exchange.name:
                await self.delete_exchange(vhost.name, exchange.name)
        for consumer in list(queue.consumers):
            consumer.detach()
            queue.consumers.remove(consumer)
        for qm in queue.messages:
            self.unrefer(qm.message)
        queue.messages.clear()
        if queue.durable:
            await self.store.archive_queue(vhost.name, queue.name)
            await self.store.delete_queue(vhost.name, queue.name)
            await self.store.delete_queue_binds(vhost.name, queue.name)
        if queue.is_stream:
            await self.store.delete_stream_data(vhost.name, queue.name)
        if self.cluster is not None and queue.exclusive_owner is None:
            if self.cluster.replication is not None:
                # final "delete" event tears down follower copies
                self.cluster.replication.detach(
                    vhost.name, queue.name, deleted=True)
            # the reference's QueueDeleted pub-sub broadcast
            self.cluster.queue_metas.pop((vhost.name, queue.name), None)
            self.cluster.broadcast_bg("meta.apply", {
                "kind": "queue.deleted", "vhost": vhost.name, "name": queue.name})
        bus = events.ACTIVE
        if bus is not None:
            bus.emit("queue.deleted", {
                "vhost": vhost.name, "queue": queue.name, "messages": count,
            })
        return count

    def schedule_queue_delete(
        self, vhost_name: str, queue_name: str, *, only_if_idle: bool = False
    ) -> None:
        """Auto-delete path from sync contexts (consumer cancel). With
        only_if_idle (the x-expires sweep), idleness is RE-CHECKED inside
        the task: a consumer attached or a declare/get processed between
        the sweep decision and this task running rescues the queue."""

        async def _delete() -> None:
            try:
                vhost = self.vhosts.get(vhost_name)
                if not vhost or queue_name not in vhost.queues:
                    return
                queue = vhost.queues[queue_name]
                if only_if_idle and (
                    not queue.expires_ms or queue.consumers
                    or now_ms() - queue.last_used < queue.expires_ms
                ):
                    return
                await self._remove_queue(vhost, queue)
            except Exception:
                log.exception("auto-delete of queue %s failed", queue_name)

        self.spawn(_delete())

    # -- dead-lettering (no reference analogue: RabbitMQ-style DLX) --------

    def dead_letter(self, queue: Queue, qm: "QueuedMessage", reason: str) -> None:  # noqa: F821
        """Forward a dead message (expired / rejected / maxlen-overflowed)
        to the queue's x-dead-letter-exchange, stamping the x-death header
        (count per (queue, reason), first-death markers) and clearing the
        per-message expiration so it cannot immediately re-expire in the
        dead-letter queue. Cycle safety: an automatic death (expired /
        maxlen) that has already passed through this queue for the same
        reason drops instead of looping; explicit client rejects may cycle
        (RabbitMQ semantics). A missing DLX target drops the message."""
        msg = qm.message
        props = msg.properties
        headers = dict(props.headers) if props.headers else {}
        raw_deaths = headers.get("x-death")
        deaths = ([dict(d) for d in raw_deaths if isinstance(d, dict)]
                  if isinstance(raw_deaths, list) else [])
        entry = next(
            (d for d in deaths
             if d.get("queue") == queue.name and d.get("reason") == reason),
            None)
        if entry is not None:
            if reason != "rejected" and not any(
                    d.get("reason") == "rejected" for d in deaths):
                # fully-automatic cycle (only expired/maxlen deaths in the
                # history): drop instead of looping forever. A history that
                # contains an explicit reject is a client-driven retry
                # topology (work queue -> TTL retry queue -> work queue)
                # and keeps flowing, per RabbitMQ's cycle rule.
                self.metrics.dlx_cycle_drops += 1
                self.unrefer(msg)
                return
            entry["count"] = int(entry.get("count", 1)) + 1
            # re-stamp on every death (RabbitMQ reports the LATEST death
            # time; retry-backoff consumers read x-death[0]["time"])
            entry["time"] = Timestamp(now_ms() // 1000)
            deaths.remove(entry)
            deaths.insert(0, entry)
        else:
            deaths.insert(0, {
                "queue": queue.name, "reason": reason,
                "exchange": msg.exchange,
                "routing-keys": [msg.routing_key],
                "count": 1,
                # Timestamp subclass -> wire tag 'T', matching RabbitMQ
                "time": Timestamp(now_ms() // 1000),
            })
        headers["x-death"] = deaths
        headers.setdefault("x-first-death-queue", queue.name)
        headers.setdefault("x-first-death-reason", reason)
        headers.setdefault("x-first-death-exchange", msg.exchange)
        new_props = props.copy()
        new_props.headers = headers
        new_props.expiration = None
        routing_key = queue.dlx_rk if queue.dlx_rk is not None else msg.routing_key
        self.metrics.dead_lettered_msgs += 1
        self.metrics.dlx_published += 1
        if reason == "expired":
            self.metrics.dlx_expired += 1
        elif reason == "rejected":
            self.metrics.dlx_rejected += 1
        elif reason == "maxlen":
            self.metrics.dlx_maxlen += 1
        bus = events.ACTIVE
        if bus is not None:
            bus.emit("message.dead_lettered", {
                "vhost": queue.vhost, "queue": queue.name,
                "reason": reason, "exchange": queue.dlx,
                "routing_key": routing_key,
                "count": int(deaths[0].get("count", 1)),
            }, vhost_name=queue.vhost)
        self.spawn(self._dead_letter_publish(
            queue.vhost, queue.dlx, routing_key, new_props, msg))

    async def _dead_letter_publish(
        self, vhost_name: str, exchange: str, routing_key: str,
        props: BasicProperties, msg: Message,
    ) -> None:
        """Deliver one dead-lettered message, hydrating a passivated body
        from the store first. The original reference is released only after
        the read so the blob can't be deleted out from under us."""
        try:
            body = msg.body
            if body is None:
                stored = await self.store.select_messages([msg.id])
                sm = stored.get(msg.id)
                if sm is None:
                    return  # blob already gone: nothing to forward
                body = sm.body
            if self.federation is not None:
                # remote-owner DLX routing: a federated dead-letter
                # exchange receives the copy on the far cluster too —
                # staged before the local publish, which may legitimately
                # NOT_FOUND when the exchange exists only remotely
                self.federation.on_dead_letter(
                    vhost_name, exchange, routing_key,
                    props.encode_header(len(body)), body)
            await self.publish(vhost_name, exchange, routing_key, props, body)
        except BrokerError as exc:
            log.warning("dead-letter publish to '%s' dropped: %s",
                        exchange, exc.text)
        except Exception:
            log.exception("dead-letter publish to '%s' failed", exchange)
        finally:
            self.unrefer(msg)

    # -- publish path (reference: FrameStage.scala:462-607 +
    #    ExchangeEntity.publish ExchangeEntity.scala:287-331) --------------

    async def publish(
        self,
        vhost_name: str,
        exchange_name: str,
        routing_key: str,
        properties: BasicProperties,
        body: bytes,
        *,
        mandatory: bool = False,
        immediate: bool = False,
        header_raw: Optional[bytes] = None,
        marks: Optional[list[tuple[int, int]]] = None,
        exrk_raw: Optional[bytes] = None,
        pending: Optional[list] = None,
    ) -> tuple[bool, bool]:
        """Route one message. Returns (routed, deliverable):
        routed=False    -> mandatory handling applies,
        deliverable=False (with immediate) -> immediate handling applies.
        Durability: persistent writes (message blob + queue-log residency)
        are ENQUEUED in order before return; callers that promise durability
        (publisher confirms, cluster push replies) must await
        ``self.store.flush()`` — the group-commit barrier — before doing so.
        marks, when given, collects the store-op enqueue windows of exactly
        this publish's persistent writes (captured around the synchronous
        enqueue block, so no foreign connection's ops can land inside even
        when the clustered path awaits remote pushes) — pass them to
        ``flush(intervals=...)`` for per-publisher failure attribution.
        pending, when given, pipelines plain clustered publishes: push
        records BUFFER into it (nothing is sent here) and the CALLER's
        batch barrier sends one queue.push_many per owner and awaits it —
        per-read-batch RPC round trips instead of per-message ones.
        mandatory/immediate publishes still await inline because their
        Return semantics need the owner's answer (callers drain the buffer
        first to keep per-queue FIFO)."""
        if self.cluster is None:
            return self.publish_sync(
                vhost_name, exchange_name, routing_key, properties, body,
                mandatory=mandatory, immediate=immediate,
                header_raw=header_raw, marks=marks, exrk_raw=exrk_raw)
        delay = self.delay
        if delay is not None and properties.headers is not None:
            delay_ms = parse_delay(properties.headers)
            if delay_ms is not None:
                # x-delay: park in the timer wheel and re-route at fire
                # time (mandatory/immediate are not honored for delayed
                # publishes — delayed-message-exchange plugin parity)
                delay.park(vhost_name, exchange_name, routing_key,
                           properties, body, delay_ms)
                return (True, True)
        tr = None
        t_route = 0
        if trace.ACTIVE is not None:
            tr = trace.ACTIVE.begin_publish(self.trace_node,
                                            properties.headers)
            if tr is not None:
                t_route = time.perf_counter_ns()
        vhost, queue_names = self._publish_route(
            vhost_name, exchange_name, routing_key, properties)
        self.metrics.published(len(body))
        if tr is not None:
            tr.span(trace.ROUTE, t_route, time.perf_counter_ns(),
                    self.trace_node)
        return await self._publish_clustered(
            vhost, exchange_name, routing_key, properties, body,
            queue_names, mandatory=mandatory, immediate=immediate,
            header_raw=header_raw, marks=marks, pending=pending, tr=tr)

    def publish_sync(
        self,
        vhost_name: str,
        exchange_name: str,
        routing_key: str,
        properties: BasicProperties,
        body: bytes,
        *,
        mandatory: bool = False,
        immediate: bool = False,
        header_raw: Optional[bytes] = None,
        marks: Optional[list[tuple[int, int]]] = None,
        exrk_raw: Optional[bytes] = None,
    ) -> tuple[bool, bool]:
        """publish() for the single-node case: identical semantics (the
        local branch never awaits anything), as a plain call so the
        per-message hot loop skips the coroutine machinery. Callers must
        check ``broker.cluster is None`` first."""
        assert self.cluster is None
        delay = self.delay
        if delay is not None and properties.headers is not None:
            delay_ms = parse_delay(properties.headers)
            if delay_ms is not None:
                delay.park(vhost_name, exchange_name, routing_key,
                           properties, body, delay_ms)
                return (True, True)
        tr = None
        t_route = 0
        if trace.ACTIVE is not None:
            tr = trace.ACTIVE.begin_publish(self.trace_node,
                                            properties.headers)
            if tr is not None:
                t_route = time.perf_counter_ns()
        prof = profile.ACTIVE
        t_prof = time.perf_counter_ns() if prof is not None else 0
        cache = self._route_cache
        if cache is not None:
            key = (vhost_name, exchange_name, routing_key)
            queues = cache.get(key)
            if queues is not None:
                # cache hit: resolved Queue objects, no matcher walk
                self.metrics.published(len(body))
                if tr is not None:
                    tr.span(trace.ROUTE, t_route, time.perf_counter_ns(),
                            self.trace_node)
                if prof is not None:
                    return self._publish_local_profiled(
                        prof, t_prof, queues, exchange_name, routing_key,
                        properties, body, immediate, header_raw, marks,
                        exrk_raw)
                return self._publish_local(
                    queues, exchange_name, routing_key, properties,
                    body, immediate, header_raw, marks, exrk_raw)
        vhost, queue_names = self._publish_route(
            vhost_name, exchange_name, routing_key, properties)
        self.metrics.published(len(body))
        queues = [vhost.queues[qn] for qn in queue_names if qn in vhost.queues]
        if cache is not None:
            exchange = vhost.exchanges.get(exchange_name)
            if exchange_name == "" or (
                exchange is not None
                and exchange.ex_matcher is None
                and exchange.alternate is None
                and exchange.type != "headers"
            ):
                if len(cache) >= self._ROUTE_CACHE_MAX:
                    cache.clear()
                    self._route_cache_strikes += 1
                    if self._route_cache_strikes >= self._ROUTE_CACHE_STRIKES:
                        self._route_cache = None
                if self._route_cache is not None:
                    cache[key] = queues
        if tr is not None:
            tr.span(trace.ROUTE, t_route, time.perf_counter_ns(),
                    self.trace_node)
        if prof is not None:
            return self._publish_local_profiled(
                prof, t_prof, queues, exchange_name, routing_key,
                properties, body, immediate, header_raw, marks, exrk_raw)
        return self._publish_local(
            queues, exchange_name, routing_key, properties,
            body, immediate, header_raw, marks, exrk_raw)

    def _publish_local_profiled(
        self, prof, t0: int, queues, exchange_name, routing_key,
        properties, body, immediate, header_raw, marks, exrk_raw,
    ) -> tuple[bool, bool]:
        """publish_sync tail with the cost ledger armed: t0 (taken before
        the route lookup) to here is ROUTE, the _publish_local call is
        ENQUEUE. Split out so the disabled path pays nothing but the
        ACTIVE check."""
        t1 = time.perf_counter_ns()
        out = self._publish_local(
            queues, exchange_name, routing_key, properties,
            body, immediate, header_raw, marks, exrk_raw)
        sns, sc = prof.stage_ns, prof.stage_calls
        sns[profile.ROUTE] += t1 - t0
        sc[profile.ROUTE] += 1
        sns[profile.ENQUEUE] += time.perf_counter_ns() - t1
        sc[profile.ENQUEUE] += 1
        return out

    def cluster_route_cached(
        self, vhost_name: str, exchange_name: str, routing_key: str,
    ) -> bool:
        """Whether publish_clustered_fast will hit for this route (checked
        before arming a confirm so a miss has zero side effects)."""
        cache = self._cluster_route_cache
        return cache is not None \
            and (vhost_name, exchange_name, routing_key) in cache

    def publish_clustered_fast(
        self, vhost_name: str, exchange_name: str, routing_key: str,
        properties: BasicProperties, body: bytes,
        header_raw: Optional[bytes],
        marks: Optional[list[tuple[int, int]]], pending: list,
    ) -> tuple[bool, bool]:
        """publish() for the clustered pipelined case on a route-cache hit:
        identical semantics to _publish_clustered's pending branch (plain
        publish, no mandatory/immediate), as a plain call — no coroutine,
        no exchange walk, no ring hashing, and the push-record meta head
        comes pre-encoded from the cache. Callers must check
        cluster_route_cached first."""
        local, remote = self._cluster_route_cache[
            (vhost_name, exchange_name, routing_key)]
        delay = self.delay
        if delay is not None and properties.headers is not None:
            delay_ms = parse_delay(properties.headers)
            if delay_ms is not None:
                delay.park(vhost_name, exchange_name, routing_key,
                           properties, body, delay_ms)
                return (True, True)
        self.metrics.published(len(body))
        tr = None
        if trace.ACTIVE is not None:
            tr = trace.ACTIVE.begin_publish(self.trace_node,
                                            properties.headers)
            if tr is not None:
                # the route is a dict hit: charge it as one stamp pair
                t_route = time.perf_counter_ns()
                tr.span(trace.ROUTE, t_route, time.perf_counter_ns(),
                        self.trace_node)
        if not local and not remote:
            return (False, True)
        props_raw = header_raw if header_raw is not None \
            else properties.encode_header(len(body))
        if tr is None:
            for owner, names, head in remote:
                pending.append((owner, (
                    vhost_name, names, exchange_name, routing_key,
                    props_raw, body, head)))
        else:
            # 8th element rides into PeerDataPlane.submit_push as its
            # trace kwarg via submit_batch's *rec unpacking
            for owner, names, head in remote:
                pending.append((owner, (
                    vhost_name, names, exchange_name, routing_key,
                    props_raw, body, head, tr)))
        if local:
            self.push_local(local, properties, body, exchange_name,
                            routing_key, props_raw, marks)
        return (True, True)

    def _publish_route(
        self, vhost_name: str, exchange_name: str, routing_key: str,
        properties: BasicProperties,
    ) -> tuple[VHost, set[str]]:
        vhost = self.vhost(vhost_name)
        exchange = vhost.exchanges.get(exchange_name)
        if exchange is None:
            raise BrokerError(ErrorCode.NOT_FOUND, f"no exchange '{exchange_name}'")
        if exchange.internal:
            raise BrokerError(
                ErrorCode.ACCESS_REFUSED, f"exchange '{exchange_name}' is internal")
        if exchange_name == "":
            # default exchange: implicit binding by queue name; a clustered
            # queue may exist only as replicated metadata on this node
            exists = routing_key in vhost.queues or (
                self.cluster is not None
                and (vhost_name, routing_key) in self.cluster.queue_metas)
            queue_names = {routing_key} if exists else set()
        else:
            cluster = self.cluster
            queue_names = vhost.route(
                exchange_name, routing_key, properties.headers,
                queue_exists=(
                    (lambda rk: (vhost_name, rk) in cluster.queue_metas)
                    if cluster is not None else None))
            assert queue_names is not None
        return vhost, queue_names

    def _publish_local(
        self,
        queues: list[Queue],
        exchange_name: str,
        routing_key: str,
        properties: BasicProperties,
        body: bytes,
        immediate: bool,
        header_raw: Optional[bytes],
        marks: Optional[list[tuple[int, int]]],
        exrk_raw: Optional[bytes] = None,
    ) -> tuple[bool, bool]:
        if not queues:
            return (False, True)
        if immediate and not any(
            any(c.can_take(len(body)) for c in q.consumers) for q in queues
        ):
            return (True, False)
        self.push_local(
            queues, properties, body, exchange_name, routing_key,
            header_raw, marks, exrk_raw)
        return (True, True)

    def push_local(
        self,
        queues: list[Queue],
        properties: BasicProperties,
        body: bytes,
        exchange_name: str,
        routing_key: str,
        header_raw: Optional[bytes],
        marks: Optional[list[tuple[int, int]]],
        exrk_raw: Optional[bytes] = None,
    ) -> Message:
        """The one local persistent-enqueue block, shared by the single-node
        publish, the clustered publish, and the cluster push handler: build
        the Message, decide persistence (reference: ExchangeEntity.scala:302
        — message persistent AND >=1 routed queue durable), enqueue the blob
        (not awaited: the queue-log rows from queue.push() land in the SAME
        group-commit batch, so one commit covers the message and all its
        residencies), push to every queue with body_size computed once
        (fanout passivation safety), and record the attribution window."""
        mark0 = self.store.mark()
        tr = None
        t_enq = 0
        if trace.ACTIVE is not None:
            tr = trace.ACTIVE.current
            if tr is not None:
                t_enq = time.perf_counter_ns()
                if tr.w3c is not None:
                    # propagated context: one copy-on-write header rewrite
                    # here covers EVERY egress of this message — consumer
                    # deliveries, the persisted blob, stream records (and
                    # through them federated FED_SHIP segments), and
                    # staged FED_TX/FED_PUBLISH frames all render from
                    # these properties once header_raw is dropped
                    properties, changed = stamp_headers(properties, tr.w3c)
                    if changed:
                        header_raw = None
                # routing attributes for the trace query layer / OTLP
                # render (sampled messages only; setdefault keeps the
                # origin's routing when a clustered push re-applies)
                tr.attr("vhost", queues[0].vhost)
                tr.attr("exchange", exchange_name)
                tr.attr("routing_key", routing_key)
                tr.attr("queue", ",".join(q.name for q in queues))
                registry = self.tenancy
                if registry is not None:
                    owner = registry.tenant_of_vhost(queues[0].vhost)
                    if owner is not None:
                        tr.attr("tenant", owner)
        message = Message(
            self.idgen.next_id(), properties, body, exchange_name, routing_key,
            properties.expiration_ms(), header_raw=header_raw,
        )
        message.exrk_raw = exrk_raw
        if tr is not None:
            message.trace = tr
        message.refer_count = len(queues)
        self.account_message(message)
        # streams never reference the shared Message after push (the log
        # copies the bytes into its own record), so they neither persist
        # the blob nor may a classic sibling passivate the body before the
        # stream's copy: persistence keys on classic durables only, and
        # streams go FIRST in the fanout
        persist = message.is_persistent and any(
            q.durable and not q.is_stream for q in queues)
        if len(queues) > 1 and any(q.is_stream for q in queues):
            queues = sorted(queues, key=lambda q: not q.is_stream)
        if persist:
            message.persisted = True
            self.store.insert_message_nowait(StoredMessage(
                id=message.id,
                properties_raw=message.header_payload(),
                body=body, exchange=exchange_name, routing_key=routing_key,
                refer_count=len(queues), ttl_ms=message.ttl_ms,
            ))
        body_size = len(body)
        for queue in queues:
            queue.push(message, body_size=body_size)
        if tr is not None:
            tr.span(trace.ENQUEUE, t_enq, time.perf_counter_ns(),
                    self.trace_node)
            if tr.w3c is not None and all(q.is_stream for q in queues):
                # stream records are COPIES of this message: nothing ever
                # delivers/settles this Message object, so the origin half
                # of a forced trace completes at append. The consumer side
                # (local cursor reads, or a federated mirror) continues
                # under the same W3C trace id via the stamped record
                # headers. Seeded traces keep their existing lifecycle.
                trace.ACTIVE.finish(tr)
        if marks is not None:
            mark1 = self.store.mark()
            if mark1 > mark0:
                marks.append((mark0, mark1))
        fh = events.FIREHOSE
        if fh is not None and fh.tap_bindings:
            fh.tap_publish(exchange_name, routing_key, body, queues)
        return message

    async def _publish_clustered(
        self, vhost: VHost, exchange_name: str, routing_key: str,
        properties: BasicProperties, body: bytes, queue_names: set[str],
        *, mandatory: bool, immediate: bool,
        header_raw: Optional[bytes] = None,
        marks: Optional[list[tuple[int, int]]] = None,
        pending: Optional[list] = None,
        tr=None,
    ) -> tuple[bool, bool]:
        """Cluster publish: routing already happened locally on the
        replicated exchange metadata; per-owner queue.push RPCs carry the
        message to remote queue owners (the reference's ExchangeEntity ->
        QueueEntity ask path, ExchangeEntity.scala:287-331, with one hop
        instead of two)."""
        assert self.cluster is not None
        local: list[Queue] = []
        by_owner: dict[str, list[str]] = {}
        for name in queue_names:
            queue = vhost.queues.get(name)
            if queue is not None:
                local.append(queue)
                continue
            if (vhost.name, name) not in self.cluster.queue_metas:
                continue
            if self.cluster.owns_queue(vhost.name, name):
                activated = await self.activate_queue(vhost.name, name)
                if activated is not None:
                    local.append(activated)
            else:
                owner = self.cluster.queue_owner(vhost.name, name)
                by_owner.setdefault(owner, []).append(name)
        cache = self._cluster_route_cache
        if cache is not None and pending is not None \
                and not mandatory and not immediate:
            exchange = vhost.exchanges.get(exchange_name)
            if exchange_name == "" or (
                exchange is not None
                and exchange.ex_matcher is None
                and exchange.alternate is None
                and exchange.type != "headers"
            ):
                from ..cluster.dataplane import encode_push_meta_head
                remote = [
                    (owner, names, encode_push_meta_head(
                        vhost.name, names, exchange_name, routing_key))
                    for owner, names in by_owner.items()]
                if len(cache) >= self._ROUTE_CACHE_MAX:
                    cache.clear()
                    self._cluster_route_strikes += 1
                    if self._cluster_route_strikes >= self._ROUTE_CACHE_STRIKES:
                        self._cluster_route_cache = None
                if self._cluster_route_cache is not None:
                    cache[(vhost.name, exchange_name, routing_key)] = (
                        list(local), remote)
        if not local and not by_owner:
            return (False, True)
        props_raw = header_raw if header_raw is not None \
            else properties.encode_header(len(body))
        had_consumer = any(
            any(c.can_take(len(body)) for c in q.consumers) for q in local
        )
        if immediate:
            # immediate is all-or-none like the single-node path: probe every
            # owner first (no enqueue), then either push everywhere or nowhere
            for owner, names in by_owner.items():
                try:
                    _, owner_had = await self.cluster.remote_push(
                        owner, vhost.name, names, props_raw, body,
                        exchange_name, routing_key, check_consumers=True,
                        check_only=True)
                    had_consumer = had_consumer or owner_had
                except Exception as exc:
                    log.warning("remote consumer probe to %s failed: %r", owner, exc)
            if not had_consumer:
                return (True, False)
        pushed_remote = False
        if pending is not None and not mandatory and not immediate:
            # pipelined: buffer the push record; the caller's batch barrier
            # submits them to the binary data plane and awaits the covering
            # micro-batches — per-batch round trips instead of per-message,
            # and the body bytes ride by reference all the way to the
            # socket. routed is reported optimistically; a failed push
            # surfaces at the barrier (confirm-mode: connection error,
            # never a false confirm; else best-effort, logged)
            for owner, names in by_owner.items():
                if tr is None:
                    pending.append((owner, (
                        vhost.name, names, exchange_name, routing_key,
                        props_raw, body)))
                else:
                    pending.append((owner, (
                        vhost.name, names, exchange_name, routing_key,
                        props_raw, body, None, tr)))
                pushed_remote = True
        else:
            for owner, names in by_owner.items():
                try:
                    pushed, owner_had_consumer = await self.cluster.remote_push(
                        owner, vhost.name, names, props_raw, body,
                        exchange_name, routing_key, check_consumers=False,
                        tr=tr)
                    pushed_remote = pushed_remote or pushed
                    had_consumer = had_consumer or owner_had_consumer
                except Exception as exc:
                    log.warning("remote push to %s failed: %r", owner, exc)
        if not local and not pushed_remote:
            # every target was remote and none accepted: unroutable in effect
            return (False, True)
        if local:
            if tr is not None and trace.ACTIVE is not None:
                # re-pin: awaits above may have run other publishes
                trace.ACTIVE.current = tr
            self.push_local(
                local, properties, body, exchange_name, routing_key,
                props_raw, marks)
        return (True, True)

    # -- message refcounting (reference: MessageEntity.scala:134-166) ------

    def unrefer(self, message: Message) -> None:
        self.unrefer_n(message, 1)

    def unrefer_n(self, message: Message, n: int) -> None:
        message.refer_count -= n
        if message.refer_count <= 0 and message.accounted:
            self.account_memory(-len(message.body or b""))
            message.accounted = False
        if message.refer_count <= 0 and (message.persisted or message.paged):
            message.persisted = False
            message.paged = False
            # coalesce per loop tick: one executemany instead of a store op
            # per message (ids are snowflakes, never reused, so a delayed
            # delete can't clash with a later insert)
            buf = self._msg_delete_buf
            buf.append(message.id)
            if len(buf) == 1:
                asyncio.get_event_loop().call_soon(self._flush_msg_deletes)

    def _flush_msg_deletes(self) -> None:
        ids, self._msg_delete_buf = self._msg_delete_buf, []
        if ids:
            self.store_bg(self.store.delete_messages(ids))

    async def _sample_store_size(self) -> None:
        """One store-size sample for the store-growth gate: over at the
        cap, back under at 80% of it (hysteresis like the RAM gate)."""
        try:
            size = await self.store.approx_data_bytes()
        except Exception:
            log.exception("store size sample failed")
            return
        if size is None:
            return  # backend cannot report; gate inert
        self.store_bytes = size
        if not self._store_over and size > self.store_max_bytes:
            self._store_over = True
            self._update_gate()
        elif self._store_over and size <= int(self.store_max_bytes * 0.8):
            self._store_over = False
            self._update_gate()

    def _flow_tick(self, stream_cache_bytes: int) -> None:
        """One sweep-tick sample of the polled accountant components (WAL
        memtable, data-plane buffers, connection out-buffers, stream sealed
        cache, chaos inflation), then a single ladder reevaluation. The
        hot components (bodies, held) are pushed synchronously elsewhere;
        hooking these cold ones at their mutation sites would tax every
        WAL append and socket write for sweep-tick-freshness data."""
        flow = self.flow
        c = flow.components
        c["stream_cache"] = stream_cache_bytes
        c["wal_memtable"] = int(
            getattr(self.store, "memtable_pending_bytes", 0) or 0)
        c["cluster_inflight"] = (
            self.cluster.dataplane_buffered_bytes()
            if self.cluster is not None else 0)
        out_buffers = 0
        for conn in self.connections:
            out_buffers += len(conn._out)
        c["out_buffers"] = out_buffers
        if chaos.ACTIVE is not None:
            fault = chaos.ACTIVE.decide("flow.tick")
            c["chaos"] = (
                fault.inflate_bytes
                if fault is not None and fault.kind == "pressure" else 0)
        flow.reevaluate()

    # -- TTL sweep ---------------------------------------------------------

    async def _sweep_loop(self) -> None:
        """Periodic head-expiry pass so TTL'd messages don't linger in
        consumerless queues (the reference used per-entity timers,
        MessageEntity.scala:168-198)."""
        try:
            while True:
                await asyncio.sleep(self.message_sweep_interval_s)
                if self.store_max_bytes:
                    await self._sample_store_size()
                now = now_ms()
                expired_queues: list[Queue] = []
                overdue_channels: set = set()
                timeout = self.consumer_timeout_ms
                stream_cache_bytes = 0
                for vhost in self.vhosts.values():
                    for queue in vhost.queues.values():
                        before = len(queue.messages)
                        queue._expire_head()
                        self.metrics.expired_msgs += before - len(queue.messages)
                        if queue.is_stream:
                            stream_cache_bytes += queue.cache_bytes
                        elif self.flow_paging:
                            # stage >= 1: page bodies beyond the pressure
                            # cap out of queues that aren't receiving
                            # pushes (the push path handles active ones)
                            queue.passivate_excess(self.flow_page_resident)
                        # x-expires: the queue itself dies after idling
                        # unused (no consumers, no gets/declares)
                        if (queue.expires_ms and not queue.consumers
                                and now - queue.last_used >= queue.expires_ms):
                            expired_queues.append(queue)
                if self.flow is not None:
                    self._flow_tick(stream_cache_bytes)
                if self.tenancy is not None:
                    # refill tenant token buckets and move memory-share
                    # floors (one pass over the registry per sweep)
                    self.tenancy.tick(self.message_sweep_interval_s or 1.0)
                if timeout:
                    # ack timeout: walk every live connection's channels —
                    # the one registry where every outstanding delivery
                    # appears (local consume/get, remotely-owned queues,
                    # and settles parked in uncommitted transactions)
                    cutoff = now - timeout
                    for conn in list(self.connections):
                        for channel in list(conn.channels.values()):
                            if channel.closed:
                                continue
                            if channel.has_delivery_older_than(cutoff):
                                overdue_channels.add(channel)
                for queue in expired_queues:
                    log.info("queue %s idle-expired (x-expires=%dms)",
                             queue.name, queue.expires_ms)
                    self.schedule_queue_delete(
                        queue.vhost, queue.name, only_if_idle=True)
                for channel in overdue_channels:
                    log.warning(
                        "channel %d: delivery ack timeout (%d ms), closing",
                        channel.id, timeout)
                    self.spawn(
                        channel.connection.close_channel_ack_timeout(channel))
        except asyncio.CancelledError:
            pass
