"""Layered configuration tree.

Capability parity with the reference's Typesafe-HOCON settings system
(chana-mq-base Settings.scala:29-219 and the reference.conf trees,
chana-mq-server reference.conf:107-179): a typed accessor layer over layered
sources — built-in defaults <- config file (JSON) <- environment variables —
keeping the reference's knob names (dotted paths under ``chana.mq``) where
they exist, e.g.:

    chana.mq.amqp.interface / port / amqps.port      (listeners)
    chana.mq.amqp.connection.heartbeat / frame-max / channel-max
    chana.mq.internal.timeout                        (internal op timeout)
    chana.mq.message.inactive                        (passivation age)
    chana.mq.admin.port                              (localhost admin REST)
    chana.mq.vhost.separator / default
    chana.mq.store.path                              (sqlite file; absent =
                                                      in-memory transient)
    chana.mq.cluster.*                               (cluster layer)

Env override: dots/dashes become underscores, upper-cased, prefixed CHANAMQ_
(e.g. CHANAMQ_AMQP_PORT=5673 overrides chana.mq.amqp.port).

Durations accept int seconds or strings like "30s"/"500ms"/"infinite"
(the reference's "infinite"-aware parser, Settings.scala:60-77); sizes accept
int bytes or "128KiB"/"4MiB".
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Mapping, Optional

DEFAULTS: dict[str, Any] = {
    "chana.mq.amqp.interface": "0.0.0.0",
    "chana.mq.amqp.port": 5672,
    "chana.mq.amqp.amqps.enabled": False,
    "chana.mq.amqp.amqps.port": 5671,
    "chana.mq.amqp.amqps.certfile": None,
    "chana.mq.amqp.amqps.keyfile": None,
    "chana.mq.amqp.connection.heartbeat": "30s",
    "chana.mq.amqp.connection.frame-max": "128KiB",
    "chana.mq.amqp.connection.channel-max": 2047,
    # listener resource limits (reference: ServerSettings max-connections /
    # backlog, Settings.scala:141-219). Connections beyond max-connections
    # are refused at accept time with a TCP close; existing traffic is
    # unaffected. 0 disables the cap.
    "chana.mq.server.max-connections": 1024,
    "chana.mq.server.backlog": 128,
    # optional SASL PLAIN verification: {"user": "password", ...}. Empty
    # disables verification (the reference parses but never verifies,
    # SaslMechanism.scala:49-76); configuring users also refuses EXTERNAL.
    "chana.mq.auth.users": None,
    # optional per-user vhost allowlists: {"user": ["/", "tenant-a"], ...}.
    # Only consulted when users are configured; a user absent from the map
    # may open ANY vhost (allowlist opt-in per user).
    "chana.mq.auth.permissions": None,
    # delivery acknowledgement timeout (RabbitMQ consumer_timeout, same
    # 30-minute default): a delivery unacked past this closes its channel
    # with PRECONDITION_FAILED and requeues. "infinite" disables.
    "chana.mq.consumer.timeout": "30m",
    "chana.mq.internal.timeout": "20s",
    "chana.mq.message.inactive": "1h",
    "chana.mq.message.sweep-interval": "1s",
    # per-queue resident-message watermark: beyond this many queued messages,
    # durable+persistent bodies are paged out to the store and hydrated back
    # on demand (the reference's passivation knob chana.mq.message.inactive,
    # MessageEntity.scala:168-198, recast from age-based to depth-based).
    # 0 disables passivation.
    "chana.mq.queue.max-resident": 16384,
    # inbound publisher backpressure: above high-watermark resident message
    # bytes, publishing connections stop being read (and capable clients get
    # Connection.Blocked) until the gauge falls below low-watermark.
    # 0 / null disables the gate (per-queue passivation still bounds memory).
    "chana.mq.memory.high-watermark": "512MiB",
    "chana.mq.memory.low-watermark": None,  # default: 80% of high
    # flow-control ladder (chanamq_tpu/flow/): one MemoryAccountant sums
    # every accounted resident cost (queue bodies, parked publishes,
    # connection out-buffers, WAL memtable, data-plane buffers, stream
    # cache) and degrades gracefully through four stages, mildest first:
    #   1 page      > page-watermark:   page bodies to the store early
    #   2 throttle  > high-watermark:   Channel.Flow(false) + publish
    #                                   credit, then parked reads (the
    #                                   legacy memory gate, now staged)
    #   3 cluster   > cluster-watermark: shrink data-plane windows, stall
    #                                   inbound cluster push batches
    #   4 refuse    > refuse-watermark: refuse new publishes (406) while
    #                                   consumers drain; /admin/health
    #                                   goes not-ready
    # Each stage exits at (enter * low/high) — the same hysteresis the
    # binary gate had, so no stage can flap. The memory.high/low
    # watermarks above anchor the ladder; these knobs tune the rest
    # (None = derived defaults, shown beside each).
    "chana.mq.flow.page-watermark": None,     # default 60% of high
    "chana.mq.flow.cluster-watermark": None,  # default midway high->refuse
    "chana.mq.flow.refuse-watermark": None,   # default 90% of hard
    "chana.mq.flow.hard-limit": None,         # default 2x high
    # bytes a throttled connection may still publish before its reads
    # park (grace for clients honoring Channel.Flow); 0 = park at once
    "chana.mq.flow.publish-credit": "256KiB",
    # per-consumer delivery-buffer bound: a consumer whose unsent
    # rendered deliveries exceed this is skipped by dispatch (and counted
    # slow) until the connection's output buffer drains. 0 = unbounded.
    "chana.mq.flow.consumer-buffer": "4MiB",
    # per-connection parked-publish cap while the gate is closed
    # (overrides the built-in 256KiB when set)
    "chana.mq.flow.park-buffer": None,
    # resident-per-queue cap while the ladder is at/above the page stage
    # (tightens chana.mq.queue.max-resident under pressure)
    "chana.mq.flow.page-resident": 256,
    "chana.mq.admin.enabled": True,
    "chana.mq.admin.interface": "127.0.0.1",
    "chana.mq.admin.port": 15672,
    "chana.mq.vhost.default": "/",
    # declared-content-size cap per message: chunks buffer in the command
    # assembler before backpressure can account them (0 = unlimited)
    "chana.mq.message.max-size": "128MiB",
    "chana.mq.store.path": None,
    # sqlite PRAGMA synchronous: NORMAL survives process crashes (WAL
    # replay); FULL additionally fsyncs every group commit so confirmed
    # messages survive power loss, at a persistent-throughput cost
    "chana.mq.store.synchronous": "NORMAL",
    # write-ahead log engine (chanamq_tpu/wal/): when a store path is set,
    # durable mutations append to a per-shard segment log whose commit loop
    # batches ONE fsync across all channels/queues/subsystems per flush
    # window; SQLite becomes the read index, drained by a background
    # checkpointer. false = store-direct (the pre-WAL behavior).
    "chana.mq.wal.enabled": True,
    # group-commit window: an append waits at most this long for peers to
    # share its fsync (latency floor for awaited durable ops and confirms)
    "chana.mq.wal.flush-ms": 2,
    # cut the window early once this many bytes are buffered
    "chana.mq.wal.flush-bytes": "1MiB",
    # active segment seals at this size; sealed segments are truncated
    # whole once the checkpoint covers them
    "chana.mq.wal.segment-bytes": "64MiB",
    # durability tier: "fsync" survives power loss (fsync per group
    # commit + SQLite checkpoint fsync); "os" leaves commits in the OS
    # page cache — survives SIGKILL, not power loss — and skips both
    "chana.mq.wal.sync": "fsync",
    # checkpoint cadence: drain committed records into the SQLite index,
    # truncate covered segments, run stream-segment maintenance
    "chana.mq.wal.checkpoint-ms": 1000,
    # memtable cap: pending index ops (and their overlay blobs) drain
    # early once they outgrow this, bounding RAM between checkpoints
    "chana.mq.wal.memtable-bytes": "64MiB",
    # tiered offload: keep this many newest sealed stream segments hot in
    # SQLite; older blobs move to side files (index rows stay, reads
    # rehydrate). 0 disables offload.
    "chana.mq.wal.tier-keep-segments": 2,
    # key compaction for stream queues declared with x-stream-compact:
    # newest record per routing key survives in sealed segments
    "chana.mq.wal.compact-streams": True,
    # store-growth gate: when passivation/page-out absorbs a flood, RAM
    # stays flat but the store grows — above this live-data size the
    # publisher gate closes (like the memory watermark), reopening at 80%.
    # None/0 disables. Sampled each sweep tick.
    "chana.mq.store.max-bytes": None,
    # telemetry forecasting (models/service.py): sample broker metrics into
    # a ring each interval; train/predict the JAX forecaster off the event
    # loop every train-interval; serve GET /admin/forecast + Prometheus
    # gauges. Off by default — enabling spins an accelerator workload.
    "chana.mq.forecast.enabled": False,
    "chana.mq.forecast.interval": "1s",
    "chana.mq.forecast.train-interval": "30s",
    "chana.mq.forecast.window": 64,     # telemetry vectors per model input
    "chana.mq.forecast.history": 4096,  # ring capacity (vectors retained)
    # per-queue forecaster awareness: widen the feature vector with
    # (depth, publish_rate) of the K busiest queues from the per-entity
    # telemetry rings. 0 = node-total features only; >0 requires
    # chana.mq.telemetry.enabled.
    "chana.mq.forecast.queue-top-k": 0,
    # predictive control plane (control/): closes the forecast->actuation
    # loop. Each interval a ControlService snapshots flow-ladder state,
    # telemetry and (when fresh + trusted) the forecast, evaluates
    # off-loop, and emits hysteresis-guarded decisions: predictive
    # admission (pre-arm the stage-2 throttle + shrink publish credit
    # before the watermark), proactive queue rebalancing (holdership
    # handoff toward the cluster mean), and prefetch autotuning (nudge
    # the consume-credit window). Off by default; dry-run by default when
    # on — decisions are logged + counted but actuate nothing until
    # dry-run is lifted (the rollout path; also POST /admin/control).
    "chana.mq.control.enabled": False,
    "chana.mq.control.dry-run": True,
    "chana.mq.control.interval": "1s",
    "chana.mq.control.horizon": "5s",        # projection lookahead
    "chana.mq.control.arm-ticks": 2,         # consecutive trigger ticks
    "chana.mq.control.cooldown": "10s",      # per-kind decision spacing
    "chana.mq.control.admission.enabled": True,
    "chana.mq.control.admission.credit-factor": 0.5,
    "chana.mq.control.admission.credit-min": "4KB",
    "chana.mq.control.rebalance.enabled": True,
    "chana.mq.control.rebalance.ratio": 1.5,  # self vs cluster-mean load
    "chana.mq.control.rebalance.min-rate": "1KB",  # bytes/s floor
    "chana.mq.control.rebalance.cooldown": "30s",
    "chana.mq.control.prefetch.enabled": True,
    "chana.mq.control.prefetch.min": 8,
    "chana.mq.control.prefetch.max": 256,
    "chana.mq.control.log-size": 256,        # retained decisions
    "chana.mq.control.forecast-max-age": "10s",
    # trust gate: use the forecast only while its publish-bytes-rate MAE
    # stays under this fraction of the observed inflow; otherwise fall
    # back to the reactive trend
    "chana.mq.control.forecast-error-gate": 0.5,
    # per-entity telemetry (telemetry/): fixed-slot timeseries ring per
    # queue and per connection, sampled off the hot path each interval;
    # event-loop lag + sampler saturation probes; /admin/timeseries,
    # /admin/health (readiness with reasons), /admin/alerts
    "chana.mq.telemetry.enabled": False,
    "chana.mq.telemetry.interval": "1s",
    "chana.mq.telemetry.ring-ticks": 120,      # history per entity
    "chana.mq.telemetry.max-queues": 512,      # entity slots (fixed memory)
    "chana.mq.telemetry.max-connections": 256,
    "chana.mq.telemetry.top-k": 8,             # default top-K summary size
    # readiness thresholds (/admin/health flips 503 past these)
    "chana.mq.telemetry.ready-loop-lag-ms": 1000,
    "chana.mq.telemetry.ready-repl-lag": 10000,
    "chana.mq.telemetry.store-error-window": 30,  # ticks
    # declarative alert rules evaluated over the per-entity matrix each
    # tick (telemetry/alerts.py): thresholds for the four built-ins;
    # hysteresis is tick-counted inside the rules
    "chana.mq.alerts.enabled": True,   # gates evaluation, not sampling
    "chana.mq.alerts.backlog-growth": 100,   # ready msgs gained per window
    "chana.mq.alerts.backlog-window": 5,     # growth lookback, ticks
    "chana.mq.alerts.stall-ticks": 3,        # zero-deliver ticks -> stall
    "chana.mq.alerts.repl-lag": 1000,        # events behind
    "chana.mq.alerts.loop-lag-ms": 250,      # event-loop lag
    "chana.mq.alerts.memory-stage": 3.5,     # flow stage (fires at refuse)
    "chana.mq.cluster.enabled": False,
    "chana.mq.cluster.host": "127.0.0.1",
    "chana.mq.cluster.port": 25672,
    "chana.mq.cluster.seeds": [],
    "chana.mq.cluster.heartbeat-interval": "1s",
    "chana.mq.cluster.failure-timeout": "5s",
    "chana.mq.cluster.virtual-nodes": 64,
    # interconnect data plane (cluster/dataplane.py): parallel binary
    # streams per peer, per-stream pipelining window, and the adaptive
    # micro-batch flush window (cut early by the byte/count caps)
    "chana.mq.cluster.streams": 2,
    "chana.mq.cluster.stream-inflight": 32,
    "chana.mq.cluster.flush-window-us": 200,
    "chana.mq.cluster.flush-max-bytes": "1MiB",
    "chana.mq.cluster.flush-max-count": 512,
    "chana.mq.cluster.consume-credit": 1024,
    "chana.mq.cluster.call-timeout": "10s",
    # multi-process sharding (chanamq_tpu/shard/): count > 1 makes
    # `python -m chanamq_tpu.broker.server` run a supervisor that spawns
    # one worker process per shard; 0 = auto (os.cpu_count()); 1 = off.
    # Workers share the AMQP port via SO_REUSEPORT (or the fd-handoff
    # acceptor when reuse-port is unavailable) and talk to each other
    # over Unix sockets in shard.dir using the binary data plane.
    "chana.mq.shard.count": 1,
    "chana.mq.shard.dir": "",              # "" = <store dir or cwd>/shards
    "chana.mq.shard.reuse-port": True,     # False forces the fd handoff
    # intra-node membership runs much tighter than WAN defaults: sibling
    # death must re-hash ownership in well under a second
    "chana.mq.shard.heartbeat-interval": "200ms",
    "chana.mq.shard.failure-timeout": "1.5s",
    # supervisor restart throttle for crashed workers
    "chana.mq.shard.restart-backoff": "500ms",
    "chana.mq.shard.max-restarts": 16,     # per shard; then left down
    # queue replication (replicate/): each queue's mutations are log-shipped
    # to factor-1 follower nodes which keep a warm passive copy; on owner
    # death the highest-synced follower promotes. factor=1 disables.
    "chana.mq.replicate.factor": 1,
    # sync=true gates publisher confirms on follower acks (no confirmed
    # persistent message can be lost to a single node failure); sync=false
    # ships asynchronously (bounded loss window = replication lag).
    "chana.mq.replicate.sync": False,
    "chana.mq.replicate.batch-max": 256,   # events per shipped batch
    "chana.mq.replicate.ack-timeout-ms": 1000,
    # node lifecycle (cluster/lifecycle.py): graceful drain / decommission.
    # A draining node stops taking new holdership, evacuates every held
    # queue via handoff with bounded retry, then gossips `left`.
    "chana.mq.lifecycle.drain-retry-limit": 5,
    "chana.mq.lifecycle.drain-backoff": "100ms",      # first retry delay
    "chana.mq.lifecycle.drain-backoff-cap": "2s",     # retry delay ceiling
    # evacuation budget: past this the drain-stuck alert fires (the drain
    # itself keeps retrying as long as any pass still makes progress)
    "chana.mq.lifecycle.drain-budget": "30s",
    # stream queues (streams/): append-only segmented logs declared with
    # x-queue-type=stream. The active in-memory segment seals and spills
    # to the store at segment-bytes or segment-age, whichever first
    # (x-stream-max-segment-size-bytes overrides the size per queue).
    "chana.mq.stream.segment-bytes": "1MiB",
    "chana.mq.stream.segment-age": "10s",
    # sealed segments kept hot in RAM; replaying cursors reload evicted
    # blobs from the store one segment at a time
    "chana.mq.stream.cache-segments": 4,
    # records one cursor may take per coalesced dispatch pass (fairness
    # slice across cursors; prefetch credit still gates each delivery)
    "chana.mq.stream.delivery-batch": 128,
    # fault injection (chanamq_tpu/chaos/): disabled by default — the
    # broker's I/O seams stay no-op hooks unless this is set at boot
    "chana.mq.chaos.enabled": False,
    # RNG seed for the deterministic fault schedule (same seed = same run)
    "chana.mq.chaos.seed": 0,
    # optional path to a JSON fault-plan file installed at boot; empty =
    # chaos armed but idle until a plan arrives via POST /admin/chaos/install
    "chana.mq.chaos.plan": "",
    # message tracing (chanamq_tpu/trace/): disabled by default — every
    # hot-path seam stays a module-level `ACTIVE is None` check
    "chana.mq.trace.enabled": False,
    # fraction of publishes that mint a trace (0.0 .. 1.0); the sampling
    # RNG is seeded from the chaos seed so soak runs sample deterministically
    "chana.mq.trace.sample-rate": 0.01,
    # completed traces kept in the recent ring (slow/chaos-tagged traces
    # get a second ring of the same size so they survive churn)
    "chana.mq.trace.ring-size": 256,
    # traces slower end-to-end than this always land in the slow ring
    "chana.mq.trace.slow-ms": 250,
    # structured JSON log lines stamped with node id + active trace id
    "chana.mq.log.json": False,
    # OTLP span export (chanamq_tpu/otel/): drains completed traces into
    # OTLP/HTTP JSON batches. Requires chana.mq.trace.enabled to have
    # anything to export. With an empty endpoint the exporter runs in
    # collector-less mode: completed traces queue (bounded) for the pull
    # fallback GET /admin/otel/spans instead of being pushed.
    "chana.mq.otel.enabled": False,
    # OTLP/HTTP collector URL, e.g. http://127.0.0.1:4318/v1/traces
    "chana.mq.otel.endpoint": "",
    # push flush window (batches post at most this often)
    "chana.mq.otel.flush-ms": 1000,
    # max traces rendered into one OTLP/HTTP POST
    "chana.mq.otel.max-batch": 64,
    # bounded exporter queue; overflow (or flow stage >= 1) sheds with
    # the otel_spans_shed counter instead of growing memory
    "chana.mq.otel.queue-size": 1024,
    # data-parallel tensorized router (chanamq_tpu/router/): fused single
    # node publishes defer into a per-connection buffer and the whole read
    # batch routes through compiled binding tables in one kernel call.
    # The Python matchers stay as the always-available fallback (and the
    # parity oracle); disabling restores per-message routing everywhere.
    "chana.mq.router.enabled": True,
    # "torch" runs the match kernels as hand-written CUDA on the router
    # device (chanamq_tpu_torch/csrc/router_match.cu), or their plain
    # PyTorch versions when that device is the CPU; "python" runs the
    # reference kernel body on plain numpy. Any other value is an error.
    "chana.mq.router.backend": "torch",
    # torch.device holding the router's tables. "cuda" needs a card: with
    # none, the first kernel batch raises rather than run on the CPU.
    # "cpu" is for tests and hosts without a card.
    "chana.mq.router.device": "cuda",
    # flushes smaller than this skip the kernel and walk the matcher —
    # below ~16 messages the per-call dispatch overhead beats the win
    "chana.mq.router.min-batch": 16,
    # caps on what compiles: an exchange with more wildcard topic patterns
    # (or headers bindings) than max-wildcards, or more kernel-routed
    # queues than max-queues, stays on the Python matcher. Exact-match
    # patterns are host dicts and don't count against either cap.
    "chana.mq.router.max-wildcards": 512,
    "chana.mq.router.max-queues": 4096,
    # cross-check every kernel batch against the Python oracle and prefer
    # the oracle on mismatch (router_parity_mismatches counts them) —
    # a debugging net, not for production throughput
    "chana.mq.router.verify": False,
    # advanced delivery semantics (chanamq_tpu/semantics/): atomic Tx
    # commits on the WAL scope, bind-time e2e cycle refusal, and x-delay
    # delayed delivery. Off removes the per-publish x-delay probe and the
    # cycle check; queue-argument features (x-max-priority ordering,
    # dead-lettering) are declared per queue and stay on either way.
    "chana.mq.semantics.enabled": True,
    # timer-wheel granularity for x-delay delayed delivery: fires land
    # within one tick after their delay elapses
    "chana.mq.semantics.delay-tick": "50ms",
    # native batch egress (native/chanamq_native.cpp): basic.deliver
    # records from a dispatch pass render in ONE chana_encode_deliveries
    # call into a pooled native buffer, and the connection writer drains
    # its buffer list with scatter-gather sendmsg. Off (or a missing /
    # stale native lib, or CHANAMQ_NATIVE=0) restores per-delivery Python
    # rendering; wire bytes are identical either way.
    "chana.mq.native.egress": True,
    # egress arena sizing: buffers x buffer-kb is the pooled memory the
    # process reserves (defaults: 16 x 256 KiB = 4 MiB); batches larger
    # than one buffer, or arriving while the pool is dry, fall back to a
    # fresh heap buffer (native_pool_exhausted counts the dry acquires)
    "chana.mq.native.pool-buffers": 16,
    "chana.mq.native.pool-buffer-kb": 256,
    # continuous profiling (chanamq_tpu/profile/): disabled by default —
    # every hot-path seam stays a module-level `ACTIVE is None` check.
    # Enabled, the per-message cost ledger accumulates per-stage CPU-ns
    # into fixed numpy vectors (batch-granular on the batched paths) and
    # serves GET /admin/profile + profile_stage_* Prometheus series
    "chana.mq.profile.enabled": False,
    # stack-sampling rate for the folded-stack profiler thread
    # (GET /admin/profile/stacks); 0 = sampler off, watchdog only
    "chana.mq.profile.sample-hz": 0,
    # event-loop callbacks stalling the loop longer than this are captured
    # (stack + duration) into the slow-callback ring, logged as structured
    # JSON, and counted in profile_slow_callbacks_total; 0 = watchdog off
    "chana.mq.profile.slow-callback-ms": 100,
    # bounded ring of recent slow-callback captures kept for /admin/profile
    "chana.mq.profile.ring-size": 64,
    # attribute collector pauses via gc.callbacks (the "gc" ledger stage)
    "chana.mq.profile.gc": True,
    # broker-native event bus (chanamq_tpu/events/): internal transitions
    # (alert.fired.<rule>, control.decision.<kind>, lifecycle.<state>,
    # flow.stage.<n>, chaos.fired.<rule>, profile.slow-callback,
    # connection.*, queue.*, shard.restarted, slo.burn-rate.<name>)
    # published as AMQP messages on the amq.chanamq.event topic exchange
    # of this vhost. Off = every emit seam is one `ACTIVE is None` check;
    # on with nothing bound = O(1) counted drop per event.
    "chana.mq.events.enabled": False,
    "chana.mq.events.vhost": "/",
    # firehose tracer: republish every publish/deliver into
    # amq.chanamq.trace (keys publish.<exchange> / deliver.<queue>),
    # shedding taps whenever the flow accountant leaves stage 0 so a slow
    # firehose consumer can never build unbounded memory. queue-filter
    # narrows the tap to queues whose name starts with the prefix.
    "chana.mq.firehose.enabled": False,
    "chana.mq.firehose.vhost": "/",
    "chana.mq.firehose.queue-filter": "",
    # tenant-filter sibling of queue-filter: when set, only taps whose
    # vhost belongs to the named tenant are republished (requires
    # chana.mq.tenant.enabled).
    "chana.mq.firehose.tenant": "",
    # multi-tenancy (chanamq_tpu/tenancy/): tenants map is
    # {"name": {"vhosts": [...], "users": {...}, "acls": {...},
    #  "quota": {"max-connections": N, ..., "memory-share": 0.25,
    #  "publish-rate": bytes/s, "publish-burst": bytes}} — see
    # tenancy.registry for the full spec. Tenants declared while
    # enabled=false are a boot error (fail closed, like auth knobs).
    "chana.mq.tenant.enabled": False,
    "chana.mq.tenant.tenants": None,
    # SLO engine (chanamq_tpu/slo/): burn-rate error budgets over the
    # telemetry tick (requires chana.mq.telemetry.enabled). Default specs
    # cover publish availability, delivery success, readiness, and
    # delivery p99 latency; replace them with chana.mq.slo.specs (a JSON
    # list, see slo.specs_from_json) or POST /admin/slo/configure.
    "chana.mq.slo.enabled": False,
    "chana.mq.slo.objective": 0.999,        # default success-ratio target
    "chana.mq.slo.latency-ms": 250,         # p99 bound for the latency SLO
    "chana.mq.slo.fast-burn": 14.4,         # 5m/1h pair burn threshold
    "chana.mq.slo.slow-burn": 6.0,          # 6h/3d pair burn threshold
    "chana.mq.slo.specs": None,
    # a federation-lag SLI tick is good while every link's record lag is
    # at or under this bound (slo/__init__.py samples it per link)
    "chana.mq.slo.federation-lag-records": 1000,
    # cross-cluster federation (chanamq_tpu/federation/): a dedicated
    # listener serves the fed.* handlers (mirror side); links is a JSON
    # array of {name, host, port, vhost, queues, exchanges, window}
    # specs naming the remotes this node ships to (shipper side).
    "chana.mq.federation.enabled": False,
    "chana.mq.federation.interface": "127.0.0.1",
    "chana.mq.federation.port": 0,          # 0 = ephemeral (tests/bench)
    "chana.mq.federation.links": None,
    "chana.mq.federation.window": 4,        # per-link in-flight sends
    "chana.mq.federation.retry": "500ms",   # down-link reconnect pace
    "chana.mq.federation.idle-tick": "200ms",  # pump tick with no wake
    # shared secret on the fed listener; "" = open (trusted network).
    # The listener sits outside the AMQP SASL/ACL path, so this token is
    # its whole admission control. Links present it outbound too (a
    # per-link `token` in the spec overrides for asymmetric pairs).
    "chana.mq.federation.auth-token": "",
}

_DURATION_RE = re.compile(r"^\s*([0-9.]+)\s*(ms|s|m|h|d)?\s*$")
_DURATION_UNITS = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}
_SIZE_RE = re.compile(r"^\s*([0-9.]+)\s*(B|KiB|KB|MiB|MB|GiB|GB)?\s*$", re.I)
_SIZE_UNITS = {
    "b": 1, "kib": 1024, "kb": 1000, "mib": 1024**2,
    "mb": 1000**2, "gib": 1024**3, "gb": 1000**3,
}


class ConfigError(ValueError):
    pass


def parse_duration_s(value: Any) -> Optional[float]:
    """'30s' -> 30.0; 'infinite'/'off'/None -> None (disabled)."""
    if value is None:
        return None
    if isinstance(value, (int, float)):
        return float(value)
    text = str(value).strip().lower()
    if text in ("infinite", "inf", "off", "none"):
        return None
    match = _DURATION_RE.match(text)
    if not match:
        raise ConfigError(f"bad duration: {value!r}")
    return float(match.group(1)) * _DURATION_UNITS.get(match.group(2) or "s", 1.0)


def parse_size_bytes(value: Any) -> Optional[int]:
    if value is None:
        return None
    if isinstance(value, (int, float)):
        return int(value)
    match = _SIZE_RE.match(str(value))
    if not match:
        raise ConfigError(f"bad size: {value!r}")
    return int(float(match.group(1)) * _SIZE_UNITS[(match.group(2) or "B").lower()])


def _env_key(path: str) -> str:
    # chana.mq.amqp.frame-max -> CHANAMQ_AMQP_FRAME_MAX
    trimmed = path[len("chana.mq."):] if path.startswith("chana.mq.") else path
    return "CHANAMQ_" + trimmed.replace(".", "_").replace("-", "_").upper()


# keys whose VALUE is a mapping: flattening stops here so a config file's
# {"auth": {"users": {...}}} arrives as one dict, not per-user leaf keys
_DICT_LEAF_KEYS = frozenset(
    {"chana.mq.auth.users", "chana.mq.auth.permissions",
     "chana.mq.tenant.tenants"})


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    flat: dict[str, Any] = {}
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        full = path if path.startswith("chana.") else f"chana.mq.{path}"
        if isinstance(value, Mapping) and full not in _DICT_LEAF_KEYS:
            flat.update(_flatten(value, path))
        else:
            flat[path] = value
    return flat


class Config:
    """Layered key-value config with typed accessors."""

    def __init__(
        self,
        overrides: Optional[Mapping[str, Any]] = None,
        *,
        file: Optional[str] = None,
        env: Optional[Mapping[str, str]] = None,
    ) -> None:
        self._values = dict(DEFAULTS)
        if file:
            with open(file) as f:
                loaded = json.load(f)
            flat = _flatten(loaded)
            for key, value in flat.items():
                # accept both full paths and paths relative to chana.mq
                full = key if key.startswith("chana.") else f"chana.mq.{key}"
                self._values[full] = value
        env = os.environ if env is None else env
        for path in list(self._values):
            env_value = env.get(_env_key(path))
            if env_value is not None:
                if path in _DICT_LEAF_KEYS:
                    # dict-valued key from the environment: JSON only
                    # (e.g. CHANAMQ_AUTH_USERS='{"alice": "pw"}')
                    try:
                        parsed = json.loads(env_value)
                    except json.JSONDecodeError as exc:
                        raise ConfigError(
                            f"{_env_key(path)} must be a JSON object: {exc}"
                        ) from None
                    if not isinstance(parsed, dict):
                        raise ConfigError(
                            f"{_env_key(path)} must be a JSON object")
                    self._values[path] = parsed
                else:
                    self._values[path] = _coerce(env_value, self._values[path])
        if overrides:
            for key, value in overrides.items():
                full = key if key.startswith("chana.") else f"chana.mq.{key}"
                self._values[full] = value

    def get(self, path: str, default: Any = None) -> Any:
        return self._values.get(path, default)

    def str(self, path: str) -> str:
        return str(self._values[path])

    def int(self, path: str) -> int:
        return int(self._values[path])

    def bool(self, path: str) -> bool:
        value = self._values[path]
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)

    def duration_s(self, path: str) -> Optional[float]:
        return parse_duration_s(self._values[path])

    def size_bytes(self, path: str) -> Optional[int]:
        return parse_size_bytes(self._values[path])

    def list(self, path: str) -> list:
        value = self._values[path]
        if isinstance(value, str):
            return [part.strip() for part in value.split(",") if part.strip()]
        return list(value or [])

    def dump(self) -> dict[str, Any]:
        return dict(self._values)


def _coerce(text: str, previous: Any) -> Any:
    if isinstance(previous, bool):
        return text.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(previous, int) and not isinstance(previous, bool):
        try:
            return int(text)
        except ValueError:
            return text
    if isinstance(previous, float):
        try:
            return float(text)
        except ValueError:
            return text
    if isinstance(previous, list):
        return [part.strip() for part in text.split(",") if part.strip()]
    return text
