"""Broker metrics registry: counters + latency histogram.

The reference has no metrics subsystem — throughput was measured by grepping
log lines (SURVEY.md §5 "observability", chana-mq-test/perf/sum-published.sh)
and no latency measurement existed at all. This registry supplies what
BASELINE.md needs: publish/deliver counters and publish->deliver latency
percentiles, with negligible hot-path cost.
"""

from __future__ import annotations

from bisect import bisect_left
import time
from typing import Optional


class Histogram:
    """Fixed-bucket log-scale latency histogram (microseconds)."""

    # bucket upper bounds in us: 1,2,5,10,...,1e7 (10 s), +inf
    BOUNDS = [
        1, 2, 5, 10, 20, 50, 100, 200, 500,
        1_000, 2_000, 5_000, 10_000, 20_000, 50_000,
        100_000, 200_000, 500_000, 1_000_000, 2_000_000, 5_000_000, 10_000_000,
    ]

    def __init__(self) -> None:
        self.buckets = [0] * (len(self.BOUNDS) + 1)
        self.count = 0
        self.total_us = 0

    def observe_us(self, us: float) -> None:
        # once per delivered message: bisect, not a linear bound walk (at
        # saturated latencies the walk visited most of the 22 bounds)
        self.count += 1
        self.total_us += int(us)
        self.buckets[bisect_left(self.BOUNDS, us)] += 1

    def percentile_us(self, p: float) -> Optional[float]:
        """Upper-bound estimate of the p-quantile (p in [0,1])."""
        if self.count == 0:
            return None
        target = p * self.count
        seen = 0
        for i, n in enumerate(self.buckets):
            seen += n
            if seen >= target:
                return float(self.BOUNDS[i]) if i < len(self.BOUNDS) else float("inf")
        return float("inf")

    @property
    def mean_us(self) -> Optional[float]:
        return self.total_us / self.count if self.count else None


class Metrics:
    def __init__(self) -> None:
        self.published_msgs = 0
        self.published_bytes = 0
        self.delivered_msgs = 0
        self.delivered_bytes = 0
        self.returned_msgs = 0
        self.confirmed_msgs = 0
        self.expired_msgs = 0
        self.dead_lettered_msgs = 0
        self.connections_opened = 0
        self.connections_closed = 0
        # accepts refused at the listener cap (chana.mq.server.max-connections)
        self.connections_refused = 0
        self.publish_to_deliver_us = Histogram()
        # queue replication (replicate/): owner-side ship + follower-side
        # apply counters and the owner-observed follower ack latency
        self.repl_events_shipped = 0
        self.repl_batches_shipped = 0
        self.repl_events_applied = 0
        self.repl_resyncs = 0
        self.repl_promotions = 0
        self.repl_ack_timeouts = 0
        self.repl_ack_us = Histogram()
        # stream queues (streams/): append/seal/truncate volume plus
        # cursor activity (deliveries count records read, commits count
        # monotonic cursor advances on ack)
        self.stream_appends = 0
        self.stream_append_bytes = 0
        self.stream_segments_sealed = 0
        self.stream_segments_truncated = 0
        self.stream_records_delivered = 0
        self.stream_cursor_commits = 0
        # consumer groups on streams (streams/groups.py)
        self.stream_groups_created = 0
        self.stream_group_deliveries = 0
        # cluster interconnect data plane (cluster/dataplane.py): binary
        # frame volume, batch sizes, and what cut each batch (window timer,
        # byte cap, count cap, or a barrier demanding an early flush)
        self.rpc_data_bytes_sent = 0
        self.rpc_data_bytes_recv = 0
        self.rpc_push_records = 0
        self.rpc_push_batches = 0
        self.rpc_settle_records = 0
        self.rpc_settle_batches = 0
        self.rpc_deliver_records = 0
        self.rpc_deliver_batches = 0
        self.rpc_flush_window = 0
        self.rpc_flush_bytes = 0
        self.rpc_flush_count = 0
        self.rpc_flush_demand = 0
        # fault injection (chanamq_tpu/chaos/): all zero unless a plan fires
        self.chaos_fires = 0
        self.chaos_latency = 0
        self.chaos_errors = 0
        self.chaos_drops = 0
        self.chaos_disconnects = 0
        self.chaos_corrupt_frames = 0
        self.chaos_crashes = 0
        self.chaos_partition_drops = 0
        # message tracing (chanamq_tpu/trace/): all zero unless installed.
        # trace_stage_us is populated with one Histogram per pipeline stage
        # by TraceRuntime at install time (key: trace_<stage>_us).
        self.trace_sampled = 0
        self.trace_completed = 0
        self.trace_slow = 0
        self.trace_chaos_tagged = 0
        self.trace_ctx_sent = 0
        self.trace_ctx_recv = 0
        self.trace_evicted = 0
        self.trace_stage_us: "dict[str, Histogram]" = {}
        # OTLP interop (chanamq_tpu/otel/): forced samples minted for
        # client-supplied traceparent headers, spans exported (push and
        # pull combined), OTLP/HTTP batches posted, failed posts, traces
        # shed by the bounded exporter queue / overload ladder, and pull
        # requests served on /admin/otel/spans. All zero unless a
        # traceparent arrives or chana.mq.otel.enabled is set.
        self.otel_forced_samples = 0
        self.otel_spans_exported = 0
        self.otel_batches_sent = 0
        self.otel_export_errors = 0
        self.otel_spans_shed = 0
        self.otel_pull_served = 0
        # per-entity telemetry (chanamq_tpu/telemetry/): sampler progress,
        # ring-slot pressure, and alert-engine transitions. All zero unless
        # the telemetry service is running (chana.mq.telemetry.enabled).
        self.telemetry_ticks = 0
        self.telemetry_saturated_ticks = 0
        self.telemetry_evicted_entities = 0
        self.telemetry_dropped_entities = 0
        self.alerts_fired = 0
        self.alerts_resolved = 0
        # write-ahead log engine (chanamq_tpu/wal/): append/commit volume,
        # checkpoint + recovery accounting, stream-segment tier offload and
        # key compaction. All zero unless chana.mq.wal.enabled with a store.
        self.wal_appends = 0
        self.wal_append_bytes = 0
        self.wal_commits = 0
        self.wal_fsyncs = 0
        self.wal_commit_errors = 0
        self.wal_segments_sealed = 0
        self.wal_segments_truncated = 0
        self.wal_checkpoints = 0
        self.wal_checkpoint_errors = 0
        self.wal_recovered_records = 0
        self.wal_recover_torn = 0
        self.wal_recover_corrupt = 0
        self.wal_tier_offloads = 0
        self.wal_tier_rehydrations = 0
        self.wal_compactions = 0
        self.wal_compacted_records = 0
        self.wal_memtable_drains = 0
        self.wal_memtable_elided = 0
        self.wal_memtable_hits = 0
        self.wal_tx_batches = 0
        self.wal_tx_batch_ops = 0
        self.wal_commit_us = Histogram()
        # multi-process sharding (chanamq_tpu/shard/): cross-shard UDS
        # pushes, ownership re-hashes observed on sibling death, and the
        # restart generation the supervisor hands a respawned worker.
        self.shard_cross_pushes = 0
        self.shard_handoffs = 0
        self.shard_restarts = 0
        # overload protection (chanamq_tpu/flow/): ladder transitions,
        # stage-1 pressure paging, stage-2 throttle signals and the time
        # publishes spend parked, stage-3 cluster stalls, stage-4
        # refusals, and per-consumer delivery-buffer saturation. All
        # zero unless a flow watermark is configured.
        self.flow_escalations = 0
        self.flow_deescalations = 0
        self.flow_paged_bodies = 0
        self.flow_paged_bytes = 0
        self.flow_throttles = 0
        self.flow_resumes = 0
        self.flow_hold_releases = 0
        self.flow_hold_wait_ns = 0
        self.flow_cluster_stalls = 0
        self.flow_publishes_refused = 0
        self.flow_slow_consumers = 0
        # predictive control plane (chanamq_tpu/control/): ticks evaluated,
        # decisions emitted by the engine, decisions actually actuated,
        # triggers blocked by hysteresis/cooldown, decisions recorded in
        # dry-run without actuation, and apply/tick failures
        self.control_ticks = 0
        self.control_decisions = 0
        self.control_applied = 0
        self.control_suppressed = 0
        self.control_dry_run = 0
        self.control_errors = 0
        self.chaos_pressure = 0
        # node lifecycle (chanamq_tpu/cluster/lifecycle.py): drains run on
        # this node, queues it evacuated, activate retries + holdership
        # rollbacks during evacuation, fencing-epoch refusals (stale
        # broadcasts, ships, and writes), join-triggered rebalances this
        # node's control plane emitted, and stale holderships cleared by
        # anti-entropy / lifecycle events.
        self.lifecycle_drains_started = 0
        self.lifecycle_queues_evacuated = 0
        self.lifecycle_evacuation_retries = 0
        self.lifecycle_rollbacks = 0
        self.lifecycle_stale_epoch_refused = 0
        self.lifecycle_join_rebalances = 0
        self.lifecycle_stale_holders_cleared = 0
        # tensorized router (chanamq_tpu/router/): kernel batches routed,
        # messages in them, table compiles + the current generation (gauge),
        # messages that fell back to the Python matcher (uncompilable
        # exchange or sub-min-batch flush), and verify-mode parity
        # mismatches (always 0 unless a kernel bug slips parity testing).
        # router_batch_size is a Histogram over flush batch sizes —
        # messages per kernel call, not microseconds.
        self.router_batches = 0
        self.router_batch_msgs = 0
        self.router_compiles = 0
        self.router_generation = 0
        self.router_fallback_msgs = 0
        self.router_parity_mismatches = 0
        self.router_batch_size = Histogram()
        # native batch egress (native/chanamq_native.cpp): delivery
        # batches rendered by chana_encode_deliveries, the messages and
        # wire bytes they covered, pool-dry acquires that fell back to a
        # heap buffer, and defensive encode fallbacks to the Python
        # renderer (a size disagreement — never expected)
        self.native_egress_batches = 0
        self.native_egress_msgs = 0
        self.native_egress_bytes = 0
        self.native_egress_fallbacks = 0
        self.native_pool_exhausted = 0
        # continuous profiling (chanamq_tpu/profile/): stack-sampler
        # samples taken, event-loop callbacks caught over the slow
        # threshold, and collector pauses seen by the gc hook. All zero
        # unless chana.mq.profile.enabled. The _total suffix is baked
        # into the attribute so the Prometheus series follow the naming
        # convention for counters that grew up later.
        self.profile_samples_total = 0
        self.profile_slow_callbacks_total = 0
        self.profile_gc_pauses_total = 0
        self.profile_gc_pause_ns_total = 0
        # event bus + firehose (chanamq_tpu/events/): events that reached
        # at least one bound queue vs O(1) drops (nothing bound, or the
        # bus swallowed an emit error), and firehose taps published vs
        # shed (flow stage > 0 or no trace binding). All zero unless
        # chana.mq.events.enabled / chana.mq.firehose.enabled.
        self.events_published_total = 0
        self.events_dropped_total = 0
        self.firehose_published_total = 0
        self.firehose_dropped_total = 0
        # SLO engine (chanamq_tpu/slo/): burn-rate alert firings across
        # all specs and window pairs (per-spec counts live in the engine
        # snapshot and the chanamq_slo_violations_total labeled series)
        self.slo_violations_total = 0
        # multi-tenancy (chanamq_tpu/tenancy/): tenant gate transitions
        # (token bucket drained / memory share breached, and the matching
        # resumes), quota refusals at the declare/open mutation sites, and
        # ACL denials mapped to access-refused. All zero unless
        # chana.mq.tenant.enabled.
        self.tenancy_throttles_total = 0
        self.tenancy_resumes_total = 0
        self.tenancy_quota_refusals_total = 0
        self.tenancy_acl_denials_total = 0
        # delivery semantics (chanamq_tpu/semantics/): Tx commits/rollbacks
        # on the WAL scope, delayed-delivery timer-wheel traffic, priority
        # fan enqueues, and dead-letter outcomes (cycle suppressions are
        # fully-automatic x-death loops dropped per the RabbitMQ rule).
        self.semantics_tx_commits = 0
        self.semantics_tx_rollbacks = 0
        self.semantics_delayed_msgs = 0
        self.semantics_delay_fired = 0
        self.semantics_priority_msgs = 0
        self.dlx_published = 0
        self.dlx_cycle_drops = 0
        self.dlx_expired = 0
        self.dlx_rejected = 0
        self.dlx_maxlen = 0
        # federation (chanamq_tpu/federation/): sealed-segment shipping,
        # mirrored cursor commits, DLX forwards and staged Tx batches
        # across named links, both the shipping and the receiving side.
        self.federation_segments_shipped = 0
        self.federation_segment_bytes = 0
        self.federation_segments_applied = 0
        self.federation_duplicate_segments = 0
        self.federation_crc_failures = 0
        self.federation_ship_errors = 0
        self.federation_resyncs = 0
        self.federation_resumes = 0
        self.federation_link_failures = 0
        self.federation_cursors_shipped = 0
        self.federation_cursors_mirrored = 0
        self.federation_dlx_forwarded = 0
        self.federation_tx_batches = 0
        self.federation_tx_publishes = 0
        self.federation_tx_applied = 0
        self.federation_outbox_dropped = 0
        self.federation_outbox_dropped_publish = 0
        self.federation_outbox_dropped_tx = 0
        self.federation_duplicate_forwards = 0
        self.federation_invalid_segments = 0
        self.federation_auth_failures = 0
        # anti-entropy peers skipped because the lifecycle machine marked
        # them LEFT (satellite of the federation PR)
        self.lifecycle_left_peer_skipped = 0
        self.started_at = time.time()

    def published(self, nbytes: int) -> None:
        self.published_msgs += 1
        self.published_bytes += nbytes

    def delivered(self, nbytes: int) -> None:
        self.delivered_msgs += 1
        self.delivered_bytes += nbytes

    def histograms(self) -> "dict[str, Histogram]":
        """Every registered histogram, for cumulative Prometheus export."""
        out = {
            "publish_to_deliver_us": self.publish_to_deliver_us,
            "repl_ack_us": self.repl_ack_us,
            "wal_commit_us": self.wal_commit_us,
            "router_batch_size": self.router_batch_size,
        }
        out.update(self.trace_stage_us)
        return out

    def snapshot(self) -> dict:
        elapsed = time.time() - self.started_at
        h = self.publish_to_deliver_us
        out = {
            "uptime_s": round(elapsed, 3),
            "published_msgs": self.published_msgs,
            "published_bytes": self.published_bytes,
            "delivered_msgs": self.delivered_msgs,
            "delivered_bytes": self.delivered_bytes,
            "returned_msgs": self.returned_msgs,
            "confirmed_msgs": self.confirmed_msgs,
            "expired_msgs": self.expired_msgs,
            "dead_lettered_msgs": self.dead_lettered_msgs,
            "connections_opened": self.connections_opened,
            "connections_closed": self.connections_closed,
            "connections_refused": self.connections_refused,
            "connections_open": (
                self.connections_opened - self.connections_closed),
            "publish_to_deliver_p50_us": h.percentile_us(0.50),
            "publish_to_deliver_p99_us": h.percentile_us(0.99),
            "publish_to_deliver_mean_us": h.mean_us,
            "repl_events_shipped": self.repl_events_shipped,
            "repl_batches_shipped": self.repl_batches_shipped,
            "repl_events_applied": self.repl_events_applied,
            "repl_resyncs": self.repl_resyncs,
            "repl_promotions": self.repl_promotions,
            "repl_ack_timeouts": self.repl_ack_timeouts,
            "repl_ack_p50_us": self.repl_ack_us.percentile_us(0.50),
            "repl_ack_p99_us": self.repl_ack_us.percentile_us(0.99),
            "repl_ack_mean_us": self.repl_ack_us.mean_us,
            "stream_appends": self.stream_appends,
            "stream_append_bytes": self.stream_append_bytes,
            "stream_segments_sealed": self.stream_segments_sealed,
            "stream_segments_truncated": self.stream_segments_truncated,
            "stream_records_delivered": self.stream_records_delivered,
            "stream_cursor_commits": self.stream_cursor_commits,
            "stream_groups_created": self.stream_groups_created,
            "stream_group_deliveries": self.stream_group_deliveries,
            "rpc_data_bytes_sent": self.rpc_data_bytes_sent,
            "rpc_data_bytes_recv": self.rpc_data_bytes_recv,
            "rpc_push_records": self.rpc_push_records,
            "rpc_push_batches": self.rpc_push_batches,
            "rpc_settle_records": self.rpc_settle_records,
            "rpc_settle_batches": self.rpc_settle_batches,
            "rpc_deliver_records": self.rpc_deliver_records,
            "rpc_deliver_batches": self.rpc_deliver_batches,
            "rpc_flush_window": self.rpc_flush_window,
            "rpc_flush_bytes": self.rpc_flush_bytes,
            "rpc_flush_count": self.rpc_flush_count,
            "rpc_flush_demand": self.rpc_flush_demand,
            "chaos_fires": self.chaos_fires,
            "chaos_latency": self.chaos_latency,
            "chaos_errors": self.chaos_errors,
            "chaos_drops": self.chaos_drops,
            "chaos_disconnects": self.chaos_disconnects,
            "chaos_corrupt_frames": self.chaos_corrupt_frames,
            "chaos_crashes": self.chaos_crashes,
            "chaos_partition_drops": self.chaos_partition_drops,
            "trace_sampled": self.trace_sampled,
            "trace_completed": self.trace_completed,
            "trace_slow": self.trace_slow,
            "trace_chaos_tagged": self.trace_chaos_tagged,
            "trace_ctx_sent": self.trace_ctx_sent,
            "trace_ctx_recv": self.trace_ctx_recv,
            "trace_evicted": self.trace_evicted,
            "otel_forced_samples": self.otel_forced_samples,
            "otel_spans_exported": self.otel_spans_exported,
            "otel_batches_sent": self.otel_batches_sent,
            "otel_export_errors": self.otel_export_errors,
            "otel_spans_shed": self.otel_spans_shed,
            "otel_pull_served": self.otel_pull_served,
            "telemetry_ticks": self.telemetry_ticks,
            "telemetry_saturated_ticks": self.telemetry_saturated_ticks,
            "telemetry_evicted_entities": self.telemetry_evicted_entities,
            "telemetry_dropped_entities": self.telemetry_dropped_entities,
            "shard_cross_pushes": self.shard_cross_pushes,
            "shard_handoffs": self.shard_handoffs,
            "shard_restarts": self.shard_restarts,
            "flow_escalations": self.flow_escalations,
            "flow_deescalations": self.flow_deescalations,
            "flow_paged_bodies": self.flow_paged_bodies,
            "flow_paged_bytes": self.flow_paged_bytes,
            "flow_throttles": self.flow_throttles,
            "flow_resumes": self.flow_resumes,
            "flow_hold_releases": self.flow_hold_releases,
            "flow_hold_wait_ns": self.flow_hold_wait_ns,
            "flow_cluster_stalls": self.flow_cluster_stalls,
            "flow_publishes_refused": self.flow_publishes_refused,
            "flow_slow_consumers": self.flow_slow_consumers,
            "control_ticks": self.control_ticks,
            "control_decisions": self.control_decisions,
            "control_applied": self.control_applied,
            "control_suppressed": self.control_suppressed,
            "control_dry_run": self.control_dry_run,
            "control_errors": self.control_errors,
            "chaos_pressure": self.chaos_pressure,
            "wal_appends": self.wal_appends,
            "wal_append_bytes": self.wal_append_bytes,
            "wal_commits": self.wal_commits,
            "wal_fsyncs": self.wal_fsyncs,
            "wal_commit_errors": self.wal_commit_errors,
            "wal_segments_sealed": self.wal_segments_sealed,
            "wal_segments_truncated": self.wal_segments_truncated,
            "wal_checkpoints": self.wal_checkpoints,
            "wal_checkpoint_errors": self.wal_checkpoint_errors,
            "wal_recovered_records": self.wal_recovered_records,
            "wal_recover_torn": self.wal_recover_torn,
            "wal_recover_corrupt": self.wal_recover_corrupt,
            "wal_tier_offloads": self.wal_tier_offloads,
            "wal_tier_rehydrations": self.wal_tier_rehydrations,
            "wal_compactions": self.wal_compactions,
            "wal_compacted_records": self.wal_compacted_records,
            "wal_memtable_drains": self.wal_memtable_drains,
            "wal_memtable_elided": self.wal_memtable_elided,
            "wal_memtable_hits": self.wal_memtable_hits,
            "wal_tx_batches": self.wal_tx_batches,
            "wal_tx_batch_ops": self.wal_tx_batch_ops,
            "wal_commit_p50_us": self.wal_commit_us.percentile_us(0.50),
            "wal_commit_p99_us": self.wal_commit_us.percentile_us(0.99),
            "wal_commit_mean_us": self.wal_commit_us.mean_us,
            "alerts_fired": self.alerts_fired,
            "alerts_resolved": self.alerts_resolved,
            "lifecycle_drains_started": self.lifecycle_drains_started,
            "lifecycle_queues_evacuated": self.lifecycle_queues_evacuated,
            "lifecycle_evacuation_retries": self.lifecycle_evacuation_retries,
            "lifecycle_rollbacks": self.lifecycle_rollbacks,
            "lifecycle_stale_epoch_refused": self.lifecycle_stale_epoch_refused,
            "lifecycle_join_rebalances": self.lifecycle_join_rebalances,
            "lifecycle_stale_holders_cleared":
                self.lifecycle_stale_holders_cleared,
            "router_batches": self.router_batches,
            "router_batch_msgs": self.router_batch_msgs,
            "router_compiles": self.router_compiles,
            "router_generation": self.router_generation,
            "router_fallback_msgs": self.router_fallback_msgs,
            "router_parity_mismatches": self.router_parity_mismatches,
            "router_batch_size_p50": self.router_batch_size.percentile_us(0.50),
            "router_batch_size_p99": self.router_batch_size.percentile_us(0.99),
            "router_batch_size_mean": self.router_batch_size.mean_us,
            "native_egress_batches": self.native_egress_batches,
            "native_egress_msgs": self.native_egress_msgs,
            "native_egress_bytes": self.native_egress_bytes,
            "native_egress_fallbacks": self.native_egress_fallbacks,
            "native_pool_exhausted": self.native_pool_exhausted,
            "profile_samples_total": self.profile_samples_total,
            "profile_slow_callbacks_total": self.profile_slow_callbacks_total,
            "profile_gc_pauses_total": self.profile_gc_pauses_total,
            "profile_gc_pause_ns_total": self.profile_gc_pause_ns_total,
            "events_published_total": self.events_published_total,
            "events_dropped_total": self.events_dropped_total,
            "firehose_published_total": self.firehose_published_total,
            "firehose_dropped_total": self.firehose_dropped_total,
            "slo_violations_total": self.slo_violations_total,
            "tenancy_throttles_total": self.tenancy_throttles_total,
            "tenancy_resumes_total": self.tenancy_resumes_total,
            "tenancy_quota_refusals_total": self.tenancy_quota_refusals_total,
            "tenancy_acl_denials_total": self.tenancy_acl_denials_total,
            "semantics_tx_commits": self.semantics_tx_commits,
            "semantics_tx_rollbacks": self.semantics_tx_rollbacks,
            "semantics_delayed_msgs": self.semantics_delayed_msgs,
            "semantics_delay_fired": self.semantics_delay_fired,
            "semantics_priority_msgs": self.semantics_priority_msgs,
            "dlx_published": self.dlx_published,
            "dlx_cycle_drops": self.dlx_cycle_drops,
            "dlx_expired": self.dlx_expired,
            "dlx_rejected": self.dlx_rejected,
            "dlx_maxlen": self.dlx_maxlen,
            "federation_segments_shipped": self.federation_segments_shipped,
            "federation_segment_bytes": self.federation_segment_bytes,
            "federation_segments_applied": self.federation_segments_applied,
            "federation_duplicate_segments":
                self.federation_duplicate_segments,
            "federation_crc_failures": self.federation_crc_failures,
            "federation_ship_errors": self.federation_ship_errors,
            "federation_resyncs": self.federation_resyncs,
            "federation_resumes": self.federation_resumes,
            "federation_link_failures": self.federation_link_failures,
            "federation_cursors_shipped": self.federation_cursors_shipped,
            "federation_cursors_mirrored": self.federation_cursors_mirrored,
            "federation_dlx_forwarded": self.federation_dlx_forwarded,
            "federation_tx_batches": self.federation_tx_batches,
            "federation_tx_publishes": self.federation_tx_publishes,
            "federation_tx_applied": self.federation_tx_applied,
            "federation_outbox_dropped": self.federation_outbox_dropped,
            "federation_outbox_dropped_publish":
                self.federation_outbox_dropped_publish,
            "federation_outbox_dropped_tx":
                self.federation_outbox_dropped_tx,
            "federation_duplicate_forwards":
                self.federation_duplicate_forwards,
            "federation_invalid_segments":
                self.federation_invalid_segments,
            "federation_auth_failures": self.federation_auth_failures,
            "lifecycle_left_peer_skipped": self.lifecycle_left_peer_skipped,
        }
        for key, hist in self.trace_stage_us.items():
            base = key[:-3] if key.endswith("_us") else key
            out[f"{base}_p50_us"] = hist.percentile_us(0.50)
            out[f"{base}_p99_us"] = hist.percentile_us(0.99)
            out[f"{base}_mean_us"] = hist.mean_us
        return out
