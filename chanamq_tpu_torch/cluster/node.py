"""Cluster node: location-transparent broker entities over the host mesh.

The rebuild of the reference's Akka-cluster distribution (SURVEY.md §5
"distributed communication backend", §3.6 failover):

- **Exchanges, bindings, vhosts are replicated** to every node (broadcast on
  mutation + snapshot pull on join), so publish routing is always local —
  where the reference paid a cluster `ask` per publish to a sharded
  ExchangeEntity (ExchangeEntity.scala:287-331), here only the per-queue
  pushes leave the node.
- **Queues are sharded** by consistent hash over alive members (the analogue
  of shard-id % 100 placement, QueueEntity.scala:43-51). Queue ops arriving
  on a non-owner node are proxied over RPC. Exclusive queues stay pinned to
  the connection's node and are never clustered.
- **Remote consumers** stream deliveries owner -> origin with a credit
  window (the QoS budget the reference computed per Pull,
  FrameStage.scala:387-392, becomes an explicit credit grant on ack).
- **Failover** (reference §3.6): node dies -> membership marks DOWN -> ring
  excludes it -> next op (or consumer re-registration) activates the queue
  on its new owner, which reloads durable state from the shared store.
  Transient queue contents die with their node, matching the reference's HA
  contract (README.md:47-49).
- **Cluster-wide worker ids** for snowflake message ids are leased from the
  current leader (lowest alive member - the reference's GlobalNodeIdService
  singleton, GlobalNodeIdService.scala:15-72).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import TYPE_CHECKING, Any, Optional

from .. import trace
from ..amqp.properties import BasicProperties
from ..flow import STAGE_CLUSTER
from ..replicate import ReplicationManager
from . import dataplane as dp
from .dataplane import PeerDataPlane
from .hashring import HashRing
from .membership import Member, Membership
from .rpc import RpcError, RpcServer, UdsTransport

if TYPE_CHECKING:  # pragma: no cover
    from ..broker.broker import Broker
    from ..broker.channel import ServerChannel
    from ..broker.entities import Delivery, Queue, QueuedMessage

log = logging.getLogger("chanamq.cluster")

DEFAULT_CREDIT = 200
# remote-consume prefetch window (chana.mq.cluster.consume-credit): sized so
# deliveries stream ahead of the settle round trip instead of stalling on it
DEFAULT_CONSUME_CREDIT = 1024

# decoded-properties memo for the binary push handler: publishers stream
# identical header payloads, so the owner decodes each distinct one once
# (same idea as the origin connection's _HEADER_CACHE)
_PROPS_MEMO: dict[bytes, BasicProperties] = {}
_PROPS_MEMO_MAX = 1024


def _props_memo(props_raw) -> BasicProperties:
    key = bytes(props_raw)
    props = _PROPS_MEMO.get(key)
    if props is None:
        _, _, props = BasicProperties.decode_header(key)
        if len(_PROPS_MEMO) >= _PROPS_MEMO_MAX:
            _PROPS_MEMO.clear()
        _PROPS_MEMO[key] = props
    return props


class ClusterNode:
    """Cluster extension attached to a Broker."""

    def __init__(
        self,
        broker: "Broker",
        host: str = "127.0.0.1",
        port: int = 0,
        seeds: Optional[list[str]] = None,
        *,
        virtual_nodes: int = 64,
        heartbeat_interval_s: float = 1.0,
        failure_timeout_s: float = 5.0,
        replicate_factor: int = 1,
        replicate_sync: bool = False,
        replicate_batch_max: int = 256,
        replicate_ack_timeout_ms: int = 1000,
        streams: int = 2,
        stream_inflight: int = 32,
        flush_window_us: int = 200,
        flush_max_bytes: int = 1 << 20,
        flush_max_count: int = 512,
        consume_credit: int = DEFAULT_CONSUME_CREDIT,
        call_timeout_s: float = 10.0,
        uds_path: Optional[str] = None,
        uds_map: Optional[dict[str, str]] = None,
        drain_retry_limit: int = 5,
        drain_backoff_ms: int = 100,
        drain_backoff_cap_ms: int = 2000,
        drain_budget_s: float = 30.0,
    ) -> None:
        self.broker = broker
        self.rpc = RpcServer(host, port, uds_path=uds_path)
        self._host = host
        self._seeds = seeds or []
        # sibling shards on this machine (member name -> Unix-socket
        # path): control and data planes toward them dial UDS, not TCP
        self.uds_map = dict(uds_map or {})
        self._hb = heartbeat_interval_s
        self._ft = failure_timeout_s
        self.membership: Optional[Membership] = None
        self.ring = HashRing([], virtual_nodes)
        # replicated queue-meta registry: (vhost, name) -> meta dict
        self.queue_metas: dict[tuple[str, str], dict] = {}
        # owner-side (vhost, name) -> activated local Queue, for the binary
        # push handler's per-record resolution. Cleared alongside the
        # broker's route caches (broker.invalidate_routes) on any queue /
        # holder / membership mutation.
        self.resolve_cache: dict[tuple[str, str], Any] = {}
        # origin-side registry of remote consumers for failover re-register:
        # (vhost, queue, tag) -> info
        self._remote_consumers: dict[tuple[str, str, str], dict] = {}
        # data-plane fast path (chana.mq.cluster.streams / flush-window-us /
        # flush-max-*): binary batched pushes, settles, and deliveries.
        # Keyed (peer name, transport kind) so a UDS sibling never shares
        # striping/backoff state with a same-named TCP peer.
        self._dataplanes: dict[tuple[str, str], PeerDataPlane] = {}
        self._dp_streams = max(1, streams)
        self._dp_inflight = max(1, stream_inflight)
        self._dp_flush_window_us = flush_window_us
        self._dp_flush_max_bytes = flush_max_bytes
        self._dp_flush_max_count = flush_max_count
        self.consume_credit = max(1, consume_credit)
        # default per-call ask window for control RPCs (individual calls
        # may still override — e.g. the 5 s snapshot pull at boot)
        self.call_timeout_s = call_timeout_s
        # metadata anti-entropy: broadcasts are fire-and-forget, so a peer
        # briefly unreachable (reconnect backoff during a sharded node's
        # boot, a blip mid-partition) can miss a queue.declared for good.
        # A periodic add-only snapshot merge from one rotating peer heals
        # those gaps without ever overwriting newer local state.
        self._anti_entropy_s = max(1.0, failure_timeout_s)
        self._anti_entropy_task: Optional[asyncio.Task] = None
        self.name: str = ""
        broker.cluster = self
        # flow-ladder stage 3 (cluster): shrink peer flush windows so
        # pushback propagates across shard/cluster hops (see dataplane())
        broker.flow_stage_listeners.add(self._on_flow_stage)
        self._register_handlers()
        # queue replication (chana.mq.replicate.*): factor 1 = off; the
        # manager registers its own repl.* RPC handlers
        self.replication: Optional[ReplicationManager] = (
            ReplicationManager(
                self, factor=replicate_factor, sync=replicate_sync,
                batch_max=replicate_batch_max,
                ack_timeout_ms=replicate_ack_timeout_ms)
            if replicate_factor > 1 else None)
        # graceful drain / decommission (chana.mq.lifecycle.*)
        from .lifecycle import LifecycleCoordinator

        self.lifecycle = LifecycleCoordinator(
            self, retry_limit=drain_retry_limit,
            backoff_ms=drain_backoff_ms,
            backoff_cap_ms=drain_backoff_cap_ms,
            budget_s=drain_budget_s)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def start(self) -> None:
        await self.rpc.start()
        self.name = f"{self._host}:{self.rpc.bound_port}"
        # span attribution for message traces: this broker's spans carry
        # the cluster name instead of the single-node "local"
        self.broker.trace_node = self.name
        if trace.ACTIVE is not None and trace.ACTIVE.node == "local":
            trace.ACTIVE.node = self.name
        self.membership = Membership(
            self.name, self._seeds, self.rpc,
            heartbeat_interval_s=self._hb, failure_timeout_s=self._ft,
            uds_map=self.uds_map)
        self.membership.listeners.append(self._on_membership_event)
        await self.membership.start()
        self.ring.set_nodes(self._ring_members())
        # pull metadata snapshot from the first reachable seed
        for seed in self._seeds:
            try:
                snapshot = await self.membership.client(seed).call(
                    "cluster.snapshot", {}, timeout_s=5)
                await self._apply_snapshot(snapshot)
                break
            except (RpcError, OSError):
                continue
        # deactivate local queues this node does not own (boot recovery
        # loaded everything; sharded ownership says otherwise)
        self._deactivate_unowned(boot=True)
        # lease a snowflake worker id from the leader (reference:
        # ServiceBoard blocking on AskNodeId, ServiceBoard.scala:40-48 —
        # but bounded and non-blocking here)
        import uuid as uuid_module

        from .idgen import IdGenerator, MAX_WORKER_ID

        try:
            worker_id = await asyncio.wait_for(
                self.acquire_worker_id(str(uuid_module.uuid4())), timeout=10)
            self.broker.idgen = IdGenerator(worker_id & MAX_WORKER_ID)
        except (asyncio.TimeoutError, RpcError, OSError):
            log.warning("%s: worker-id lease failed; keeping local id", self.name)
        # the lease counts in the leader's store: with private stores two
        # leaders (or one alone before it joined) can hand out one id, and
        # a follower keeps every owner's replicas in one store keyed by
        # message id. The id is gossiped; a clash moves this node off it.
        self.membership.worker_id = self.broker.idgen.worker_id
        self.membership.on_worker_id_clash = self._repick_worker_id
        self._anti_entropy_task = asyncio.get_event_loop().create_task(
            self._anti_entropy_loop())

    async def stop(self) -> None:
        if self.lifecycle._task is not None and \
                not self.lifecycle._task.done():
            self.lifecycle._task.cancel()
            try:
                await self.lifecycle._task
            except (asyncio.CancelledError, Exception):
                pass
        if self._anti_entropy_task is not None:
            self._anti_entropy_task.cancel()
            try:
                await self._anti_entropy_task
            except (asyncio.CancelledError, Exception):
                pass
            self._anti_entropy_task = None
        self.broker.flow_stage_listeners.discard(self._on_flow_stage)
        dataplanes, self._dataplanes = self._dataplanes, {}
        for plane in dataplanes.values():
            await plane.close()
        if self.membership is not None:
            await self.membership.stop()
        await self.rpc.stop()

    # ------------------------------------------------------------------
    # ownership
    # ------------------------------------------------------------------

    def queue_owner(self, vhost: str, name: str) -> str:
        """Where ops on this queue must go. A live HOLDER (the node actually
        serving the queue, replicated through queue metas) wins over the
        hash ring: on a ring reshuffle (node join) the old owner keeps
        serving a queue with live consumers/messages — routing to the new
        ring owner would activate a second copy from the shared store and
        deliver duplicates. The ring decides only when no live holder
        exists (fresh queue, holder died, or holder released when idle)."""
        meta = self.queue_metas.get((vhost, name))
        if meta is not None:
            holder = meta.get("holder")
            if holder and (holder == self.name
                           or self.membership.is_alive(holder)):
                return holder
        owner = self.ring.owner_entity("q", vhost, name)
        return owner or self.name

    def owns_queue(self, vhost: str, name: str) -> bool:
        return self.queue_owner(vhost, name) == self.name

    def is_remote_queue(self, vhost: str, name: str) -> bool:
        """True when ops on this queue must be proxied: it is a known
        clustered (non-exclusive) queue owned elsewhere."""
        vh = self.broker.vhosts.get(vhost)
        if vh is not None:
            queue = vh.queues.get(name)
            if queue is not None:
                # local exclusive queues are always local
                return False
        meta = self.queue_metas.get((vhost, name))
        if meta is None:
            return False
        return not self.owns_queue(vhost, name)

    def _deactivate_unowned(self, boot: bool = False) -> None:
        self.broker.invalidate_routes()
        for vhost in self.broker.vhosts.values():
            for name in list(vhost.queues):
                queue = vhost.queues[name]
                if queue.exclusive_owner is not None:
                    continue
                meta = self.queue_metas.get((vhost.name, name))
                other = meta.get("holder") if meta else None
                # at boot, membership is still converging: a named foreign
                # holder must be deferred to even before it gossips alive,
                # or a joiner that pre-recovered the shared store claims a
                # queue another node is actively serving
                foreign = bool(other and other != self.name
                               and (boot or self.membership.is_alive(other)))
                if foreign:
                    if boot and not queue.consumers and not queue.outstanding:
                        # we just booted and loaded this queue from the
                        # shared store while another node is (per the
                        # snapshot) actively serving it: our copy only
                        # duplicates its durable contents (transients never
                        # recover), so drop it — a second copy would
                        # deliver duplicates. If that holder is in fact
                        # dead, its down event clears the holdership and
                        # the ring owner reactivates from the store.
                        # Release the RAM gauge but do NOT unrefer: the
                        # store rows belong to the holder.
                        for qm in queue.messages:
                            msg = qm.message
                            if msg.accounted:
                                self.broker.account_memory(
                                    -len(msg.body or b""))
                                msg.accounted = False
                        queue.deleted = True
                        queue.gauges_detach()
                        del vhost.queues[name]
                        continue
                    if queue.consumers or queue.messages or queue.outstanding:
                        # dual-holder conflict at steady state (a claim
                        # race): resolve DETERMINISTICALLY — the
                        # lexicographically smaller name wins — so the two
                        # sides can't flip holdership back and forth with
                        # racing broadcasts. The loser keeps draining its
                        # copy to its already-attached local consumers but
                        # stops being a routing target for new ops.
                        if self.name < other:
                            log.warning(
                                "%s: reclaiming %s/%s from dual holder %s",
                                self.name, vhost.name, name, other)
                            self._register_meta(queue)
                            self._set_holder(vhost.name, name, self.name)
                        else:
                            log.warning(
                                "%s: deferring %s/%s to dual holder %s",
                                self.name, vhost.name, name, other)
                        continue
                    # idle local shell under a live foreign holder
                    queue.deleted = True
                    queue.gauges_detach()
                    del vhost.queues[name]
                    continue
                # no live foreign holder. Evaluate placement BEFORE any
                # claim so an idle shell hands off with at most one
                # broadcast instead of a claim-then-release pair.
                live = bool(queue.consumers or queue.messages
                            or queue.outstanding)
                ring_owned = (
                    self.ring.owner_entity("q", vhost.name, name) == self.name)
                if not ring_owned and not live:
                    # idle shell owned elsewhere by the ring: hand off
                    queue.deleted = True
                    queue.gauges_detach()
                    del vhost.queues[name]
                    if self.replication is not None:
                        # close (not delete) the outgoing log: the next
                        # owner opens its own from seq 0 and followers
                        # resync against it on the owner-change
                        self.replication.detach(vhost.name, name)
                    if other is not None:
                        self._set_holder(vhost.name, name, None)
                    continue
                # we keep serving (ring owner, or sticky live copy — a ring
                # reshuffle on join moves nothing mid-flight); broadcast the
                # claim only when the replicated view doesn't already say so
                self._register_meta(queue)
                if other != self.name:
                    self._set_holder(vhost.name, name, self.name)

    def _register_meta(self, queue: "Queue") -> None:
        # registering a live local queue claims holdership: ops for it must
        # come to this node while it serves consumers/messages
        self.broker.invalidate_routes()
        prev = self.queue_metas.get((queue.vhost, queue.name))
        self.queue_metas[(queue.vhost, queue.name)] = {
            "durable": queue.durable,
            "auto_delete": queue.auto_delete,
            "ttl_ms": queue.ttl_ms,
            "arguments": dict(queue.arguments or {}),
            "holder": self.name,
            # the fencing epoch survives re-registration: it only moves
            # forward, through _set_holder
            "epoch": int(prev.get("epoch") or 0) if prev is not None else 0,
        }

    def queue_epoch(self, vhost: str, name: str) -> int:
        meta = self.queue_metas.get((vhost, name))
        return int(meta.get("epoch") or 0) if meta is not None else 0

    def seat_epoch(self, vhost: str, name: str) -> int:
        """Seat a freshly declared queue at fencing epoch 1. Epoch 0 marks
        pre-fencing legacy traffic that the refusal checks deliberately
        wave through, so a declared queue must start above it for its very
        first ships to be fenceable. Re-declares keep the current epoch."""
        meta = self.queue_metas.get((vhost, name))
        if meta is None:
            return 0
        if not int(meta.get("epoch") or 0):
            meta["epoch"] = 1
        return int(meta["epoch"])

    def _set_holder(self, vhost: str, name: str, holder: Optional[str],
                    decision: Optional[str] = None) -> int:
        """Record + replicate who serves a queue (None = released: the
        hash ring decides again). Every holder change bumps the queue's
        monotonic FENCING EPOCH and stamps it on the broadcast: receivers
        (and replication ships) refuse anything carrying a lower epoch, so
        a partitioned ex-holder cannot reassert a queue that moved on
        without it. A control-plane rebalance stamps its decision id on
        the broadcast so every node's log links the move back to the
        decision (and its recorded inputs)."""
        self.broker.invalidate_routes()
        meta = self.queue_metas.get((vhost, name))
        epoch = (int(meta.get("epoch") or 0) if meta is not None else 0) + 1
        if meta is not None:
            meta["holder"] = holder
            meta["epoch"] = epoch
        payload = {
            "kind": "queue.holder", "vhost": vhost, "name": name,
            "holder": holder, "epoch": epoch,
        }
        if decision is not None:
            payload["decision"] = decision
        self.broadcast_bg("meta.apply", payload)
        return epoch

    def claim_queue(self, queue: "Queue") -> None:
        """Called by the broker when a queue materializes locally
        (declare/activate): this node becomes the holder cluster-wide."""
        if queue.exclusive_owner is not None:
            return
        self._register_meta(queue)
        self._set_holder(queue.vhost, queue.name, self.name)
        if self.replication is not None:
            self.replication.attach(queue)

    async def handoff_queue(self, vhost_name: str, name: str, target: str,
                            *, decision: Optional[str] = None) -> bool:
        """Proactively move holdership of a local queue to ``target`` (a
        control-plane rebalance decision). Reuses the exact machinery of
        the boot-time dual-copy drop (_deactivate_unowned): release the
        local copy's RAM accounting WITHOUT unreferring (the store rows
        now belong to the new holder), replicate the holder change, then
        activate on the target so it rematerializes durable content from
        the shared store. Callers must pre-check movability (no local
        consumers, no outstanding, durable-persisted content only) — this
        re-verifies and refuses rather than losing data."""
        broker = self.broker
        vhost = broker.vhosts.get(vhost_name)
        queue = vhost.queues.get(name) if vhost is not None else None
        if queue is None or queue.deleted or queue.is_stream:
            return False
        if queue.exclusive_owner is not None or queue.outstanding:
            return False
        if (vhost_name, name) not in self.queue_metas:
            return False
        if target == self.name or self.membership is None \
                or not self.membership.is_alive(target):
            return False
        if any(not isinstance(c, RemoteConsumer) for c in queue.consumers):
            return False  # local AMQP consumers cannot follow the queue
        if queue.messages and (
                not queue.durable
                or any(not qm.message.persisted for qm in queue.messages)):
            return False  # transient content would not survive the move
        if self.replication is not None and queue.durable \
                and not queue.is_stream:
            # private-store deployments: the target must hold a complete,
            # head-synced replica copy BEFORE holdership moves — it
            # materializes that copy when it activates. (Shared-store
            # deployments pass through here too; the copy just duplicates
            # rows the target could already see.)
            if not await self.replication.prepare_handoff(
                    vhost_name, name, target):
                return False
        # detach remote-consumer stubs; their origins re-register on the
        # new holder when the queue.holder broadcast lands
        for consumer in list(queue.consumers):
            queue.consumers.remove(consumer)
            if queue._counted:
                broker.queue_consumers -= 1
        for qm in queue.messages:
            msg = qm.message
            if msg.accounted:
                broker.account_memory(-len(msg.body or b""))
                msg.accounted = False
        queue.deleted = True
        queue.gauges_detach()
        del vhost.queues[name]
        if self.replication is not None:
            self.replication.detach(vhost_name, name)
        self._set_holder(vhost_name, name, target, decision=decision)
        # this node may itself consume from the moved queue
        if any(key[0] == vhost_name and key[1] == name
               for key in self._remote_consumers):
            asyncio.get_event_loop().create_task(self._reconcile_consumers())
        activated = False
        delay = 0.05
        for attempt in range(3):
            try:
                await self._call(target, "queue.activate",
                                 {"vhost": vhost_name, "name": name,
                                  "handoff": True})
                activated = True
                break
            except (RpcError, OSError) as exc:
                log.warning("%s: handoff activate of %s/%s on %s failed "
                            "(attempt %d: %s)", self.name, vhost_name, name,
                            target, attempt + 1, exc)
                self.broker.metrics.lifecycle_evacuation_retries += 1
                if self.membership is None \
                        or not self.membership.is_alive(target):
                    break  # target died: no point retrying it
                await asyncio.sleep(delay)
                delay *= 2
        if not activated:
            # roll holdership back: the store rows were never unreferred,
            # so re-activating locally rematerializes the full backlog and
            # re-claims with a FRESH epoch (so the aborted target claim
            # can't win a late race)
            self.broker.metrics.lifecycle_rollbacks += 1
            log.warning("%s: rolling %s/%s holdership back from %s",
                        self.name, vhost_name, name, target)
            await self.broker.activate_queue(vhost_name, name)
            return False
        log.info("%s: handed off %s/%s -> %s%s", self.name, vhost_name,
                 name, target,
                 f" (decision {decision})" if decision else "")
        return True

    # ------------------------------------------------------------------
    # membership reactions
    # ------------------------------------------------------------------

    @property
    def draining(self) -> bool:
        """True once this node entered DRAINING (or finished, LEFT): it
        keeps serving what it still holds but claims nothing new."""
        if self.membership is None:
            return False
        from .membership import DRAINING, LEFT

        me = self.membership.members.get(self.name)
        return me is not None and me.lifecycle in (DRAINING, LEFT)

    def _ring_members(self) -> list[str]:
        """Placement-eligible members for the ownership ring: draining and
        left nodes are excluded so no new holdership hashes onto them. If
        that empties the ring (every node draining), fall back to the full
        alive set — refusing all placement is worse than placing badly."""
        assert self.membership is not None
        placement = self.membership.placement_members()
        return placement or self.membership.alive_members()

    def _on_membership_event(self, event: str, member: Member) -> None:
        assert self.membership is not None
        self.broker.invalidate_routes()
        self.ring.set_nodes(self._ring_members())
        if event == "lifecycle":
            from .membership import LEFT

            if member.lifecycle == LEFT and member.name != self.name:
                # the member finished draining: any holdership still
                # pointing at it is a straggler the evacuation broadcasts
                # missed — clear it so the ring decides again
                for meta in self.queue_metas.values():
                    if meta.get("holder") == member.name:
                        meta["holder"] = None
                        self.broker.metrics.lifecycle_stale_holders_cleared \
                            += 1
            self._deactivate_unowned()
            asyncio.get_event_loop().create_task(self._reconcile_consumers())
            return
        if event == "down":
            # tear down the dead peer's data streams: buffered batches fail
            # fast instead of dialing a corpse until their timeouts
            for key in [k for k in self._dataplanes if k[0] == member.name]:
                plane = self._dataplanes.pop(key, None)
                if plane is not None:
                    asyncio.get_event_loop().create_task(plane.close())
            # one ownership re-hash per observed peer death — the soak's
            # "exactly-one re-hash" invariant counts these
            self.broker.metrics.shard_handoffs += 1
        if event == "down":
            # a dead node can't serve anything: clear its holderships so
            # queue_owner falls back to the ring (node names embed ephemeral
            # ports, so a stale holder entry would otherwise pin forever)
            for meta in self.queue_metas.values():
                if meta.get("holder") == member.name:
                    meta["holder"] = None
        if self.replication is not None:
            # BEFORE the reconcile task below is created: promotion intents
            # must be registered so activate_queue can await them instead of
            # cold-activating an empty shell over a warm replica
            if event == "down":
                self.replication.on_node_down(member.name)
            else:
                self.replication.on_membership()
        self._deactivate_unowned()
        # re-register remote consumers whose queues changed owner; also
        # requeue outstanding deliveries from consumers whose origin died
        if event == "down":
            self._drop_origin_consumers(member.name)
        asyncio.get_event_loop().create_task(self._reconcile_consumers())

    def _drop_origin_consumers(self, origin: str) -> None:
        for vhost in self.broker.vhosts.values():
            for queue in vhost.queues.values():
                for consumer in list(queue.consumers):
                    if isinstance(consumer, RemoteConsumer) and consumer.origin == origin:
                        consumer.requeue_outstanding()
                        queue.consumers.remove(consumer)
                        if queue._counted:
                            self.broker.queue_consumers -= 1

    _reconcile_retry_pending = False

    async def _reconcile_consumers(self) -> None:
        any_failed = False
        for (vhost, queue, tag), info in list(self._remote_consumers.items()):
            owner = self.queue_owner(vhost, queue)
            if owner == info.get("owner") and info.get("alive", True):
                continue
            try:
                if owner == self.name:
                    # queue came home: activate it locally; the origin-side
                    # stub keeps working because deliveries now come from
                    # the local dispatch through the same stub channel
                    local_queue = await self.broker.activate_queue(vhost, queue)
                    if local_queue is not None:
                        stub = info["stub"]
                        if stub not in local_queue.consumers:
                            local_queue.add_consumer(stub)
                    info["owner"] = owner
                    continue
                await self._call(owner, "queue.activate",
                                 {"vhost": vhost, "name": queue})
                await self._call(owner, "queue.consume", {
                    "vhost": vhost, "queue": queue, "tag": tag,
                    "no_ack": info["no_ack"], "origin": self.name,
                    "credit": info["credit"],
                    "priority": info.get("priority", 0),
                })
                info["owner"] = owner
                info["alive"] = True
                log.info("%s: re-registered consumer %s on %s", self.name, tag, owner)
            except (RpcError, OSError) as exc:
                log.warning("%s: consumer re-register failed (%s); retrying", self.name, exc)
                info["alive"] = False
                any_failed = True
        # exactly one pending retry regardless of how many consumers failed
        if any_failed and not self._reconcile_retry_pending:
            self._reconcile_retry_pending = True
            loop = asyncio.get_event_loop()

            def _retry() -> None:
                self._reconcile_retry_pending = False
                loop.create_task(self._reconcile_consumers())

            loop.call_later(1.0, _retry)

    # ------------------------------------------------------------------
    # RPC plumbing
    # ------------------------------------------------------------------

    async def _call(
        self, node: str, method: str, payload: dict,
        timeout_s: Optional[float] = None,
    ) -> dict:
        assert self.membership is not None
        # buffered/in-flight settles precede any control RPC: a cancel /
        # delete / purge issued after an ack in the same read batch must
        # find the ack applied on the owner (the data and control planes
        # are separate connections, so this fence is the only ordering)
        await self._drain_settles()
        return await self.membership.client(node).call(
            method, payload, timeout_s=timeout_s or self.call_timeout_s)

    def dataplane(self, node: str) -> PeerDataPlane:
        """The binary fast path toward a peer (lazily dialed, N streams).
        Sibling shards (uds_map) get a Unix-socket transport; remote nodes
        get TCP — the two never share a plane."""
        uds_path = self.uds_map.get(node)
        kind = "uds" if uds_path is not None else "tcp"
        plane = self._dataplanes.get((node, kind))
        if plane is None or plane.closed:
            if uds_path is not None:
                target: Any = UdsTransport(uds_path, peer=node)
                port = 0
            else:
                member = (self.membership.members.get(node)
                          if self.membership is not None else None)
                target, port = (member.host, member.port) \
                    if member is not None \
                    else (node.rsplit(":", 1)[0], int(node.rsplit(":", 1)[1]))
            plane = PeerDataPlane(
                target, port,
                streams=self._dp_streams,
                inflight_per_stream=self._dp_inflight,
                flush_window_us=self._dp_flush_window_us,
                flush_max_bytes=self._dp_flush_max_bytes,
                flush_max_count=self._dp_flush_max_count,
                metrics=self.broker.metrics,
                node_tag=self.name)
            flow = self.broker.flow
            plane.pressure = (flow is not None
                              and flow.stage >= STAGE_CLUSTER)
            self._dataplanes[(node, kind)] = plane
        return plane

    def _on_flow_stage(self, old: int, new: int) -> None:
        """Broker flow-ladder transition: at/above the cluster stage every
        peer data plane switches to pressure mode (flush caps shrink, so
        this node buffers less toward peers and the per-stream in-flight
        windows throttle the origin side sooner)."""
        pressured = new >= STAGE_CLUSTER
        for plane in self._dataplanes.values():
            plane.pressure = pressured

    def dataplane_buffered_bytes(self) -> int:
        """Bytes accumulated toward peers but not yet flushed — the flow
        accountant's ``cluster_inflight`` component, polled per sweep."""
        total = 0
        for plane in self._dataplanes.values():
            total += plane.buffered_bytes()
        return total

    async def _event(self, node: str, method: str, payload: dict) -> None:
        """Fire-and-forget event toward a peer. Loss is part of the design
        contract (deliveries: unacked copies requeue via failure detection;
        no_ack is at-most-once; credit: replenished on the next settle) —
        but log it for the operator chasing a partition."""
        assert self.membership is not None
        try:
            await self.membership.client(node).send_event(method, payload)
        except (RpcError, OSError) as exc:
            log.debug("event %s to %s dropped: %r", method, node, exc)

    async def broadcast(self, method: str, payload: dict) -> None:
        assert self.membership is not None
        for node in self.membership.alive_members():
            if node != self.name:
                await self._event(node, method, payload)

    def broadcast_bg(self, method: str, payload: dict) -> None:
        asyncio.get_event_loop().create_task(self.broadcast(method, payload))

    def _register_handlers(self) -> None:
        rpc = self.rpc
        rpc.register("cluster.snapshot", self._h_snapshot)
        rpc.register("cluster.node-id", self._h_node_id)
        rpc.register("meta.apply", self._h_meta_apply)
        rpc.register("queue.declare", self._h_queue_declare)
        rpc.register("queue.activate", self._h_queue_activate)
        rpc.register("queue.delete", self._h_queue_delete)
        rpc.register("queue.purge", self._h_queue_purge)
        rpc.register("queue.stats", self._h_queue_stats)
        rpc.register("queue.push", self._h_queue_push)
        rpc.register("queue.push_many", self._h_queue_push_many)
        rpc.register("queue.get", self._h_queue_get)
        rpc.register("queue.consume", self._h_queue_consume)
        rpc.register("queue.cancel", self._h_queue_cancel)
        rpc.register("queue.settle", self._h_queue_settle)
        rpc.register("consumer.deliver", self._h_consumer_deliver)
        rpc.register("consumer.deliver_many", self._h_consumer_deliver_many)
        rpc.register("consumer.credit", self._h_consumer_credit)
        rpc.register("consumer.cancelled", self._h_consumer_cancelled)
        rpc.register("telemetry.pull", self._h_telemetry_pull)
        rpc.register("slo.pull", self._h_slo_pull)
        rpc.register("control.load", self._h_control_load)
        # data plane: binary zero-copy bodies, no field-table codec
        rpc.register_binary(dp.METHOD_PUSH_MANY, self._hb_push_many)
        rpc.register_binary(dp.METHOD_SETTLE_MANY, self._hb_settle_many)
        rpc.register_binary(dp.METHOD_DELIVER_MANY, self._hb_deliver_many)

    # ------------------------------------------------------------------
    # metadata replication
    # ------------------------------------------------------------------

    def _snapshot(self) -> dict:
        exchanges = []
        for vhost in self.broker.vhosts.values():
            for exchange in vhost.exchanges.values():
                if not exchange.name and vhost.name:
                    continue
                exchanges.append({
                    "vhost": vhost.name, "name": exchange.name,
                    "type": exchange.type, "durable": exchange.durable,
                    "auto_delete": exchange.auto_delete,
                    "internal": exchange.internal,
                    "arguments": dict(exchange.arguments or {}),
                    "binds": [
                        {"key": key, "queue": queue, "args": args or {}}
                        for key, queue, args in exchange.matcher.bindings()
                    ],
                    "ex_binds": [
                        {"key": key, "destination": dest, "args": args or {}}
                        for key, dest, args in (
                            exchange.ex_matcher.bindings()
                            if exchange.ex_matcher is not None else [])
                    ],
                })
        return {
            "vhosts": {v.name: v.active for v in self.broker.vhosts.values()},
            "exchanges": exchanges,
            "queues": {
                f"{vh}\x00{name}": meta
                for (vh, name), meta in self.queue_metas.items()
            },
        }

    async def _h_snapshot(self, payload: dict) -> dict:
        return self._snapshot()

    async def _apply_snapshot(self, snapshot: dict) -> None:
        self.broker.invalidate_routes()
        for vhost_name, active in (snapshot.get("vhosts") or {}).items():
            if vhost_name not in self.broker.vhosts:
                await self.broker.create_vhost(vhost_name)
            self.broker.vhosts[vhost_name].active = bool(active)
        for ex in snapshot.get("exchanges") or []:
            await self._h_meta_apply({"kind": "exchange.declared", **ex})
        for key, meta in (snapshot.get("queues") or {}).items():
            vhost, _, name = key.partition("\x00")
            self.queue_metas[(vhost, name)] = dict(meta)

    async def _anti_entropy_loop(self) -> None:
        """Heal lost meta broadcasts: every failure-timeout, pull one
        rotating alive peer's snapshot and merge entries this node is
        missing. Steady state is a no-op (no route-cache invalidation)."""
        peer_idx = 0
        while True:
            await asyncio.sleep(self._anti_entropy_s)
            if self.membership is None:
                continue
            peers = self._anti_entropy_peers()
            if not peers:
                continue
            peer = peers[peer_idx % len(peers)]
            peer_idx += 1
            try:
                snapshot = await self.membership.client(peer).call(
                    "cluster.snapshot", {}, timeout_s=5)
                await self._merge_snapshot(snapshot, peer)
            except (RpcError, OSError) as exc:
                log.debug("anti-entropy pull from %s failed: %r", peer, exc)

    def _anti_entropy_peers(self) -> list[str]:
        """Alive peers worth pulling a snapshot from. Liveness and
        lifecycle converge independently, so a departed member can gossip
        as alive for a while after LEFT lands — pulling its snapshot
        would resurrect metas it is busy forgetting."""
        from .membership import LEFT

        peers = []
        for n in self.membership.alive_members():
            if n == self.name:
                continue
            if self.membership.lifecycle_of(n) == LEFT:
                self.broker.metrics.lifecycle_left_peer_skipped += 1
                continue
            peers.append(n)
        return peers

    async def _merge_snapshot(self, snapshot: dict, peer: str) -> None:
        """Add-only snapshot merge: fill in queue metas, exchanges and
        bindings this node has never heard of. Existing local entries are
        never overwritten — local state may be newer (fresher holders,
        post-promotion metas) than the peer's."""
        from .membership import DOWN, LEFT

        merged = 0
        for key, meta in (snapshot.get("queues") or {}).items():
            vhost, _, name = key.partition("\x00")
            local = self.queue_metas.get((vhost, name))
            if local is None:
                self.queue_metas[(vhost, name)] = dict(meta)
                merged += 1
                continue
            # holder reconciliation (NOT add-only): adopt the peer's
            # holdership when it carries a strictly newer fencing epoch —
            # a drain that completed while this node was partitioned left
            # it with a stale holder that plain gap-fill would resurrect
            incoming = int(meta.get("epoch") or 0)
            current = int(local.get("epoch") or 0)
            if incoming > current:
                local["epoch"] = incoming
                if local.get("holder") != meta.get("holder"):
                    local["holder"] = meta.get("holder")
                    merged += 1
        # clear holderships pointing at members this node knows are gone
        # (left the cluster, or dead): nobody can serve them, and keeping
        # them pins proxied ops onto a corpse until the next down event
        for (vhost, name), local in self.queue_metas.items():
            holder = local.get("holder")
            if not holder or holder == self.name or self.membership is None:
                continue
            member = self.membership.members.get(holder)
            if member is not None and (member.status == DOWN
                                       or member.lifecycle == LEFT):
                local["holder"] = None
                self.broker.metrics.lifecycle_stale_holders_cleared += 1
                merged += 1
        for ex in snapshot.get("exchanges") or []:
            vhost_name = str(ex.get("vhost", ""))
            vhost = self.broker.vhosts.get(vhost_name)
            exchange = (vhost.exchanges.get(str(ex.get("name")))
                        if vhost is not None else None)
            missing = exchange is None
            if not missing:
                have = {(k, q)
                        for k, q, _a in exchange.matcher.bindings()}
                missing = any(
                    (str(b["key"]), str(b["queue"])) not in have
                    for b in ex.get("binds") or [])
            if not missing and ex.get("ex_binds"):
                have_ex = {(k, d) for k, d, _a in (
                    exchange.ex_matcher.bindings()
                    if exchange.ex_matcher is not None else [])}
                missing = any(
                    (str(b["key"]), str(b["destination"])) not in have_ex
                    for b in ex["ex_binds"])
            if missing:
                await self._h_meta_apply({"kind": "exchange.declared", **ex})
                merged += 1
        if merged:
            self.broker.invalidate_routes()
            log.info("%s: anti-entropy merged %d missing meta entr%s "
                     "from %s", self.name, merged,
                     "y" if merged == 1 else "ies", peer)

    async def _h_meta_apply(self, payload: dict) -> dict:
        """Apply one replicated metadata mutation (broadcast receiver).
        Every kind mutates routing inputs (queue metas, holders, bindings,
        exchanges), so cached publish routes drop first."""
        self.broker.invalidate_routes()
        kind = str(payload.get("kind"))
        vhost_name = str(payload.get("vhost", ""))
        if kind == "vhost.created":
            if vhost_name not in self.broker.vhosts:
                from ..broker.entities import VHost

                self.broker.vhosts[vhost_name] = VHost(vhost_name)
            return {}
        if kind == "vhost.deleted":
            self.broker.vhosts.pop(vhost_name, None)
            return {}
        vhost = self.broker.vhosts.get(vhost_name)
        if vhost is None:
            from ..broker.entities import VHost

            vhost = VHost(vhost_name)
            self.broker.vhosts[vhost_name] = vhost
        if kind == "exchange.declared":
            from ..broker.entities import Exchange

            name = str(payload["name"])
            if name not in vhost.exchanges:
                vhost.exchanges[name] = Exchange(
                    vhost_name, name, str(payload["type"]),
                    durable=bool(payload.get("durable")),
                    auto_delete=bool(payload.get("auto_delete")),
                    internal=bool(payload.get("internal")),
                    arguments=dict(payload.get("arguments") or {}),
                )
            exchange = vhost.exchanges[name]
            for bind in payload.get("binds") or []:
                exchange.matcher.bind(
                    str(bind["key"]), str(bind["queue"]), bind.get("args"))
            for bind in payload.get("ex_binds") or []:
                exchange.ensure_ex_matcher().bind(
                    str(bind["key"]), str(bind["destination"]), bind.get("args"))
            return {}
        if kind == "exchange.deleted":
            vhost.exchanges.pop(str(payload["name"]), None)
            vhost.drop_exchange_refs(str(payload["name"]))
            return {}
        if kind == "exbind.added":
            exchange = vhost.exchanges.get(str(payload["source"]))
            if exchange is not None:
                exchange.ensure_ex_matcher().bind(
                    str(payload["key"]), str(payload["destination"]),
                    payload.get("args") or None)
            return {}
        if kind == "exbind.removed":
            exchange = vhost.exchanges.get(str(payload["source"]))
            if exchange is not None and exchange.ex_matcher is not None:
                exchange.ex_matcher.unbind(
                    str(payload["key"]), str(payload["destination"]),
                    payload.get("args") or None)
            return {}
        if kind == "bind.added":
            exchange = vhost.exchanges.get(str(payload["exchange"]))
            if exchange is not None:
                exchange.matcher.bind(
                    str(payload["key"]), str(payload["queue"]),
                    payload.get("args") or None)
            return {}
        if kind == "bind.removed":
            exchange = vhost.exchanges.get(str(payload["exchange"]))
            if exchange is not None:
                exchange.matcher.unbind(
                    str(payload["key"]), str(payload["queue"]),
                    payload.get("args") or None)
            return {}
        if kind == "queue.declared":
            name = str(payload["name"])
            prev = self.queue_metas.get((vhost_name, name))
            # re-declares must not rewind the fencing epoch
            epoch = max(int(payload.get("epoch") or 0),
                        int(prev.get("epoch") or 0) if prev is not None else 0)
            self.queue_metas[(vhost_name, name)] = {
                "durable": bool(payload.get("durable")),
                "auto_delete": bool(payload.get("auto_delete")),
                "ttl_ms": payload.get("ttl_ms"),
                "arguments": payload.get("arguments") or {},
                "holder": payload.get("holder"),
                "epoch": epoch,
            }
            return {}
        if kind == "queue.holder":
            name = str(payload["name"])
            meta = self.queue_metas.get((vhost_name, name))
            if meta is not None:
                incoming = int(payload.get("epoch") or 0)
                current = int(meta.get("epoch") or 0)
                if incoming and incoming < current:
                    # fenced: a stale (pre-move) holder broadcast arriving
                    # late — e.g. from a partitioned ex-owner healing —
                    # must not overwrite the newer holdership
                    self.broker.metrics.lifecycle_stale_epoch_refused += 1
                    log.warning(
                        "%s: refused stale holder broadcast for %s/%s "
                        "(epoch %d < %d)", self.name, vhost_name, name,
                        incoming, current)
                    return {"refused": True}
                meta["holder"] = payload.get("holder")
                if incoming:
                    meta["epoch"] = incoming
            decision = payload.get("decision")
            if decision:
                # a proactive control-plane move, not a failure/ring event
                log.info("%s: holder of %s/%s -> %s (control decision %s)",
                         self.name, vhost_name, name,
                         payload.get("holder"), decision)
            if any(key[0] == vhost_name and key[1] == name
                   for key in self._remote_consumers):
                # a queue this node consumes from moved: re-register the
                # consumer on the new holder without waiting for the next
                # membership event
                asyncio.get_event_loop().create_task(
                    self._reconcile_consumers())
            return {}
        if kind == "queue.deleted":
            name = str(payload["name"])
            self.queue_metas.pop((vhost_name, name), None)
            # the reference broadcasts QueueDeleted so exchanges drop binds
            for exchange in vhost.exchanges.values():
                exchange.matcher.unbind_queue(name)
            queue = vhost.queues.get(name)
            if queue is not None:
                queue.deleted = True
                queue.gauges_detach()
                del vhost.queues[name]
            return {}
        return {}

    # ------------------------------------------------------------------
    # node-id lease (snowflake worker ids)
    # ------------------------------------------------------------------

    async def _h_node_id(self, payload: dict) -> dict:
        """Leader hands out monotonically increasing worker ids keyed by
        caller uuid (reference: GlobalNodeIdService.AskNodeId). The counter
        lives in the shared durable store, so ids never repeat even across
        leader failovers."""
        if not hasattr(self, "_lease_map"):
            self._lease_map: dict[str, int] = {}
        uuid = str(payload.get("uuid", ""))
        if uuid not in self._lease_map:
            self._lease_map[uuid] = await self.broker.store.allocate_worker_id()
        return {"worker_id": self._lease_map[uuid]}

    def _repick_worker_id(self) -> None:
        """A member with a lower name gossips this node's worker id: move
        to an id no member has gossiped, before two owners' message ids can
        meet in a follower's store. The lower name keeps its id, and the
        free id is picked by a hash of this node's name, so nodes moving
        at once rarely meet again (and settle when they do)."""
        import hashlib

        from .idgen import IdGenerator, MAX_WORKER_ID

        taken = set(self.membership.peer_worker_ids.values())
        free = [i for i in range(1, MAX_WORKER_ID + 1) if i not in taken]
        if not free:
            log.error("%s: every worker id is taken", self.name)
            return
        digest = hashlib.blake2b(self.name.encode(), digest_size=8).digest()
        worker_id = free[int.from_bytes(digest, "big") % len(free)]
        log.warning("%s: worker id %d clashes; moving to %d", self.name,
                    self.broker.idgen.worker_id, worker_id)
        self.broker.idgen = IdGenerator(worker_id)
        self.membership.worker_id = worker_id

    async def acquire_worker_id(self, uuid: str) -> int:
        assert self.membership is not None
        leader = self.membership.leader()
        if leader == self.name:
            return (await self._h_node_id({"uuid": uuid}))["worker_id"]
        reply = await self._call(leader, "cluster.node-id", {"uuid": uuid})
        return int(reply["worker_id"])

    # ------------------------------------------------------------------
    # owner-side queue op handlers
    # ------------------------------------------------------------------

    async def _local_queue(self, vhost: str, name: str) -> "Queue":
        queue = await self.broker.activate_queue(vhost, name)
        if queue is None:
            raise RpcError("not_found", f"no queue '{name}' in '{vhost}'")
        return queue

    async def _h_queue_declare(self, payload: dict) -> dict:
        queue = await self.broker.declare_queue(
            str(payload["vhost"]), str(payload["name"]),
            durable=bool(payload.get("durable")),
            auto_delete=bool(payload.get("auto_delete")),
            arguments=payload.get("arguments") or {},
        )
        return {"message_count": queue.message_count,
                "consumer_count": queue.consumer_count}

    async def _h_queue_activate(self, payload: dict) -> dict:
        vhost = str(payload["vhost"])
        name = str(payload["name"])
        if self.draining and self.broker.vhosts.get(vhost) is not None \
                and name not in self.broker.vhosts[vhost].queues:
            # a draining node takes no NEW holdership: refuse the cold
            # activation so the caller re-resolves against the ring
            raise RpcError("draining", f"{self.name} is draining")
        if payload.get("handoff") and self.replication is not None:
            # graceful handoff: the source synced our replica copy to its
            # log head before moving holdership — materialize it (private
            # stores have no other path to the message bodies)
            await self.replication.materialize_copy(vhost, name)
        queue = await self.broker.activate_queue(vhost, name)
        return {"active": queue is not None}

    async def _h_queue_delete(self, payload: dict) -> dict:
        count = await self.broker.delete_queue(
            str(payload["vhost"]), str(payload["name"]),
            if_unused=bool(payload.get("if_unused")),
            if_empty=bool(payload.get("if_empty")))
        return {"message_count": count}

    async def _h_queue_purge(self, payload: dict) -> dict:
        queue = await self._local_queue(str(payload["vhost"]), str(payload["name"]))
        return {"message_count": queue.purge()}

    async def _h_queue_stats(self, payload: dict) -> dict:
        queue = await self._local_queue(str(payload["vhost"]), str(payload["name"]))
        return {"message_count": queue.message_count,
                "consumer_count": queue.consumer_count}

    def _push_fenced(self, vhost: str, name: str) -> bool:
        """True when a push for this queue must be refused: this node is
        draining/left and the replicated meta says someone else holds the
        queue — accepting the write would re-claim a queue the drain just
        evacuated (the split-brain the fencing epochs exist to prevent)."""
        if not self.draining:
            return False
        meta = self.queue_metas.get((vhost, name))
        if meta is None:
            return True  # unknown queue: a drainer takes nothing new
        holder = meta.get("holder")
        if holder == self.name:
            return False  # still ours (drain hasn't reached it yet)
        self.broker.metrics.lifecycle_stale_epoch_refused += 1
        return True

    async def _resolve_push_queues(
        self, vhost: str, queue_names: list[str], body_len: int
    ) -> tuple[list, bool]:
        queues = []
        had_consumer = False
        for name in queue_names:
            if self._push_fenced(vhost, name):
                continue
            queue = await self.broker.activate_queue(vhost, name)
            if queue is not None:
                queues.append(queue)
                if any(c.can_take(body_len) for c in queue.consumers):
                    had_consumer = True
        return queues, had_consumer

    async def _h_queue_push(self, payload: dict) -> dict:
        """Accept routed messages for locally-owned queues (the reference's
        QueueEntity.Push ask, QueueEntity.scala:271-316)."""
        vhost = str(payload["vhost"])
        queue_names = [str(q) for q in payload.get("queues") or []]
        _, _, props = BasicProperties.decode_header(bytes(payload["props_raw"]))
        check_consumers = bool(payload.get("check_consumers"))
        body = bytes(payload["body"])
        queues, had_consumer = await self._resolve_push_queues(
            vhost, queue_names, len(body))
        if bool(payload.get("check_only")):
            return {"pushed": False, "had_consumer": had_consumer}
        if check_consumers and not had_consumer:
            return {"pushed": False, "had_consumer": False}
        tr = None
        rt = trace.ACTIVE
        raw_tr = payload.get("_trace")
        if raw_tr is not None and rt is not None:
            tr = rt.adopt(trace.Trace.from_blob(bytes(raw_tr)))
            self.broker.metrics.trace_ctx_recv += 1
        if queues:
            marks: list[tuple[int, int]] = []
            if tr is not None:
                rt.current = tr
                t_apply = time.perf_counter_ns()
            message = self.broker.push_local(
                queues, props, body,
                str(payload["exchange"]), str(payload["routing_key"]),
                bytes(payload["props_raw"]), marks)
            if tr is not None:
                tr.span(trace.REMOTE_APPLY, t_apply,
                        time.perf_counter_ns(), self.name)
                rt.current = None
            if message.persisted:
                # the reply releases the origin's confirm: barrier on the
                # group commit covering the blob + queue-log rows above
                # (attributed to just this push's enqueue window)
                await self.broker.store.flush(marks)
                if self.replication is not None and self.replication.sync:
                    await self.replication.sync_barrier()
        return {"pushed": bool(queues), "had_consumer": had_consumer}

    async def _h_queue_push_many(self, payload: dict) -> dict:
        """Batched queue.push: one RPC carries a whole read batch of plain
        pipelined publishes from one origin connection (order within the
        RPC == publish order; the origin serializes batches at its confirm
        barrier). One store flush covers every persistent push, so the
        owner group-commits the batch exactly like local publishes."""
        await self._flow_stall()
        marks: list[tuple[int, int]] = []
        any_persisted = False
        for push in payload.get("pushes") or []:
            vhost = str(push["vhost"])
            names = [str(q) for q in push.get("queues") or []]
            body = bytes(push["body"])
            queues, _ = await self._resolve_push_queues(vhost, names, len(body))
            if not queues:
                continue
            _, _, props = BasicProperties.decode_header(bytes(push["props_raw"]))
            message = self.broker.push_local(
                queues, props, body,
                str(push["exchange"]), str(push["routing_key"]),
                bytes(push["props_raw"]), marks)
            any_persisted = any_persisted or message.persisted
        if any_persisted:
            await self.broker.store.flush(marks)
            if self.replication is not None and self.replication.sync:
                await self.replication.sync_barrier()
        return {"ok": True}

    async def _flow_stall(self) -> None:
        """Owner-side pushback (flow ladder stage 3): a pressured owner
        delays accepting a push batch for one bounded wait, which holds the
        batch's reply, fills the origin's per-stream in-flight window, and
        ultimately slows the origin's publishers — the cross-hop analogue
        of parking a local publisher. Bounded, never a refusal: at worst a
        batch lands one stall late."""
        flow = self.broker.flow
        if flow is not None and flow.stage >= STAGE_CLUSTER:
            self.broker.metrics.flow_cluster_stalls += 1
            await flow.cluster_stall()

    # ------------------------------------------------------------------
    # data-plane handlers (binary fast path; see cluster/dataplane.py)
    # ------------------------------------------------------------------

    async def _hb_push_many(self, view: memoryview) -> None:
        """Binary queue.push_many: bodies and property headers land as
        memoryview slices of the RPC read buffer and go into Message.body
        uncopied. Same partial-failure contract as the table handler: a
        missing/deleted queue skips ITS push, the rest of the batch lands;
        one store flush group-commits every persistent push. The reply
        releases the origin's confirm barrier. Per-record hot path:
        resolved queues and decoded property headers memoize (origins
        re-send identical routes and props for streams of publishes)."""
        await self._flow_stall()
        self.broker.metrics.rpc_data_bytes_recv += len(view)
        marks: list[tuple[int, int]] = []
        any_persisted = False
        rcache = self.resolve_cache
        rt = trace.ACTIVE
        tctx = trace.decode_trailer(view) if rt is not None else None
        if tctx:
            self.broker.metrics.trace_ctx_recv += len(tctx)
        ridx = -1
        for vhost, names, exchange, routing_key, props_raw, body in \
                dp.decode_push_many(view):
            ridx += 1
            queues = []
            for name in names:
                if self._push_fenced(vhost, name):
                    continue
                queue = rcache.get((vhost, name))
                if queue is None:
                    # slow path activates from the store; misses (unknown
                    # queue) stay uncached so a later declare is seen
                    queue = await self.broker.activate_queue(vhost, name)
                    if queue is None:
                        continue
                    rcache[(vhost, name)] = queue
                queues.append(queue)
            if not queues:
                continue
            props = _props_memo(props_raw)
            tr = tctx.get(ridx) if tctx else None
            if tr is not None:
                tr = rt.adopt(tr)
                rt.current = tr
                t_apply = time.perf_counter_ns()
            message = self.broker.push_local(
                queues, props, body, exchange, routing_key, props_raw, marks)
            if tr is not None:
                tr.span(trace.REMOTE_APPLY, t_apply,
                        time.perf_counter_ns(), self.name)
                rt.current = None
            any_persisted = any_persisted or message.persisted
        if any_persisted:
            await self.broker.store.flush(marks)
            if self.replication is not None and self.replication.sync:
                await self.replication.sync_barrier()
        return None

    async def _hb_settle_many(self, view: memoryview) -> None:
        """Binary queue.settle_many: one frame settles offsets across any
        number of (queue, op, tag) groups coalesced inside the origin's
        flush window. Application order follows frame order, so an ack
        buffered before a requeue of the same consumer applies first."""
        self.broker.metrics.rpc_data_bytes_recv += len(view)
        rt = trace.ACTIVE
        if rt is not None:
            tctx = trace.decode_trailer(view)
            if tctx:
                # merge origin-side deliver/settle spans into the owner's
                # parked copies; the owner's queue.ack below finalizes its
                # own view via message.trace
                self.broker.metrics.trace_ctx_recv += len(tctx)
                for wire_tr in tctx.values():
                    rt.adopt(wire_tr)
        for vhost_name, queue_name, op, tag, credit, offsets in \
                dp.decode_settle_many(view):
            vhost = self.broker.vhosts.get(vhost_name)
            queue = vhost.queues.get(queue_name) if vhost else None
            if queue is None:
                continue
            for offset in offsets:
                delivery = queue.outstanding.get(offset)
                if delivery is None:
                    continue
                if op == "ack":
                    queue.ack(delivery)
                elif op == "drop":
                    queue.drop(delivery)
                else:
                    queue.requeue(delivery)
            if tag and credit:
                for consumer in queue.consumers:
                    if isinstance(consumer, RemoteConsumer) \
                            and consumer.tag == tag:
                        consumer.credit += credit
                        for offset in offsets:
                            consumer.outstanding_offsets.discard(offset)
            queue.schedule_dispatch()
        return None

    async def _hb_deliver_many(self, view: memoryview) -> None:
        """Binary consumer.deliver_many (origin side): every record renders
        to the client synchronously BEFORE any await, so two pipelined
        batches for one consumer can never interleave; credit replenishes
        once per batch."""
        self.broker.metrics.rpc_data_bytes_recv += len(view)
        vhost, queue, tag, records = dp.decode_deliver_many(view)
        key = (vhost, queue, tag)
        info = self._remote_consumers.get(key)
        if info is None:
            return None
        stub = info["stub"]
        channel: "ServerChannel" = info["channel"]
        if channel.closed:
            return None
        from ..broker.entities import Message, QueuedMessage

        rt = trace.ACTIVE
        tctx = trace.decode_trailer(view) if rt is not None else None
        if tctx:
            self.broker.metrics.trace_ctx_recv += len(tctx)
        applied = 0
        for (offset, redelivered, msg_id, expire_at_ms, exchange,
                routing_key, props_raw, body) in records:
            props = _props_memo(props_raw)
            message = Message(
                msg_id, props, body, exchange, routing_key,
                header_raw=props_raw)
            if tctx:
                wire_tr = tctx.get(applied)
                if wire_tr is not None:
                    # stitch: the parked origin half (ingress/route/
                    # cluster-push) merges with the owner-side spans the
                    # trailer carried; deliver/settle stamp below
                    message.trace = rt.adopt(wire_tr)
            qm = QueuedMessage(message, offset, expire_at_ms)
            qm.redelivered = redelivered
            channel.deliver(stub, stub.queue, qm)
            applied += 1
        if info["no_ack"] and applied:
            # replenish credit as we render (owner decremented on send)
            info["pending_credit"] = info.get("pending_credit", 0) + applied
            if info["pending_credit"] >= 32:
                credit = info["pending_credit"]
                info["pending_credit"] = 0
                await self._event(info["owner"], "consumer.credit", {
                    "vhost": vhost, "queue": queue, "tag": tag,
                    "credit": credit})
        return None

    async def _h_queue_get(self, payload: dict) -> dict:
        queue = await self._local_queue(str(payload["vhost"]), str(payload["queue"]))
        qm = await queue.basic_get()
        if qm is None:
            return {"empty": True, "message_count": queue.message_count}
        msg = qm.message
        out = {
            "empty": False,
            "offset": qm.offset,
            "redelivered": qm.redelivered,
            "exchange": msg.exchange,
            "routing_key": msg.routing_key,
            "props_raw": msg.properties.encode_header(len(msg.body)),
            "body": msg.body,
            "msg_id": msg.id,
            "expire_at_ms": qm.expire_at_ms,
            "message_count": queue.message_count,
        }
        if bool(payload.get("no_ack")):
            self.broker.unrefer(msg)
        else:
            from ..broker.entities import Delivery

            delivery = Delivery(qm, queue, None, "", 0, no_ack=False)  # type: ignore[arg-type]
            queue.outstanding[qm.offset] = delivery
            if queue._counted:
                self.broker.queue_unacked += 1
            if queue.durable and msg.persisted:
                self.broker.store_bg(self.broker.store.insert_queue_unacks(
                    queue.vhost, queue.name,
                    [(msg.id, qm.offset, qm.body_size, qm.expire_at_ms)]))
                if queue.repl is not None:
                    queue.repl.append("unacks", {"rows": [
                        [msg.id, qm.offset, qm.body_size, qm.expire_at_ms]]})
        return out

    async def _h_queue_consume(self, payload: dict) -> dict:
        queue = await self._local_queue(str(payload["vhost"]), str(payload["queue"]))
        tag = str(payload["tag"])
        origin = str(payload["origin"])
        # idempotent re-register: replace any previous incarnation
        for consumer in list(queue.consumers):
            if isinstance(consumer, RemoteConsumer) and consumer.tag == tag \
                    and consumer.origin == origin:
                queue.consumers.remove(consumer)
                if queue._counted:
                    self.broker.queue_consumers -= 1
        consumer = RemoteConsumer(
            self, tag, queue, bool(payload.get("no_ack")), origin,
            int(payload.get("credit", DEFAULT_CREDIT)),
            priority=int(payload.get("priority", 0)))
        queue.add_consumer(consumer)
        return {"ok": True}

    async def _h_queue_cancel(self, payload: dict) -> dict:
        vhost = self.broker.vhosts.get(str(payload["vhost"]))
        queue = vhost.queues.get(str(payload["queue"])) if vhost else None
        if queue is None:
            return {"ok": False}
        tag = str(payload["tag"])
        origin = str(payload["origin"])
        for consumer in list(queue.consumers):
            if isinstance(consumer, RemoteConsumer) and consumer.tag == tag \
                    and consumer.origin == origin:
                if bool(payload.get("requeue_outstanding", True)):
                    consumer.requeue_outstanding()
                auto_deleted = queue.remove_consumer(consumer)
                if auto_deleted:
                    self.broker.schedule_queue_delete(queue.vhost, queue.name)
        return {"ok": True}

    async def _h_queue_settle(self, payload: dict) -> dict:
        """Ack/drop/requeue outstanding deliveries by offset (origin -> owner);
        also replenishes the remote consumer's credit."""
        vhost = self.broker.vhosts.get(str(payload["vhost"]))
        queue = vhost.queues.get(str(payload["queue"])) if vhost else None
        if queue is None:
            return {"ok": False}
        op = str(payload.get("op", "ack"))
        offsets = [int(o) for o in payload.get("offsets") or []]
        for offset in offsets:
            delivery = queue.outstanding.get(offset)
            if delivery is None:
                continue
            if op == "ack":
                queue.ack(delivery)
            elif op == "drop":
                queue.drop(delivery)
            else:
                queue.requeue(delivery)
        tag = str(payload.get("tag", ""))
        credit = int(payload.get("credit", 0))
        if tag and credit:
            for consumer in queue.consumers:
                if isinstance(consumer, RemoteConsumer) and consumer.tag == tag:
                    consumer.credit += credit
                    for offset in offsets:
                        consumer.outstanding_offsets.discard(offset)
        queue.schedule_dispatch()
        return {"ok": True}

    async def _h_consumer_credit(self, payload: dict) -> dict:
        vhost = self.broker.vhosts.get(str(payload["vhost"]))
        queue = vhost.queues.get(str(payload["queue"])) if vhost else None
        if queue is None:
            return {"ok": False}
        tag = str(payload["tag"])
        for consumer in queue.consumers:
            if isinstance(consumer, RemoteConsumer) and consumer.tag == tag:
                consumer.credit += int(payload.get("credit", 0))
        queue.schedule_dispatch()
        return {"ok": True}

    # ------------------------------------------------------------------
    # origin-side: deliveries arriving from owners
    # ------------------------------------------------------------------

    async def _apply_remote_delivery(
        self, key: tuple, info: dict, payload: dict
    ) -> bool:
        from ..broker.entities import Message, QueuedMessage

        stub = info["stub"]
        channel: "ServerChannel" = info["channel"]
        if channel.closed:
            return False
        props_raw = bytes(payload["props_raw"])
        _, _, props = BasicProperties.decode_header(props_raw)
        message = Message(
            int(payload["msg_id"]), props, bytes(payload["body"]),
            str(payload["exchange"]), str(payload["routing_key"]),
            header_raw=props_raw)
        qm = QueuedMessage(message, int(payload["offset"]), payload.get("expire_at_ms"))
        qm.redelivered = bool(payload.get("redelivered"))
        channel.deliver(stub, stub.queue, qm)
        if info["no_ack"]:
            # replenish credit as we render (owner decremented on send)
            info["pending_credit"] = info.get("pending_credit", 0) + 1
            if info["pending_credit"] >= 32:
                credit = info["pending_credit"]
                info["pending_credit"] = 0
                await self._event(info["owner"], "consumer.credit", {
                    "vhost": key[0], "queue": key[1], "tag": key[2],
                    "credit": credit})
        return True

    async def _h_consumer_deliver(self, payload: dict) -> dict:
        key = (str(payload["vhost"]), str(payload["queue"]), str(payload["tag"]))
        info = self._remote_consumers.get(key)
        if info is None:
            return {"ok": False}
        return {"ok": await self._apply_remote_delivery(key, info, payload)}

    async def _h_consumer_deliver_many(self, payload: dict) -> dict:
        """One coalesced dispatch pass from an owner: apply every delivery
        in order (credit replenishment accumulates across the batch)."""
        key = (str(payload["vhost"]), str(payload["queue"]), str(payload["tag"]))
        info = self._remote_consumers.get(key)
        if info is None:
            return {"ok": False}
        for delivery in payload.get("deliveries") or []:
            await self._apply_remote_delivery(key, info, delivery)
        return {"ok": True}

    # ------------------------------------------------------------------
    # origin-side proxy API (used by broker/connection)
    # ------------------------------------------------------------------

    async def remote_declare(self, vhost: str, name: str, **kwargs: Any) -> dict:
        owner = self.queue_owner(vhost, name)
        return await self._call(owner, "queue.declare",
                                {"vhost": vhost, "name": name, **kwargs})

    async def remote_delete(self, vhost: str, name: str, *,
                            if_unused: bool = False, if_empty: bool = False) -> int:
        owner = self.queue_owner(vhost, name)
        reply = await self._call(owner, "queue.delete", {
            "vhost": vhost, "name": name,
            "if_unused": if_unused, "if_empty": if_empty})
        return int(reply.get("message_count", 0))

    async def remote_purge(self, vhost: str, name: str) -> int:
        owner = self.queue_owner(vhost, name)
        reply = await self._call(owner, "queue.purge", {"vhost": vhost, "name": name})
        return int(reply.get("message_count", 0))

    async def remote_stats(self, vhost: str, name: str) -> tuple[int, int]:
        owner = self.queue_owner(vhost, name)
        reply = await self._call(owner, "queue.stats", {"vhost": vhost, "name": name})
        return int(reply.get("message_count", 0)), int(reply.get("consumer_count", 0))

    def submit_batch(self, records: list) -> set[asyncio.Future]:
        """Submit a read batch of pipelined publishes to the data plane
        (records: (owner, (vhost, queues, exchange, routing_key, props_raw,
        body)) in publish order) and demand-flush the covering micro-
        batches onto their streams. Synchronous: the RPCs are on the wire
        (or queued behind a stream window) when this returns, so callers
        can keep submitting later batches while earlier ones fly. Bodies
        ride by reference into the binary frames — no copies."""
        futures: set[asyncio.Future] = set()
        planes: dict[str, PeerDataPlane] = {}
        for owner, rec in records:
            plane = planes.get(owner)
            if plane is None:
                planes[owner] = plane = self.dataplane(owner)
            futures.add(plane.submit_push(*rec))
        # demand-flush: this caller's barrier must not wait out the window
        # timer (other connections' pushes may still coalesce in behind)
        for plane in planes.values():
            plane.flush_all(demand=True)
        return futures

    @staticmethod
    async def await_batch(futures: set[asyncio.Future]) -> list[BaseException]:
        """Barrier on submit_batch futures. Returns failures instead of
        raising — the caller's barrier decides strictness (confirm mode:
        connection error; best-effort: logged)."""
        results = await asyncio.gather(*futures, return_exceptions=True)
        return [r for r in results if isinstance(r, BaseException)]

    async def push_batch(self, records: list) -> list[BaseException]:
        """submit_batch + await_batch in one step (synchronous callers)."""
        return await self.await_batch(self.submit_batch(records))

    async def remote_push(
        self, owner: str, vhost: str, queues: list[str], props_raw: bytes,
        body: bytes, exchange: str, routing_key: str, check_consumers: bool,
        check_only: bool = False, tr=None,
    ) -> tuple[bool, bool]:
        payload = {
            "vhost": vhost, "queues": queues, "props_raw": props_raw,
            "body": body, "exchange": exchange, "routing_key": routing_key,
            "check_consumers": check_consumers, "check_only": check_only,
        }
        if tr is not None and not check_only:
            # control-plane trace propagation (the slow mandatory/immediate
            # path); the data plane carries it as the payload trailer
            payload["_trace"] = tr.to_blob()
            rt = trace.ACTIVE
            if rt is not None:
                rt.park(tr)
            self.broker.metrics.trace_ctx_sent += 1
        reply = await self._call(owner, "queue.push", payload)
        return bool(reply.get("pushed")), bool(reply.get("had_consumer"))

    async def remote_get(self, vhost: str, name: str, no_ack: bool) -> dict:
        owner = self.queue_owner(vhost, name)
        return await self._call(owner, "queue.get", {
            "vhost": vhost, "queue": name, "no_ack": no_ack})

    async def remote_consume(
        self, channel: "ServerChannel", vhost: str, name: str, tag: str,
        no_ack: bool, credit: int = 0, priority: int = 0,
    ) -> "RemoteQueueRef":
        # default window: chana.mq.cluster.consume-credit — sized so
        # pipelined deliveries stream ahead of the settle round trip
        credit = credit or self.consume_credit
        owner = self.queue_owner(vhost, name)
        ref = RemoteQueueRef(self, vhost, name)
        from ..broker.channel import Consumer

        stub = Consumer(tag, channel, ref, no_ack, False)  # type: ignore[arg-type]
        self._remote_consumers[(vhost, name, tag)] = {
            "channel": channel, "stub": stub, "no_ack": no_ack,
            "priority": priority,
            "credit": credit, "owner": owner, "pending_credit": 0,
        }
        try:
            await self._call(owner, "queue.consume", {
                "vhost": vhost, "queue": name, "tag": tag,
                "no_ack": no_ack, "origin": self.name, "credit": credit,
                "priority": priority})
        except Exception:
            self._remote_consumers.pop((vhost, name, tag), None)
            raise
        channel.consumers[tag] = stub
        return ref

    def notify_remote_cancel_bg(
        self, origin: str, vhost: str, name: str, tag: str
    ) -> None:
        """Fire-and-forget consumer-cancelled event toward the origin node
        (owner-side queue death under a remote consumer)."""

        async def _notify() -> None:
            try:
                await self._event(origin, "consumer.cancelled", {
                    "vhost": vhost, "queue": name, "tag": tag})
            except Exception:
                log.debug("consumer.cancelled to %s dropped", origin)

        asyncio.get_event_loop().create_task(_notify())

    async def _h_consumer_cancelled(self, payload: dict) -> dict:
        """Origin-side: the owner cancelled our remote consumer (its queue
        died). Deregister the stub and notify the client."""
        key = (str(payload["vhost"]), str(payload["queue"]),
               str(payload["tag"]))
        info = self._remote_consumers.pop(key, None)
        if info is not None:
            channel = info["channel"]
            channel.consumers.pop(key[2], None)
            channel.connection.notify_consumer_cancel(channel, key[2])
        return {}

    async def _h_telemetry_pull(self, payload: dict) -> dict:
        """Serve this node's telemetry snapshot to a peer aggregating the
        cluster view (any node's /admin/timeseries|health|alerts)."""
        svc = self.broker.telemetry
        if svc is None:
            return {"node": self.name, "error": "telemetry disabled"}
        window = max(1, min(int(payload.get("window", 60)), 4096))
        top = max(0, int(payload.get("top", 0)))
        return svc.local_payload(window, top)

    async def _h_slo_pull(self, payload: dict) -> dict:
        """Serve this node's SLO snapshot to a peer aggregating the
        cluster view (any node's GET /admin/slo?scope=cluster)."""
        svc = self.broker.telemetry
        if svc is None or svc.slo is None:
            return {"node": self.name, "error": "slo disabled"}
        return {"node": self.name, **svc.slo.snapshot()}

    async def _h_control_load(self, payload: dict) -> dict:
        """Serve this node's inflow-load figure (bytes/s EWMA) to a peer's
        control plane evaluating a rebalance decision."""
        control = getattr(self.broker, "control", None)
        return {"node": self.name,
                "load": float(control.load_rate) if control is not None
                else 0.0}

    async def remote_cancel(self, vhost: str, name: str, tag: str) -> None:
        info = self._remote_consumers.pop((vhost, name, tag), None)
        if info is None:
            return
        try:
            await self._call(info["owner"], "queue.cancel", {
                "vhost": vhost, "queue": name, "tag": tag, "origin": self.name})
        except (RpcError, OSError):
            pass

    def settle_bg(self, vhost: str, name: str, op: str, offsets: list[int],
                  tag: str = "", credit: int = 0, tr=None) -> None:
        """Fire-and-forget settle (ack/drop/requeue) toward the queue
        owner via the data plane. Settles coalesce per (owner, queue, op,
        tag) inside the peer's flush window — a consumer acking a whole
        read batch (or several consumers across channels) costs one binary
        settle_many frame, not one RPC per message."""
        owner = self.queue_owner(vhost, name)
        self.dataplane(owner).submit_settle(
            vhost, name, op, offsets, tag, credit, tr=tr)

    async def _drain_settles(self) -> None:
        """Flush + await every in-flight settle batch on every peer — the
        data/control-plane ordering fence. The planes ride separate
        connections from the control RPCs, so a settle enqueued before a
        cancel / delete / purge is only guaranteed applied on the owner
        because _call awaits this first (ack-then-cancel in one read batch
        must not requeue the acked message)."""
        for plane in list(self._dataplanes.values()):
            await plane.drain_settles()


class RemoteConsumer:
    """Owner-side representation of a consumer living on another node.
    Implements the Consumer dispatch interface (can_take / deliver / detach)."""

    __slots__ = ("cluster", "tag", "queue", "no_ack", "origin", "credit",
                 "exclusive", "priority", "outstanding_offsets", "_buf",
                 "_buf_count", "_flush_scheduled", "_traces")

    def __init__(self, cluster: ClusterNode, tag: str, queue: "Queue",
                 no_ack: bool, origin: str, credit: int,
                 priority: int = 0) -> None:
        self.cluster = cluster
        self.tag = tag
        self.queue = queue
        self.no_ack = no_ack
        # x-priority forwarded from the origin's basic.consume: the owner's
        # dispatch honors it like a local consumer's
        self.priority = priority
        self.origin = origin
        self.credit = credit
        self.exclusive = False
        self.outstanding_offsets: set[int] = set()
        # per-tick delivery coalescing: every deliver() of one dispatch
        # pass rides a single binary deliver_many event (same pattern as
        # the store's group-commit kick); flat [meta, body, ...] buffers
        self._buf: list = []
        self._buf_count = 0
        self._flush_scheduled = False
        # (record_idx, Trace) entries riding the next deliver_many trailer
        self._traces: list = []

    def can_take(self, next_size: int) -> bool:
        if self.credit <= 0:
            return False
        membership = self.cluster.membership
        return membership is None or membership.is_alive(self.origin)

    def deliver(self, queue: "Queue", qm: "QueuedMessage") -> Optional["Delivery"]:
        from ..broker.entities import Delivery

        self.credit -= 1
        msg = qm.message
        # encode inline: two small buffers per record (meta + body-by-ref),
        # the body is never copied between the queue and the socket
        self._buf.extend(dp.encode_deliver_record(
            qm.offset, qm.redelivered, msg.id, qm.expire_at_ms,
            msg.exchange, msg.routing_key, msg.header_payload(), msg.body))
        if trace.ACTIVE is not None and msg.trace is not None:
            self._traces.append((self._buf_count, msg.trace))
        self._buf_count += 1
        if not self._flush_scheduled:
            self._flush_scheduled = True
            asyncio.get_event_loop().call_soon(self._flush)
        if self.no_ack:
            return None
        self.outstanding_offsets.add(qm.offset)
        return Delivery(qm, queue, None, self.tag, 0, no_ack=False)  # type: ignore[arg-type]

    # keep each deliver_many event frame comfortably under rpc.MAX_FRAME
    # (64 MB): big-bodied backlogs split into multiple ordered events
    _FLUSH_BYTES = 8 * 1024 * 1024

    def _flush(self) -> None:
        """Ship the coalesced dispatch pass as binary deliver_many events
        (one per size-capped chunk, all striped onto the same data stream
        so they render in order on the origin)."""
        self._flush_scheduled = False
        if not self._buf:
            return
        records, self._buf = self._buf, []
        count, self._buf_count = self._buf_count, 0
        traces, self._traces = self._traces, []
        plane = self.cluster.dataplane(self.origin)
        chunk: list = []
        chunk_count = 0
        size = 0
        base = 0  # first record index of the current chunk
        # records is a flat [meta, body, meta, body, ...] buffer list
        for i in range(0, len(records), 2):
            chunk.append(records[i])
            chunk.append(records[i + 1])
            chunk_count += 1
            size += len(records[i]) + len(records[i + 1])
            if size >= self._FLUSH_BYTES:
                plane.send_deliver_many(
                    self.queue.vhost, self.queue.name, self.tag,
                    chunk, chunk_count,
                    traces=[(ri - base, t) for ri, t in traces
                            if base <= ri < base + chunk_count]
                    if traces else None)
                base += chunk_count
                chunk, chunk_count, size = [], 0, 0
        if chunk:
            plane.send_deliver_many(
                self.queue.vhost, self.queue.name, self.tag,
                chunk, chunk_count,
                traces=[(ri - base, t) for ri, t in traces if ri >= base]
                if traces else None)

    def detach(self) -> None:
        """The owner's queue died under this remote consumer: tell the
        origin node so it can deregister the stub and send the client a
        Basic.Cancel (consumer_cancel_notify)."""
        self.cluster.notify_remote_cancel_bg(
            self.origin, self.queue.vhost, self.queue.name, self.tag)

    def requeue_outstanding(self) -> None:
        for offset in sorted(self.outstanding_offsets):
            delivery = self.queue.outstanding.get(offset)
            if delivery is not None:
                self.queue.requeue(delivery)
        self.outstanding_offsets.clear()


class RemoteQueueRef:
    """Origin-side facade standing in for a remotely-owned queue in the
    channel bookkeeping (ack/requeue/drop route over RPC)."""

    __slots__ = ("cluster", "vhost", "name")

    def __init__(self, cluster: ClusterNode, vhost: str, name: str) -> None:
        self.cluster = cluster
        self.vhost = vhost
        self.name = name

    # channel bookkeeping hooks ------------------------------------------

    def ack(self, delivery: "Delivery") -> None:
        tr = None
        if trace.ACTIVE is not None:
            tr = delivery.queued.message.trace
            if tr is not None:
                trace.ACTIVE.on_settle(tr, self.cluster.broker.trace_node)
        self.cluster.settle_bg(
            self.vhost, self.name, "ack", [delivery.queued.offset],
            tag=delivery.consumer_tag, credit=1, tr=tr)

    def drop(self, delivery: "Delivery") -> None:
        tr = None
        if trace.ACTIVE is not None:
            tr = delivery.queued.message.trace
            if tr is not None:
                trace.ACTIVE.on_settle(tr, self.cluster.broker.trace_node)
        self.cluster.settle_bg(
            self.vhost, self.name, "drop", [delivery.queued.offset],
            tag=delivery.consumer_tag, credit=1, tr=tr)

    def requeue(self, delivery: "Delivery") -> None:
        self.cluster.settle_bg(
            self.vhost, self.name, "requeue", [delivery.queued.offset],
            tag=delivery.consumer_tag, credit=1)

    def schedule_dispatch(self) -> None:
        pass

    def remove_consumer(self, consumer: Any) -> bool:
        asyncio.get_event_loop().create_task(
            self.cluster.remote_cancel(self.vhost, self.name, consumer.tag))
        return False

    @property
    def consumers(self) -> list:
        return []

    def has_exclusive_consumer(self) -> bool:
        return False
