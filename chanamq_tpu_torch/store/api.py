"""Abstract store interface.

Capability parity with the reference's `DBOpService` trait
(chana-mq-server .../store/package.scala:15-43), which exposes ~21 async
operations over messages, queue metas/messages/unacks, exchanges, binds and
vhosts. This interface keeps the same functional surface with an async
Python shape; writes on durable mutations are awaited by the broker before
acknowledging (the reference's Cassandra impl secretly blocked —
CassandraOpService.scala:753-755 — a scar SURVEY.md §7.3 says to avoid).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
from dataclasses import dataclass, field
from typing import Any, Optional

log = logging.getLogger("chanamq.store")


def _done_future() -> "asyncio.Future[None]":
    fut: asyncio.Future = asyncio.get_event_loop().create_future()
    fut.set_result(None)
    return fut


# -- replica namespaces (replicate/) ----------------------------------------
# A follower keeps its warm passive copy of a replicated queue under a
# namespaced vhost so the copy shares the blob table / group-commit engine
# with real data but can never collide with it: '\x00' is illegal in AMQP
# short strings, so no client-declared vhost can start with the marker.
# all_queues() excludes replica namespaces — recovery must not resurrect
# passive copies as live queues.

REPLICA_NS = "\x00repl\x00"


def replica_vhost(vhost: str) -> str:
    return REPLICA_NS + vhost


def is_replica_vhost(vhost: str) -> bool:
    return vhost.startswith(REPLICA_NS)


def real_vhost(vhost: str) -> str:
    return vhost[len(REPLICA_NS):] if is_replica_vhost(vhost) else vhost




@dataclass(slots=True)
class StoredMessage:
    id: int
    properties_raw: bytes  # encoded content-header payload (props + body size)
    body: bytes
    exchange: str
    routing_key: str
    refer_count: int
    ttl_ms: Optional[int] = None


@dataclass(slots=True)
class StoredQueue:
    vhost: str
    name: str
    durable: bool = True
    exclusive: bool = False
    auto_delete: bool = False
    ttl_ms: Optional[int] = None
    last_consumed: int = 0
    arguments: dict[str, Any] = field(default_factory=dict)
    # (offset, msg_id, body_size, expire_at_ms|None) of pending messages
    msgs: list[tuple[int, int, int, Optional[int]]] = field(default_factory=list)
    # msg_id -> (offset, body_size, expire_at_ms|None)
    unacks: dict[int, tuple[int, int, Optional[int]]] = field(default_factory=dict)


@dataclass(slots=True)
class StoredExchange:
    vhost: str
    name: str
    type: str
    durable: bool = True
    auto_delete: bool = False
    internal: bool = False
    arguments: dict[str, Any] = field(default_factory=dict)
    # (routing_key, queue, arguments)
    binds: list[tuple[str, str, Optional[dict]]] = field(default_factory=list)
    # exchange-to-exchange bindings: (routing_key, destination, arguments)
    ex_binds: list[tuple[str, str, Optional[dict]]] = field(default_factory=list)


class StoreService:
    """Pluggable durable store. All methods are coroutines."""

    # -- lifecycle --------------------------------------------------------

    async def open(self) -> None: ...

    async def close(self) -> None: ...

    def flush(self, intervals: Optional[list[tuple[int, int]]] = None):
        """Durability barrier: awaitable resolving once every operation
        enqueued so far is committed. Backends that commit synchronously
        (memory) return an immediately-complete awaitable.

        intervals: optional list of (mark_before, mark_after) enqueue
        windows captured via mark(); backends with failure attribution
        (SqliteStore) raise only for failures inside the caller's own
        windows, so one publisher's failed write never errors — or silently
        passes under — another publisher's barrier."""
        return _done_future()

    def mark(self) -> int:
        """Op-sequence watermark for flush(intervals=...). Backends without
        enqueue sequencing return 0 (callers then pass empty/degenerate
        intervals and flush() behaves as a plain barrier)."""
        return 0

    async def approx_data_bytes(self) -> Optional[int]:
        """Approximate live data size of the store, in bytes, for the
        store-growth gate (chana.mq.store.max-bytes): when a paging flood
        is absorbing into the store faster than consumers drain it, the
        broker blocks publishers on this gauge the same way it does on
        resident RAM. None = backend cannot report (gate inert)."""
        return None

    # -- fire-and-forget fast paths ----------------------------------------
    # The per-message hot ops (message blob, queue-log row, unack rows) are
    # written fire-and-forget: callers need program-order enqueueing and
    # barrier coverage, not a per-op completion handle. Backends override
    # these to skip the future machinery (SqliteStore enqueues a bare
    # callable; MemoryStore applies eagerly); the defaults wrap the async
    # variant in a logged task so any backend is correct out of the box.

    # background write failures feed telemetry's store-error window and
    # the readiness gate; always present so health code reads it directly
    error_count: int = 0

    def _fire(self, aw) -> None:
        """Track a fire-and-forget store write: kept alive in a per-store
        set (an un-referenced task may be GC'd before running), failures
        logged, drained by drain_nowait() at shutdown. This is THE
        fire-and-forget tracker — Broker.store_bg routes here too."""
        tasks = getattr(self, "_fired_tasks", None)
        if tasks is None:
            tasks = self._fired_tasks = set()
        task = asyncio.ensure_future(aw)
        tasks.add(task)
        task.add_done_callback(self._fire_done)

    def _fire_done(self, task) -> None:
        self._fired_tasks.discard(task)
        if not task.cancelled() and task.exception():
            # error_count feeds the health readiness check (telemetry/):
            # a store that is failing background writes is not ready
            self.error_count = getattr(self, "error_count", 0) + 1
            log.error("background store write failed: %r", task.exception())

    async def drain_nowait(self) -> None:
        """Let tracked fire-and-forget writes land — call before close().
        (Backends overriding every *_nowait op may have nothing here; the
        built-ins apply/enqueue at call time and flush in close().)"""
        tasks = getattr(self, "_fired_tasks", None)
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)

    def insert_message_nowait(self, msg: StoredMessage) -> None:
        self._fire(self.insert_message(msg))

    def insert_queue_msg_nowait(
        self, vhost: str, queue: str, offset: int, msg_id: int,
        body_size: int, expire_at_ms: Optional[int],
    ) -> None:
        self._fire(self.insert_queue_msg(
            vhost, queue, offset, msg_id, body_size, expire_at_ms))

    def insert_queue_unacks_nowait(
        self, vhost: str, queue: str,
        unacks: list[tuple[int, int, int, Optional[int]]],
    ) -> None:
        self._fire(self.insert_queue_unacks(vhost, queue, unacks))

    # -- messages (refcounted blobs; reference: insertMessage/selectMessage/
    #    deleteMessage + referMessage/unreferMessage) ----------------------

    async def insert_message(self, msg: StoredMessage) -> None:
        raise NotImplementedError

    async def select_message(self, msg_id: int) -> Optional[StoredMessage]:
        raise NotImplementedError

    async def select_messages(self, msg_ids: list[int]) -> dict[int, StoredMessage]:
        """Batch form of select_message (hot on the hydration path —
        reattaching passivated bodies at a queue head). Missing ids are
        simply absent from the result."""
        out: dict[int, StoredMessage] = {}
        for msg_id in msg_ids:
            msg = await self.select_message(msg_id)
            if msg is not None:
                out[msg_id] = msg
        return out

    async def select_message_metas(self, msg_ids: list[int]) -> dict[int, StoredMessage]:
        """Batch metadata read: like select_messages but bodies are omitted
        (body=None) — recovery uses it to rebuild deep backlogs without
        holding every blob in RAM. The default strips bodies after a full
        read so every backend keeps the contract; backends that can skip
        the body column entirely (SqliteStore) override it and also avoid
        the blob I/O."""
        full = await self.select_messages(msg_ids)
        # strip into fresh copies: select_messages makes no promise that
        # the returned objects aren't the backend's own cached instances,
        # so mutating them in place could corrupt the store
        return {
            mid: dataclasses.replace(meta, body=None)  # type: ignore[arg-type]
            for mid, meta in full.items()
        }

    async def delete_message(self, msg_id: int) -> None:
        raise NotImplementedError

    async def delete_messages(self, msg_ids: list[int]) -> None:
        """Batch form of delete_message (hot on the ack path)."""
        for msg_id in msg_ids:
            await self.delete_message(msg_id)

    async def update_message_refer_count(self, msg_id: int, count: int) -> None:
        raise NotImplementedError

    # -- queue meta (reference: insertQueueMeta/selectQueueMeta/deleteQueueMeta)

    async def insert_queue_meta(self, q: StoredQueue) -> None:
        raise NotImplementedError

    async def select_queue(self, vhost: str, name: str) -> Optional[StoredQueue]:
        """Reconstruct meta + pending msgs + unacks (reference: selectQueue)."""
        raise NotImplementedError

    async def all_queues(self, vhost: Optional[str] = None) -> list[StoredQueue]:
        """Every stored queue, EXCLUDING replica namespaces (passive copies
        must never recover as live queues)."""
        raise NotImplementedError

    # -- queue message log (reference: insertQueueMsg/deleteQueueMsg) ------

    async def insert_queue_msg(
        self, vhost: str, queue: str, offset: int, msg_id: int,
        body_size: int, expire_at_ms: Optional[int],
    ) -> None:
        raise NotImplementedError

    async def delete_queue_msg(self, vhost: str, queue: str, offset: int) -> None:
        raise NotImplementedError

    async def iter_queue_msgs(
        self, vhost: str, queue: str, after_offset: int, limit: int
    ) -> list[tuple[int, int, int, Optional[int]]]:
        """Page through a queue's pending log rows in offset order:
        up to `limit` rows with offset > after_offset, as
        (offset, msg_id, body_size, expire_at_ms). Replication resync uses
        this to stream the owner's snapshot in bounded chunks. The default
        rides select_queue; SqliteStore overrides with a ranged query."""
        sq = await self.select_queue(vhost, queue)
        if sq is None:
            return []
        rows = sorted(m for m in sq.msgs if m[0] > after_offset)
        return rows[:limit]

    async def replace_queue_msgs(
        self, vhost: str, queue: str,
        msgs: list[tuple[int, int, int, Optional[int]]],
    ) -> None:
        """Swap a queue's pending log rows wholesale (replication resync
        installs the owner's snapshot; promotion materializes a passive
        copy). msgs: (offset, msg_id, body_size, expire_at_ms)."""
        await self.purge_queue_msgs(vhost, queue)
        for offset, msg_id, body_size, expire_at_ms in msgs:
            await self.insert_queue_msg(
                vhost, queue, offset, msg_id, body_size, expire_at_ms)

    async def replace_queue_unacks(
        self, vhost: str, queue: str,
        unacks: list[tuple[int, int, int, Optional[int]]],
    ) -> None:
        """Swap a queue's unack rows wholesale (companion of
        replace_queue_msgs). unacks: (msg_id, offset, body_size,
        expire_at_ms)."""
        existing = await self.select_queue(vhost, queue)
        if existing and existing.unacks:
            await self.delete_queue_unacks(
                vhost, queue, list(existing.unacks))
        if unacks:
            await self.insert_queue_unacks(vhost, queue, unacks)

    # -- consumption watermark + unacks (reference: updateQueueLastConsumed,
    #    insertQueueUnack/deleteQueueUnack) --------------------------------

    async def update_queue_last_consumed(
        self, vhost: str, queue: str, last_consumed: int
    ) -> None:
        raise NotImplementedError

    async def insert_queue_unacks(
        self, vhost: str, queue: str,
        unacks: list[tuple[int, int, int, Optional[int]]],
    ) -> None:
        """unacks: (msg_id, offset, body_size, expire_at_ms|None)."""
        raise NotImplementedError

    async def delete_queue_msgs_offsets(
        self, vhost: str, queue: str, offsets: list[int]
    ) -> None:
        """Remove specific queue-log rows by offset. Priority queues settle
        per-row (consumption is not in offset order, so the lastConsumed
        watermark cannot prune for them)."""
        raise NotImplementedError

    async def delete_queue_unacks(
        self, vhost: str, queue: str, msg_ids: list[int]
    ) -> None:
        raise NotImplementedError

    # -- queue delete with archival (reference: pendingDeleteQueue copies
    #    rows into *_deleted tables before deleting, then forceDeleteQueue)

    async def archive_queue(self, vhost: str, queue: str) -> None:
        raise NotImplementedError

    async def delete_queue(self, vhost: str, queue: str) -> None:
        raise NotImplementedError

    async def purge_queue_msgs(self, vhost: str, queue: str) -> None:
        raise NotImplementedError

    # -- stream segments + cursors (streams/: no reference analogue — the
    #    reference has no log queues). Sealed segments persist as one blob
    #    row each; cursors are the server-tracked committed offsets, keyed
    #    by consumer tag, that let reconnecting stream readers resume. ----

    async def insert_stream_segment(
        self, vhost: str, queue: str, base_offset: int, last_offset: int,
        first_ts_ms: int, last_ts_ms: int, size_bytes: int, blob: bytes,
    ) -> None:
        raise NotImplementedError

    async def select_stream_segment(
        self, vhost: str, queue: str, base_offset: int
    ) -> Optional[bytes]:
        raise NotImplementedError

    async def stream_segment_metas(
        self, vhost: str, queue: str
    ) -> list[tuple[int, int, int, int, int]]:
        """Segment index in base-offset order, blobs omitted:
        (base_offset, last_offset, first_ts_ms, last_ts_ms, size_bytes).
        Recovery rebuilds the in-memory log from this alone."""
        raise NotImplementedError

    async def delete_stream_segments(
        self, vhost: str, queue: str, base_offsets: list[int]
    ) -> None:
        """Whole-segment truncation (retention / purge)."""
        raise NotImplementedError

    async def update_stream_cursor(
        self, vhost: str, queue: str, name: str, committed_offset: int
    ) -> None:
        raise NotImplementedError

    async def select_stream_cursors(
        self, vhost: str, queue: str
    ) -> dict[str, int]:
        """cursor name -> committed offset."""
        raise NotImplementedError

    async def delete_stream_data(self, vhost: str, queue: str) -> None:
        """Drop ALL of a stream's segments and cursors (queue delete)."""
        raise NotImplementedError

    # -- exchanges + binds (reference: insertExchange/selectExchange/
    #    deleteExchange, insertExchangeBind/deleteExchangeBind) ------------

    async def insert_exchange(self, ex: StoredExchange) -> None:
        raise NotImplementedError

    async def select_exchange(self, vhost: str, name: str) -> Optional[StoredExchange]:
        raise NotImplementedError

    async def all_exchanges(self, vhost: Optional[str] = None) -> list[StoredExchange]:
        raise NotImplementedError

    async def delete_exchange(self, vhost: str, name: str) -> None:
        raise NotImplementedError

    async def insert_bind(
        self, vhost: str, exchange: str, queue: str, routing_key: str,
        arguments: Optional[dict],
    ) -> None:
        raise NotImplementedError

    async def delete_bind(
        self, vhost: str, exchange: str, queue: str, routing_key: str
    ) -> None:
        raise NotImplementedError

    async def delete_queue_binds(self, vhost: str, queue: str) -> None:
        raise NotImplementedError

    # -- exchange-to-exchange binds (no reference analogue: the reference
    #    stubs Exchange.Bind/Unbind, FrameStage.scala:1023-1027) -----------

    async def insert_exchange_bind(
        self, vhost: str, source: str, destination: str, routing_key: str,
        arguments: Optional[dict],
    ) -> None:
        raise NotImplementedError

    async def delete_exchange_bind(
        self, vhost: str, source: str, destination: str, routing_key: str
    ) -> None:
        raise NotImplementedError

    async def delete_exchange_binds_dest(
        self, vhost: str, destination: str
    ) -> None:
        """Remove every e2e bind targeting a deleted destination exchange."""
        raise NotImplementedError

    # -- cluster worker-id allocation (reference: GlobalNodeIdService hands
    #    out monotonically increasing ids; here the shared store is the
    #    durable counter so ids never repeat across leader failovers) ------

    async def allocate_worker_id(self) -> int:
        raise NotImplementedError

    # -- vhosts (reference: insertVhost/selectAllVhosts/deleteVhost) -------

    async def insert_vhost(self, name: str, active: bool = True) -> None:
        raise NotImplementedError

    async def all_vhosts(self) -> list[tuple[str, bool]]:
        raise NotImplementedError

    async def delete_vhost(self, name: str) -> None:
        raise NotImplementedError
