"""In-memory StoreService — transient mode and test double.

Functionally complete (everything select_queue / recovery needs works), just
not durable across process restarts. Useful for unit tests and as the broker
default when no store is configured.

Write methods take effect at CALL time and return an already-completed
awaitable, mirroring SqliteStore._submit's enqueue-at-call-time property:
program order == store order regardless of when (or whether) the caller
awaits. This matters for correctness, not just symmetry — the broker pages
message bodies out via fire-and-forget store_bg(insert_message(...)) and a
pipelined basic.get may read the blob back with zero event-loop yields in
between; a lazily-run write task would make that read miss a just-paged
message.
"""

from __future__ import annotations

import copy
from typing import Optional

from .api import (
    StoredExchange, StoredMessage, StoredQueue, StoreService,
    is_replica_vhost,
)


class _Done:
    """Already-completed awaitable returned by eager write methods."""

    __slots__ = ()

    def __await__(self):
        return iter(())


_DONE = _Done()


class MemoryStore(StoreService):
    def __init__(self) -> None:
        self.messages: dict[int, StoredMessage] = {}
        self.queues: dict[tuple[str, str], StoredQueue] = {}
        self.exchanges: dict[tuple[str, str], StoredExchange] = {}
        self.vhosts: dict[str, bool] = {}
        self.archived: dict[tuple[str, str], StoredQueue] = {}
        # stream log: (vhost, queue) -> {base_offset: (meta..., blob)}
        # where meta is (base, last, first_ts_ms, last_ts_ms, size_bytes)
        self.stream_segments: dict[
            tuple[str, str], dict[int, tuple[int, int, int, int, int, bytes]]
        ] = {}
        # (vhost, queue) -> {cursor name: committed offset}
        self.stream_cursors: dict[tuple[str, str], dict[str, int]] = {}
        self._next_worker_id = 0
        self._data_bytes = 0  # running sum of stored body bytes

    async def open(self) -> None:
        pass

    async def close(self) -> None:
        pass

    async def approx_data_bytes(self) -> int:
        # message blobs dominate; metadata rows are noise next to bodies.
        # Running counter (maintained by insert/delete): the sweep samples
        # this each tick, so an O(n) sum would stall the loop at scale.
        return self._data_bytes

    # -- messages ---------------------------------------------------------

    def insert_message(self, msg: StoredMessage):
        old = self.messages.get(msg.id)
        if old is not None:
            self._data_bytes -= len(old.body)
        self._data_bytes += len(msg.body)
        self.messages[msg.id] = copy.copy(msg)
        return _DONE

    async def select_message(self, msg_id: int) -> Optional[StoredMessage]:
        msg = self.messages.get(msg_id)
        return copy.copy(msg) if msg else None

    def delete_message(self, msg_id: int):
        old = self.messages.pop(msg_id, None)
        if old is not None:
            self._data_bytes -= len(old.body)
        return _DONE

    def delete_messages(self, msg_ids):
        for msg_id in msg_ids:
            old = self.messages.pop(msg_id, None)
            if old is not None:
                self._data_bytes -= len(old.body)
        return _DONE

    def update_message_refer_count(self, msg_id: int, count: int):
        msg = self.messages.get(msg_id)
        if msg:
            msg.refer_count = count
        return _DONE

    # -- queue meta -------------------------------------------------------

    def insert_queue_meta(self, q: StoredQueue):
        existing = self.queues.get((q.vhost, q.name))
        stored = copy.deepcopy(q)
        if existing:
            stored.msgs = existing.msgs
            stored.unacks = existing.unacks
        self.queues[(q.vhost, q.name)] = stored
        return _DONE

    async def select_queue(self, vhost: str, name: str) -> Optional[StoredQueue]:
        q = self.queues.get((vhost, name))
        return copy.deepcopy(q) if q else None

    async def all_queues(self, vhost: Optional[str] = None) -> list[StoredQueue]:
        return [
            copy.deepcopy(q)
            for (vh, _), q in self.queues.items()
            if not is_replica_vhost(vh) and (vhost is None or vh == vhost)
        ]

    # -- queue log --------------------------------------------------------

    def insert_queue_msg(self, vhost, queue, offset, msg_id, body_size, expire_at_ms):
        q = self.queues.get((vhost, queue))
        if q:
            q.msgs.append((offset, msg_id, body_size, expire_at_ms))
        return _DONE

    def delete_queue_msg(self, vhost, queue, offset):
        q = self.queues.get((vhost, queue))
        if q:
            q.msgs = [m for m in q.msgs if m[0] != offset]
        return _DONE

    # -- watermark + unacks ------------------------------------------------

    def update_queue_last_consumed(self, vhost, queue, last_consumed):
        q = self.queues.get((vhost, queue))
        if q:
            q.last_consumed = last_consumed
            q.msgs = [m for m in q.msgs if m[0] > last_consumed]
        return _DONE

    def insert_queue_unacks(self, vhost, queue, unacks):
        q = self.queues.get((vhost, queue))
        if q:
            for msg_id, offset, body_size, expire_at_ms in unacks:
                q.unacks[msg_id] = (offset, body_size, expire_at_ms)
        return _DONE

    def delete_queue_msgs_offsets(self, vhost, queue, offsets):
        q = self.queues.get((vhost, queue))
        if q:
            drop = set(offsets)
            q.msgs = [m for m in q.msgs if m[0] not in drop]
        return _DONE

    def delete_queue_unacks(self, vhost, queue, msg_ids):
        q = self.queues.get((vhost, queue))
        if q:
            for msg_id in msg_ids:
                q.unacks.pop(msg_id, None)
        return _DONE

    def replace_queue_msgs(self, vhost, queue, msgs):
        q = self.queues.get((vhost, queue))
        if q:
            q.msgs = [tuple(m) for m in msgs]
        return _DONE

    def replace_queue_unacks(self, vhost, queue, unacks):
        q = self.queues.get((vhost, queue))
        if q:
            q.unacks = {
                msg_id: (offset, body_size, expire_at_ms)
                for msg_id, offset, body_size, expire_at_ms in unacks
            }
        return _DONE

    # -- fire-and-forget fast paths: writes already apply at call time, so
    #    the nowait variants just drop the _DONE handle -------------------

    def insert_message_nowait(self, msg: StoredMessage) -> None:
        self.insert_message(msg)

    def insert_queue_msg_nowait(
            self, vhost, queue, offset, msg_id, body_size, expire_at_ms) -> None:
        self.insert_queue_msg(vhost, queue, offset, msg_id, body_size, expire_at_ms)

    def insert_queue_unacks_nowait(self, vhost, queue, unacks) -> None:
        self.insert_queue_unacks(vhost, queue, unacks)

    # -- delete/archive ----------------------------------------------------

    def archive_queue(self, vhost, queue):
        q = self.queues.get((vhost, queue))
        if q:
            self.archived[(vhost, queue)] = copy.deepcopy(q)
        return _DONE

    def delete_queue(self, vhost, queue):
        self.queues.pop((vhost, queue), None)
        return _DONE

    def purge_queue_msgs(self, vhost, queue):
        q = self.queues.get((vhost, queue))
        if q:
            q.msgs = []
        return _DONE

    # -- stream segments + cursors -----------------------------------------

    def insert_stream_segment(self, vhost, queue, base_offset, last_offset,
                              first_ts_ms, last_ts_ms, size_bytes, blob):
        segs = self.stream_segments.setdefault((vhost, queue), {})
        old = segs.get(base_offset)
        if old is not None:
            self._data_bytes -= len(old[5])
        segs[base_offset] = (base_offset, last_offset, first_ts_ms,
                             last_ts_ms, size_bytes, blob)
        self._data_bytes += len(blob)
        return _DONE

    async def select_stream_segment(self, vhost, queue, base_offset):
        seg = self.stream_segments.get((vhost, queue), {}).get(base_offset)
        return seg[5] if seg else None

    async def stream_segment_metas(self, vhost, queue):
        segs = self.stream_segments.get((vhost, queue), {})
        return [seg[:5] for _, seg in sorted(segs.items())]

    def delete_stream_segments(self, vhost, queue, base_offsets):
        segs = self.stream_segments.get((vhost, queue))
        if segs:
            for base in base_offsets:
                old = segs.pop(base, None)
                if old is not None:
                    self._data_bytes -= len(old[5])
        return _DONE

    def update_stream_cursor(self, vhost, queue, name, committed_offset):
        self.stream_cursors.setdefault(
            (vhost, queue), {})[name] = committed_offset
        return _DONE

    async def select_stream_cursors(self, vhost, queue):
        return dict(self.stream_cursors.get((vhost, queue), {}))

    def delete_stream_data(self, vhost, queue):
        segs = self.stream_segments.pop((vhost, queue), None)
        if segs:
            for seg in segs.values():
                self._data_bytes -= len(seg[5])
        self.stream_cursors.pop((vhost, queue), None)
        return _DONE

    # -- exchanges + binds -------------------------------------------------

    def insert_exchange(self, ex: StoredExchange):
        existing = self.exchanges.get((ex.vhost, ex.name))
        stored = copy.deepcopy(ex)
        if existing:
            stored.binds = existing.binds
            stored.ex_binds = existing.ex_binds
        self.exchanges[(ex.vhost, ex.name)] = stored
        return _DONE

    async def select_exchange(self, vhost, name) -> Optional[StoredExchange]:
        ex = self.exchanges.get((vhost, name))
        return copy.deepcopy(ex) if ex else None

    async def all_exchanges(self, vhost: Optional[str] = None) -> list[StoredExchange]:
        return [
            copy.deepcopy(ex)
            for (vh, _), ex in self.exchanges.items()
            if vhost is None or vh == vhost
        ]

    def delete_exchange(self, vhost, name):
        self.exchanges.pop((vhost, name), None)
        return _DONE

    def insert_bind(self, vhost, exchange, queue, routing_key, arguments):
        ex = self.exchanges.get((vhost, exchange))
        if ex is not None:
            entry = (routing_key, queue, arguments)
            if entry not in ex.binds:
                ex.binds.append(entry)
        return _DONE

    def delete_bind(self, vhost, exchange, queue, routing_key):
        ex = self.exchanges.get((vhost, exchange))
        if ex is not None:
            ex.binds = [
                b for b in ex.binds if not (b[0] == routing_key and b[1] == queue)
            ]
        return _DONE

    def delete_queue_binds(self, vhost, queue):
        for (vh, _), ex in self.exchanges.items():
            if vh == vhost:
                ex.binds = [b for b in ex.binds if b[1] != queue]
        return _DONE

    def insert_exchange_bind(self, vhost, source, destination, routing_key, arguments):
        ex = self.exchanges.get((vhost, source))
        if ex is not None:
            entry = (routing_key, destination, arguments)
            if entry not in ex.ex_binds:
                ex.ex_binds.append(entry)
        return _DONE

    def delete_exchange_bind(self, vhost, source, destination, routing_key):
        ex = self.exchanges.get((vhost, source))
        if ex is not None:
            ex.ex_binds = [
                b for b in ex.ex_binds
                if not (b[0] == routing_key and b[1] == destination)
            ]
        return _DONE

    def delete_exchange_binds_dest(self, vhost, destination):
        for (vh, _), ex in self.exchanges.items():
            if vh == vhost:
                ex.ex_binds = [b for b in ex.ex_binds if b[1] != destination]
        return _DONE

    async def allocate_worker_id(self) -> int:
        self._next_worker_id += 1
        return self._next_worker_id

    # -- vhosts ------------------------------------------------------------

    def insert_vhost(self, name: str, active: bool = True):
        self.vhosts[name] = active
        return _DONE

    async def all_vhosts(self) -> list[tuple[str, bool]]:
        return list(self.vhosts.items())

    def delete_vhost(self, name: str):
        self.vhosts.pop(name, None)
        return _DONE
