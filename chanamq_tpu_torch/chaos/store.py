"""Chaos wrapper around a ``StoreService``.

Only constructed when ``chana.mq.chaos.enabled`` is set — a plain broker
keeps the bare store object and pays literally nothing. The wrapper
classifies every store method into a read / write / delete site and
consults the active plan before delegating; the flush barrier gets its own
site so a "slow disk" rule can stall confirms without touching the
in-memory fast path.

Fire-and-forget helpers (``*_nowait``, ``mark``) and internal trackers
pass straight through — they have no awaitable seam to inject into; their
durability is already funneled through ``flush``, which is wrapped.
"""

from __future__ import annotations

from functools import wraps

# method-name -> chaos site classification for StoreService
_READ = frozenset({
    "select_message", "select_messages", "select_message_metas",
    "select_queue", "all_queues", "iter_queue_msgs",
    "select_stream_segment", "stream_segment_metas", "select_stream_cursors",
    "all_exchanges", "select_exchange", "all_vhosts",
})
_WRITE = frozenset({
    "insert_message", "update_message_refer_count", "insert_queue_meta",
    "insert_queue_msg", "insert_queue_unacks", "replace_queue_msgs",
    "replace_queue_unacks", "update_queue_last_consumed",
    "insert_stream_segment", "update_stream_cursor", "insert_exchange",
    "insert_bind", "insert_exchange_bind", "insert_vhost", "archive_queue",
})
_DELETE = frozenset({
    "delete_message", "delete_messages", "delete_queue_msg",
    "delete_queue_msgs_offsets", "delete_queue_unacks", "delete_queue",
    "purge_queue_msgs", "delete_stream_segments", "delete_stream_data",
    "delete_exchange", "delete_bind", "delete_queue_binds",
    "delete_exchange_bind", "delete_exchange_binds_dest", "delete_vhost",
})


def _site_for(name: str) -> str | None:
    if name in _READ:
        return "store.read"
    if name in _WRITE:
        return "store.write"
    if name in _DELETE:
        return "store.delete"
    return None


class ChaosStore:
    """Injection proxy over a real store. ``drop`` on a store site means
    "the operation silently did nothing" — reads return None, writes and
    deletes are swallowed — which is how a torn/failed disk op looks to
    the layers above."""

    def __init__(self, inner, runtime) -> None:
        self._inner = inner
        self._chaos = runtime

    def flush(self, intervals=None):
        inner_awaitable = self._inner.flush(intervals)

        async def _flushed():
            fault = await self._chaos.fire("store.flush")
            if fault is not None and fault.kind == "drop":
                return None  # flush "lost": confirms stall until the next one
            return await inner_awaitable

        return _flushed()

    def __getattr__(self, name: str):
        attr = getattr(self._inner, name)
        site = _site_for(name)
        if site is None or not callable(attr):
            return attr

        @wraps(attr)
        async def _injected(*args, **kwargs):
            fault = await self._chaos.fire(site)
            if fault is not None and fault.kind == "drop":
                return None
            return await attr(*args, **kwargs)

        # cache so __getattr__ runs once per method name per instance
        object.__setattr__(self, name, _injected)
        return _injected
