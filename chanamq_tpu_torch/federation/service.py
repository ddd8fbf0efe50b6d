"""FederationService: the per-node federation endpoint.

One service per broker plays both roles: the *receiving* side registers
the ``fed.*`` handlers on its own :class:`RpcServer` (a dedicated
listener — federation method ids share nothing with the intra-cluster
data plane), and the *shipping* side runs one :class:`FederationLink`
per configured remote. The service also owns the hook surface the rest
of the broker calls into (`on_seal`, `on_cursor_commit`,
`on_dead_letter`, `stage_tx_batch`) — each is a cheap dict/match walk,
and none exist at all when ``broker.federation is None``.
"""

from __future__ import annotations

import asyncio
import logging
import time
import zlib
from collections import deque
from typing import TYPE_CHECKING, Optional

from .. import events, trace
from ..amqp.properties import BasicProperties
from ..otel.context import extract as w3c_extract
from ..broker.broker import BrokerError
from ..cluster.dataplane import _Cursor
from ..cluster.rpc import RpcError, RpcServer
from ..streams.segment import (
    Segment, unpack_records, unpack_records_indexed)
from .link import FED_PUBLISH, FED_SHIP, FED_TX, FederationLink

if TYPE_CHECKING:  # pragma: no cover
    from ..broker.broker import Broker

log = logging.getLogger("chanamq.federation")

# bounded transition log: enough for a soak's full decision history
_EVENT_LOG_MAX = 512

# mirror-side {offset: Trace} contexts awaiting their first dispatch —
# bounded per queue so a mirror nobody consumes can't grow without limit
_FED_TRACE_CAP = 1024


class FederationService:
    """Federation endpoint + link manager for one broker."""

    def __init__(
        self, broker: "Broker", *, node_name: str = "",
        interface: str = "127.0.0.1", port: int = 0, window: int = 4,
        retry_s: float = 0.5, idle_s: float = 0.2,
        links: Optional[list[dict]] = None, auth_token: str = "",
    ) -> None:
        self.broker = broker
        self.metrics = broker.metrics
        self.node_name = node_name
        self.window = max(1, window)
        self.retry_s = retry_s
        self.idle_s = idle_s
        #: shared secret every inbound fed.* call must present when set.
        #: The federation listener sits outside the AMQP SASL/ACL path,
        #: so this token is its whole admission control — leave it empty
        #: only on a trusted network. Outbound links default to the same
        #: value (symmetric deployments configure one secret per pair).
        self.auth_token = auth_token
        self.server = RpcServer(interface, port)
        self.server.register("fed.hello", self._h_hello)
        self.server.register("fed.resume", self._h_resume)
        self.server.register("fed.cursor", self._h_cursor)
        self.server.register_binary(FED_SHIP, self._h_ship)
        self.server.register_binary(FED_TX, self._h_tx)
        self.server.register_binary(FED_PUBLISH, self._h_publish)
        self.links: list[FederationLink] = [
            FederationLink(self, spec) for spec in (links or [])]
        #: bounded transition log (link.up/down/resumed + cursor batches).
        #: The event bus is a process-global singleton, so a two-broker
        #: soak can't tell the clusters' emissions apart there — this log
        #: is per-service and is what the determinism gate compares.
        self.events: deque = deque(maxlen=_EVENT_LOG_MAX)
        #: last applied Tx-batch / forwarded-publish sequence per link,
        #: keyed by the shipper's per-boot epoch: a batch the link
        #: re-ships after a drop mid-reply applies once, while a
        #: restarted shipper (sequences reset to 0 under a fresh epoch)
        #: starts a new dedup scope instead of being swallowed by the
        #: previous incarnation's high-water mark. One entry per link —
        #: a new epoch replaces the old one, so the maps stay bounded.
        self._applied_tx: dict[str, tuple[str, int]] = {}
        self._applied_pub: dict[str, tuple[str, int]] = {}

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        await self.server.start()
        self.broker.federation = self
        for link in self.links:
            link.start()

    async def stop(self) -> None:
        if self.broker.federation is self:
            self.broker.federation = None
        for link in self.links:
            await link.stop()
        await self.server.stop()

    @property
    def port(self) -> int:
        return self.server.bound_port

    def record(self, event: str, payload: dict) -> None:
        """Append to the service log and mirror onto the event bus."""
        self.events.append((event, payload))
        bus = events.ACTIVE
        if bus is not None:
            bus.emit("federation." + event, payload)

    def transition_log(self) -> list:
        """Link state transitions only (up/down/resumed): the
        wall-clock-independent slice the soak determinism gate compares —
        per-flush events like cursor batches depend on coalescing timing
        and are excluded by construction."""
        return [(ev, dict(payload)) for ev, payload in self.events
                if ev.startswith("link.")]

    # -- local-side hooks (no-ops unless a link matches) -------------------

    def on_seal(self, queue) -> None:
        """A local stream sealed a segment: wake every link mirroring it."""
        for link in self.links:
            if link.vhost == queue.vhost and queue.name in link.queues:
                link.wake()

    def on_cursor_commit(self, queue, name: str, offset: int) -> None:
        """A local cursor committed: stage the (coalesced) mirror write."""
        for link in self.links:
            if link.vhost == queue.vhost and queue.name in link.queues:
                link.note_cursor(queue.name, name, offset)

    def on_dead_letter(self, vhost: str, exchange: str, routing_key: str,
                       header_raw: bytes, body: bytes) -> None:
        """A local dead-letter publish targeted a federated exchange:
        forward a copy across every link federating it."""
        for link in self.links:
            if link.vhost == vhost and exchange in link.exchanges:
                link.queue_publish(exchange, routing_key, header_raw, body)
                self.metrics.federation_dlx_forwarded += 1

    def stage_tx_batch(self, vhost: str, ops: list) -> None:
        """A local Tx committed with publishes to federated exchanges:
        ship each link its slice as ONE batch (all-or-nothing far side).
        ``ops`` is [(exchange, routing_key, header_raw, body), ...]."""
        for link in self.links:
            if link.vhost != vhost:
                continue
            slice_ = [op for op in ops if op[0] in link.exchanges]
            if slice_:
                link.queue_tx(slice_)

    def link_lags(self) -> dict[str, int]:
        return {link.name: link.total_lag() for link in self.links}

    def stats(self) -> dict:
        return {
            "port": self.port,
            "node": self.node_name,
            "links": [link.info() for link in self.links],
            "events": [
                {"event": ev, **payload} for ev, payload in self.events],
        }

    # -- receiving side ----------------------------------------------------

    def _check_token(self, token) -> None:
        """Admission control for every inbound fed.* call (control and
        data plane): when the service has an ``auth_token``, a caller
        that doesn't present it is refused before any queue is declared
        or any byte is applied."""
        if self.auth_token and str(token or "") != self.auth_token:
            self.metrics.federation_auth_failures += 1
            raise RpcError("auth", "bad federation token")

    @staticmethod
    def _already_applied(table: dict, link: str, epoch: str,
                         seq: int) -> bool:
        entry = table.get(link)
        return (entry is not None and entry[0] == epoch
                and seq <= entry[1])

    async def _mirror_queue(self, vhost: str, name: str):
        """The mirror stream for an inbound ship/resume, declared on first
        contact. Mirrors are receive-only by convention: local publishes
        into one would collide with shipped offsets (documented in the
        README runbook), so the apply path seals any locally-appended
        records before splicing a shipped segment."""
        try:
            queue = self.broker.get_queue(vhost, name)
        except BrokerError:
            queue = await self.broker.declare_queue(
                vhost, name, durable=True,
                arguments={"x-queue-type": "stream"})
        if not getattr(queue, "is_stream", False):
            raise RpcError("bad-type", f"'{name}' is not a stream queue")
        return queue

    async def _h_hello(self, payload: dict) -> dict:
        self._check_token(payload.get("token"))
        link = str(payload.get("link", ""))
        node = str(payload.get("node", ""))
        log.info("federation hello from link=%s node=%s epoch=%s",
                 link, node, str(payload.get("epoch", "")))
        return {"node": self.node_name, "ok": True}

    async def _h_resume(self, payload: dict) -> dict:
        """Resume point for one mirrored queue: the mirror's next expected
        offset (ship from here) plus its committed-cursor map."""
        self._check_token(payload.get("token"))
        queue = await self._mirror_queue(
            str(payload.get("vhost", "/")), str(payload.get("queue", "")))
        return {
            "next": queue.next_offset,
            "committed": dict(queue.committed),
        }

    async def _h_cursor(self, payload: dict) -> dict:
        """Apply a batch of mirrored cursor commits, monotonically (the
        mirror may already be ahead from an earlier flush that raced the
        link drop — ``_commit`` keeps the max)."""
        self._check_token(payload.get("token"))
        vhost = str(payload.get("vhost", "/"))
        qname = str(payload.get("queue", ""))
        cursors = payload.get("cursors") or {}
        queue = await self._mirror_queue(vhost, qname)
        for name, offset in cursors.items():
            queue._commit(str(name), int(offset))
        self.metrics.federation_cursors_mirrored += len(cursors)
        self.record("cursor.mirrored", {
            "vhost": vhost, "queue": qname, "cursors": len(cursors),
            "link": str(payload.get("link", ""))})
        return {"applied": len(cursors)}

    async def _h_ship(self, payload: memoryview):
        """Apply one shipped sealed segment.

        Wire: ss token | ss vhost | ss queue | u64 base | u64 last |
        u64 first_ts | u64 last_ts | u32 crc32 | u32 blob-len | blob.
        Replies the mirror's next expected offset (u64) — also on an
        idempotent duplicate, so a shipper that lost our ack
        mid-link-drop fast-forwards instead of re-sending the whole
        window.

        The claimed range is validated against the decoded payload, not
        just the CRC (which only guards transport corruption): ``last``
        must cover ``base`` and every record offset must fall inside
        ``[base, last]`` in ascending order — otherwise a buggy or
        hostile shipper could splice a range the blob doesn't actually
        cover and permanently corrupt the mirror's offset space. Sparse
        blobs (key-compaction holes, including fully-compacted empties)
        remain legal: holes are allowed, out-of-range records are not."""
        cur = _Cursor(payload)
        self._check_token(cur.ss())
        vhost = cur.ss()
        qname = cur.ss()
        base = cur.u64()
        last = cur.u64()
        first_ts = cur.u64()
        last_ts = cur.u64()
        crc = cur.u32()
        blob = cur.blob()
        if last < base:
            self.metrics.federation_invalid_segments += 1
            raise RpcError("bad-range", f"last {last} < base {base}")
        queue = await self._mirror_queue(vhost, qname)
        if queue._active:
            # locally-appended records on a mirror (operator error): seal
            # them out of the way so the splice below stays contiguous
            queue._seal_active()
        if base < queue.next_offset:
            self.metrics.federation_duplicate_segments += 1
            return [_u64(queue.next_offset)]
        if base > queue.next_offset:
            # str(RpcError) is "code: message" and that string is what the
            # binary error reply carries — the shipper parses "gap: <next>"
            raise RpcError("gap", str(queue.next_offset))
        if zlib.crc32(blob) & 0xFFFFFFFF != crc:
            self.metrics.federation_crc_failures += 1
            raise RpcError("crc", "segment crc mismatch")
        data = bytes(blob)
        prev = base - 1
        rt = trace.ACTIVE
        fed_traces: "dict | None" = None
        t_apply = time.perf_counter_ns() if rt is not None else 0
        for rec in unpack_records(data):
            if rec.offset <= prev or rec.offset > last:
                self.metrics.federation_invalid_segments += 1
                raise RpcError(
                    "bad-range",
                    f"record offset {rec.offset} outside [{base}, {last}]")
            prev = rec.offset
            # cross-cluster parenting: the validation walk is
            # already touching every record, so a cheap substring probe
            # finds the ones whose origin stamped a W3C context into the
            # header; each mints a mirror-side forced trace parented (via
            # the header's traceparent = the origin broker's root span)
            # into the same trace id the producer started
            if rt is not None and b"traceparent" in rec.header_raw:
                tr = self._lift_record_context(rt, rec, vhost, qname)
                if tr is not None:
                    if fed_traces is None:
                        fed_traces = {}
                    fed_traces[rec.offset] = tr
        seg = Segment(base, last, first_ts, last_ts, len(data),
                      unpack_records_indexed(data, base, last))
        queue._segments.append(seg)
        queue._seg_bases.append(base)
        queue.ready_bytes += seg.size_bytes
        queue.next_offset = last + 1
        queue._active_base = queue.next_offset
        if queue.durable and not queue.deleted:
            self.broker.store_bg(self.broker.store.insert_stream_segment(
                vhost, qname, base, last, first_ts, last_ts,
                len(data), data))
        self.metrics.federation_segments_applied += 1
        if fed_traces:
            now = time.perf_counter_ns()
            node = self.node_name or rt.node
            for tr in fed_traces.values():
                tr.span(trace.REMOTE_APPLY, t_apply, now, node)
            existing = queue.fed_traces
            if existing is None:
                existing = queue.fed_traces = {}
            existing.update(fed_traces)
            while len(existing) > _FED_TRACE_CAP:
                existing.pop(next(iter(existing)))
            self.metrics.trace_ctx_recv += len(fed_traces)
        queue._enforce_retention()
        queue._evict_cache(keep=seg)
        queue.schedule_dispatch()
        return [_u64(queue.next_offset)]

    def _lift_record_context(self, rt, rec, vhost: str, qname: str):
        """Mint the mirror-side half of a propagated trace from a shipped
        record's stamped traceparent header. Never raises — a record with
        an undecodable header is simply applied untraced."""
        try:
            _, _, props = BasicProperties.decode_header(rec.header_raw)
        except Exception:
            return None
        ctx = w3c_extract(props.headers)
        if ctx is None:
            return None
        return rt.begin_remote(ctx, node=self.node_name or rt.node, attrs={
            "vhost": vhost, "queue": qname, "exchange": rec.exchange,
            "routing_key": rec.routing_key, "federated": "1"})

    async def _h_tx(self, payload: memoryview):
        """Apply one federated Tx batch all-or-nothing.

        Wire: ss token | ss link | ss epoch | u64 seq | ss vhost |
        u32 count | count * (ss exchange | ss rkey | u32 header-len |
        header | u32 body-len | body). On a WalStore the replay runs
        inside the same ``tx_begin``/``tx_seal`` scope a local Tx.Commit
        uses, so the whole batch lands as one ``tx_batch`` WAL record.
        Replies the applied sequence (u64); an already-applied sequence
        *from the same shipper epoch* acks without re-publishing
        (idempotent retry after a lost reply), while a fresh epoch —
        a restarted shipper whose sequences restart at 1 — opens a new
        dedup scope so its batches are never mistaken for replays of the
        previous incarnation's."""
        cur = _Cursor(payload)
        self._check_token(cur.ss())
        link = cur.ss()
        epoch = cur.ss()
        seq = cur.u64()
        vhost = cur.ss()
        count = cur.u32()
        if self._already_applied(self._applied_tx, link, epoch, seq):
            self.metrics.federation_duplicate_forwards += 1
            return [_u64(seq)]
        ops = []
        for _ in range(count):
            exchange = cur.ss()
            rkey = cur.ss()
            header = bytes(cur.blob())
            body = bytes(cur.blob())
            ops.append((exchange, rkey, header, body))
        store = self.broker.store
        scoped = (self.broker.cluster is None
                  and getattr(store, "tx_begin", None) is not None)
        if scoped:
            store.tx_begin()
        try:
            for exchange, rkey, header, body in ops:
                _, _, props = BasicProperties.decode_header(header)
                await self.broker.publish(
                    vhost, exchange, rkey, props, body, header_raw=header)
        except BaseException:
            if scoped:
                store.tx_abort()
            raise
        if scoped:
            store.tx_seal()
        self._applied_tx[link] = (epoch, seq)
        self.metrics.federation_tx_applied += 1
        return [_u64(seq)]

    async def _h_publish(self, payload: memoryview):
        """Apply one forwarded (DLX) publish.

        Wire: ss token | ss link | ss epoch | u64 seq | ss vhost |
        ss exchange | ss rkey | u32 header-len | header | u32 body-len |
        body. Forwards carry the same per-link (epoch, seq) identity as
        Tx batches, so a retry after a link drop mid-reply acks without
        publishing a duplicate DLX message. A missing exchange drops the
        message, matching local DLX semantics."""
        cur = _Cursor(payload)
        self._check_token(cur.ss())
        link = cur.ss()
        epoch = cur.ss()
        seq = cur.u64()
        vhost = cur.ss()
        exchange = cur.ss()
        rkey = cur.ss()
        header = bytes(cur.blob())
        body = bytes(cur.blob())
        if self._already_applied(self._applied_pub, link, epoch, seq):
            self.metrics.federation_duplicate_forwards += 1
            return None
        _, _, props = BasicProperties.decode_header(header)
        try:
            await self.broker.publish(
                vhost, exchange, rkey, props, body, header_raw=header)
        except BrokerError as exc:
            log.warning("federated publish to '%s' dropped: %s",
                        exchange, exc.text)
        self._applied_pub[link] = (epoch, seq)
        return None


def _u64(value: int) -> bytes:
    return value.to_bytes(8, "big")
