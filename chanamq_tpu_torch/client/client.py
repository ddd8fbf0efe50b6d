"""Asyncio AMQP 0-9-1 client.

A full protocol client over the same wire codec the server uses (the codec is
shared; the protocol logic — RPC matching, consumer delivery routing, confirm
tracking — is independent). Mirrors the client capability the reference got
from the RabbitMQ Java client plus its own ClientSettings
(chana-mq-base Settings.scala:200-219).
"""

from __future__ import annotations

import asyncio
import socket as socket_module
import ssl as ssl_module
import struct
from collections import deque
from dataclasses import dataclass
from io import BytesIO
from typing import Any, Awaitable, Callable, Optional, Union

from ..amqp.command import AMQCommand, CommandAssembler
from ..amqp.constants import FRAME_OVERHEAD, FrameType, PROTOCOL_HEADER
from ..amqp.frame import Frame, FrameError, FrameParser, HEARTBEAT_BYTES
from ..amqp import methods as am
from ..amqp.properties import BasicProperties

_FRAME_HDR = struct.Struct(">BHI").pack


_DELIVER_CTAG_CACHE: dict[bytes, str] = {}
_DELIVER_EXRK_CACHE: dict[bytes, tuple[str, str]] = {}
# high-cardinality routing keys (per-message unique, e.g. correlation-id
# routing) would turn the exrk cache into pure per-message overhead: after
# repeated churn-driven clears the cache disables itself for the process
_EXRK_CACHE_STRIKES = 4
_exrk_strikes = 0


def _parse_deliver_fields(payload: bytes) -> tuple[str, int, bool, str, str]:
    """Hand-parse a basic.deliver method payload (past the 4 id bytes).

    A consumer's tag and a flow's exchange/routing-key repeat on every
    delivery, so their str decodes are cached keyed by the raw byte slices
    (prefix: ids + consumer-tag; suffix: exchange + routing-key) — a steady
    stream pays two dict hits instead of three utf-8 decodes per message."""
    global _exrk_strikes
    n = payload[4]
    split = 5 + n
    prefix = payload[:split]
    ctag = _DELIVER_CTAG_CACHE.get(prefix)
    if ctag is None:
        if len(_DELIVER_CTAG_CACHE) >= 1024:
            _DELIVER_CTAG_CACHE.clear()
        ctag = _DELIVER_CTAG_CACHE[prefix] = payload[5:split].decode("utf-8")
    delivery_tag = int.from_bytes(payload[split:split + 8], "big")
    redelivered = bool(payload[split + 8] & 1)
    exrk = None
    if _exrk_strikes < _EXRK_CACHE_STRIKES:
        suffix = payload[split + 9:]
        exrk = _DELIVER_EXRK_CACHE.get(suffix)
    if exrk is None:
        pos = split + 9
        n2 = payload[pos]
        exchange = payload[pos + 1:pos + 1 + n2].decode("utf-8")
        pos += 1 + n2
        n2 = payload[pos]
        routing_key = payload[pos + 1:pos + 1 + n2].decode("utf-8")
        exrk = (exchange, routing_key)
        if _exrk_strikes < _EXRK_CACHE_STRIKES:
            if len(_DELIVER_EXRK_CACHE) >= 1024:
                _DELIVER_EXRK_CACHE.clear()
                _exrk_strikes += 1
            _DELIVER_EXRK_CACHE[suffix] = exrk
    return ctag, delivery_tag, redelivered, exrk[0], exrk[1]


class AMQPClientError(Exception):
    pass


class ChannelClosedError(AMQPClientError):
    def __init__(self, reply_code: int, reply_text: str) -> None:
        super().__init__(f"channel closed: {reply_code} {reply_text}")
        self.reply_code = reply_code
        self.reply_text = reply_text


class ConnectionClosedError(AMQPClientError):
    def __init__(self, reply_code: int = 0, reply_text: str = "") -> None:
        super().__init__(f"connection closed: {reply_code} {reply_text}")
        self.reply_code = reply_code
        self.reply_text = reply_text


class DeliveredMessage:
    """One delivered (or got) message. `properties` decodes lazily from the
    raw content-header payload: the consume hot loop never pays the full
    BasicProperties parse for callbacks that only read the body."""

    __slots__ = ("consumer_tag", "delivery_tag", "redelivered", "exchange",
                 "routing_key", "body", "message_count",
                 "_properties", "_header_raw")

    def __init__(
        self, consumer_tag: str, delivery_tag: int, redelivered: bool,
        exchange: str, routing_key: str, body: bytes,
        properties: Optional[BasicProperties] = None,
        header_raw: Optional[bytes] = None,
        message_count: Optional[int] = None,  # set for basic.get replies
    ) -> None:
        self.consumer_tag = consumer_tag
        self.delivery_tag = delivery_tag
        self.redelivered = redelivered
        self.exchange = exchange
        self.routing_key = routing_key
        self.body = body
        self.message_count = message_count
        self._properties = properties
        self._header_raw = header_raw

    @property
    def properties(self) -> BasicProperties:
        if self._properties is None:
            if self._header_raw is not None:
                _, _, self._properties = BasicProperties.decode_header(
                    self._header_raw)
            else:
                self._properties = BasicProperties()
        return self._properties

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, DeliveredMessage):
            return NotImplemented
        return (
            self.consumer_tag == other.consumer_tag
            and self.delivery_tag == other.delivery_tag
            and self.redelivered == other.redelivered
            and self.exchange == other.exchange
            and self.routing_key == other.routing_key
            and self.properties == other.properties
            and self.body == other.body
            and self.message_count == other.message_count
        )

    def __repr__(self) -> str:
        return (
            f"DeliveredMessage(consumer_tag={self.consumer_tag!r}, "
            f"delivery_tag={self.delivery_tag}, "
            f"redelivered={self.redelivered}, exchange={self.exchange!r}, "
            f"routing_key={self.routing_key!r}, "
            f"properties={self.properties!r}, body={self.body!r}, "
            f"message_count={self.message_count})"
        )


@dataclass(slots=True)
class ReturnedMessage:
    reply_code: int
    reply_text: str
    exchange: str
    routing_key: str
    properties: BasicProperties
    body: bytes


ConsumerCallback = Callable[[DeliveredMessage], Union[None, Awaitable[None]]]


class AMQPClient:
    """One client connection. Use `await AMQPClient.connect(...)`."""

    def __init__(self) -> None:
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        from .. import native_ext

        if native_ext.available():
            self._parser: FrameParser = native_ext.NativeFrameParser()  # type: ignore[assignment]
        else:
            self._parser = FrameParser()
        self._assembler = CommandAssembler()
        # outbound coalescing: sends buffer here and flush once per loop
        # tick (one syscall per batch instead of per method/publish)
        self._wparts: list[bytes] = []
        self._wflush_scheduled = False
        self.channels: dict[int, "ClientChannel"] = {}
        self._next_channel = 1
        self._free_channel_ids: list[int] = []
        self.frame_max = 131072
        self.channel_max = 2047
        self.heartbeat_s = 0
        self.server_properties: dict[str, Any] = {}
        self._reader_task: Optional[asyncio.Task] = None
        self._heartbeat_task: Optional[asyncio.Task] = None
        self._conn_waiters: list[tuple[tuple[type, ...], asyncio.Future]] = []
        self.closed = False
        self._close_exc: Optional[Exception] = None
        # last Connection.Blocked/Unblocked notification from the server
        self.server_blocked = False

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    async def connect(
        cls,
        host: str = "127.0.0.1",
        port: int = 5672,
        *,
        vhost: str = "/",
        username: str = "guest",
        password: str = "guest",
        heartbeat: Optional[int] = None,  # None: accept server's; 0: disable
        ssl: Optional[ssl_module.SSLContext] = None,
        client_properties: Optional[dict] = None,
    ) -> "AMQPClient":
        self = cls()
        self.reader, self.writer = await asyncio.open_connection(host, port, ssl=ssl)
        sock = self.writer.get_extra_info("socket")
        if sock is not None and hasattr(sock, "setsockopt"):
            try:
                # small publish/ack writes must not wait on Nagle
                sock.setsockopt(
                    socket_module.IPPROTO_TCP, socket_module.TCP_NODELAY, 1)
            except OSError:
                pass
        self.writer.write(PROTOCOL_HEADER)
        await self.writer.drain()
        self._reader_task = asyncio.create_task(self._read_loop())

        start = await self._wait_connection_method((am.Connection.Start,))
        self.server_properties = start.server_properties
        mechanisms = bytes(start.mechanisms).split()
        mech = b"PLAIN" if b"PLAIN" in mechanisms else mechanisms[0]
        response = b"\x00" + username.encode() + b"\x00" + password.encode() \
            if mech == b"PLAIN" else b""
        self._send_method(0, am.Connection.StartOk(
            client_properties=client_properties or {
                "product": "chanamq-tpu-client",
                # opt in to Connection.Blocked/Unblocked notifications
                "capabilities": {"connection.blocked": True,
                                 "consumer_cancel_notify": True},
            },
            mechanism=mech.decode(), response=response, locale="en_US",
        ))
        tune = await self._wait_connection_method((am.Connection.Tune,))
        self.channel_max = tune.channel_max or 2047
        self.frame_max = tune.frame_max or 131072
        self._parser.frame_max = self.frame_max
        self.heartbeat_s = tune.heartbeat if heartbeat is None else heartbeat
        self._send_method(0, am.Connection.TuneOk(
            channel_max=self.channel_max, frame_max=self.frame_max,
            heartbeat=self.heartbeat_s,
        ))
        self._send_method(0, am.Connection.Open(virtual_host=vhost))
        await self._wait_connection_method((am.Connection.OpenOk,))
        if self.heartbeat_s:
            self._heartbeat_task = asyncio.create_task(self._heartbeat_loop())
        return self

    async def close(self) -> None:
        if self.closed or self.writer is None:
            return
        try:
            self._send_method(0, am.Connection.Close(reply_code=200, reply_text="bye"))
            await self._wait_connection_method((am.Connection.CloseOk,), timeout=2)
        except Exception:
            pass
        await self._shutdown(None)

    async def _shutdown(self, exc: Optional[Exception]) -> None:
        if self.closed:
            return
        self._flush_writes()  # e.g. a pending CloseOk reply
        self.closed = True
        self._close_exc = exc
        if self._heartbeat_task:
            self._heartbeat_task.cancel()
        for channel in list(self.channels.values()):
            channel._connection_lost(exc)
        self.channels.clear()
        for _, fut in self._conn_waiters:
            if not fut.done():
                if exc:
                    fut.set_exception(exc)
                else:
                    fut.set_exception(ConnectionClosedError())
        self._conn_waiters.clear()
        if self.writer is not None:
            try:
                self.writer.close()
                await self.writer.wait_closed()
            except Exception:
                pass
        if self._reader_task and asyncio.current_task() is not self._reader_task:
            self._reader_task.cancel()

    # -- channels ----------------------------------------------------------

    async def channel(self) -> "ClientChannel":
        if self.closed:
            raise self._close_exc or ConnectionClosedError()
        if self._free_channel_ids:
            cid = self._free_channel_ids.pop()
        else:
            if self._next_channel > self.channel_max:
                raise AMQPClientError(
                    f"out of channel ids (channel_max={self.channel_max})")
            cid = self._next_channel
            self._next_channel += 1
        channel = ClientChannel(self, cid)
        self.channels[cid] = channel
        self._send_method(cid, am.Channel.Open())
        await channel._wait((am.Channel.OpenOk,))
        return channel

    # -- wire I/O ----------------------------------------------------------

    def _write(self, data: bytes) -> None:
        """Buffer outbound bytes; flushed once per event-loop tick."""
        self._wparts.append(data)
        if not self._wflush_scheduled:
            self._wflush_scheduled = True
            asyncio.get_event_loop().call_soon(self._flush_writes)

    def _flush_writes(self) -> None:
        self._wflush_scheduled = False
        if self._wparts and self.writer is not None and not self.closed:
            data = b"".join(self._wparts)
            self._wparts.clear()
            try:
                self.writer.write(data)
            except Exception:
                pass  # reader loop surfaces the connection error

    async def drain(self) -> None:
        """Flush the coalescing buffer and wait for the transport."""
        self._flush_writes()
        if self.writer is not None:
            await self.writer.drain()

    def _send_method(self, channel: int, method: am.Method) -> None:
        self._write(Frame.method(channel, method.encode()).to_bytes())

    def _send_command(self, command: AMQCommand) -> None:
        self._write(command.render(self.frame_max))

    async def _read_loop(self) -> None:
        assert self.reader is not None
        # fast-path state for in-flight basic.deliver content, per channel:
        # [fields_tuple, props, body_size, chunks, received]
        fast_partial: dict[int, list] = {}
        scan = getattr(self._parser, "scan_batches", None)
        try:
            while True:
                data = await self.reader.read(262144)
                if not data:
                    await self._shutdown(ConnectionClosedError(0, "server closed"))
                    return
                if scan is not None:
                    if not await self._consume_scan(scan(data), fast_partial):
                        return
                else:
                    for item in self._parser.feed(data):
                        if isinstance(item, FrameError):
                            await self._shutdown(
                                ConnectionClosedError(int(item.code), item.message))
                            return
                        if not await self._handle_frame(
                                item.type, item.channel, item.payload,
                                fast_partial):
                            return
        except asyncio.CancelledError:
            pass
        except Exception as exc:
            await self._shutdown(exc)

    async def _consume_scan(self, batches, fast_partial: dict) -> bool:
        """Native-parser read loop: walk the scan arrays directly. A
        contained basic.deliver (method+header+body frames in one batch)
        is handled inline with no Frame objects at all; everything else
        (cross-batch content, other methods) drops to _handle_frame."""
        for batch in batches:
            if isinstance(batch, FrameError):
                await self._shutdown(
                    ConnectionClosedError(int(batch.code), batch.message))
                return False
            raw, n, types, channels, offsets, lengths = batch[:6]
            i = 0
            while i < n:
                ftype = types[i]
                if ftype == 8:  # heartbeat
                    i += 1
                    continue
                cid = channels[i]
                off = offsets[i]
                if (ftype == 1 and cid not in fast_partial
                        and raw[off:off + 4] == b"\x00\x3c\x00\x3c"
                        and i + 1 < n and types[i + 1] == 2
                        and channels[i + 1] == cid):
                    hoff = offsets[i + 1]
                    header = raw[hoff:hoff + lengths[i + 1]]
                    if len(header) >= 12:
                        body_size = int.from_bytes(header[4:12], "big")
                        j = i + 2
                        got = 0
                        first = None
                        chunks = None
                        complete = body_size == 0
                        while got < body_size:
                            if j >= n or types[j] != 3 or channels[j] != cid:
                                break  # spans the batch: stateful path
                            boff = offsets[j]
                            blen = lengths[j]
                            got += blen
                            if first is None:
                                first = raw[boff:boff + blen]
                            else:
                                if chunks is None:
                                    chunks = [first]
                                chunks.append(raw[boff:boff + blen])
                            j += 1
                            if got >= body_size:
                                complete = True
                        if complete:
                            if body_size == 0:
                                body = b""
                            else:
                                body = first if chunks is None else b"".join(chunks)
                            fields = _parse_deliver_fields(
                                raw[off:off + lengths[i]])
                            await self._deliver_fast(cid, (fields, header), body)
                            i = max(j, i + 2)
                            continue
                if not await self._handle_frame(
                        ftype, cid, raw[off:off + lengths[i]], fast_partial):
                    return False
                i += 1
        return True

    async def _handle_frame(
        self, ftype: int, cid: int, payload: bytes, fast_partial: dict
    ) -> bool:
        """One frame through the stateful path: the per-channel deliver
        state machine first, then the generic assembler. Returns False when
        the connection has shut down."""
        # -- basic.deliver fast path: per AMQP 0-9-1 §4.2.6 content frames
        # are never interleaved with other frames on the SAME channel, so a
        # tiny inline state machine can own the method->header->body
        # sequence and skip the generic assembler + Method object entirely.
        if ftype == FrameType.METHOD:
            if cid in fast_partial:
                # §4.2.6: content frames are never interleaved with methods
                # on the same channel. Feeding the assembler with fast state
                # still active would silently desynchronize delivery.
                del fast_partial[cid]
                await self._shutdown(ConnectionClosedError(
                    505,
                    "method frame interleaved with in-flight "
                    f"content on channel {cid}"))
                return False
            if payload[:4] == b"\x00\x3c\x00\x3c":
                fast_partial[cid] = [
                    _parse_deliver_fields(payload), None, 0, [], 0]
                return True
        elif cid in fast_partial:
            partial = fast_partial[cid]
            if ftype == FrameType.HEADER:
                # raw header only: properties decode lazily on
                # DeliveredMessage.properties access (hot loop: class 2B +
                # weight 2B, then 8B body size)
                if len(payload) < 12:
                    await self._shutdown(ConnectionClosedError(
                        502, f"truncated content header on channel {cid}"))
                    return False
                body_size = int.from_bytes(payload[4:12], "big")
                partial[1] = payload
                partial[2] = body_size
                if body_size == 0:
                    del fast_partial[cid]
                    await self._deliver_fast(cid, partial, b"")
                return True
            if ftype == FrameType.BODY:
                partial[3].append(payload)
                partial[4] += len(payload)
                if partial[4] >= partial[2]:
                    del fast_partial[cid]
                    chunks = partial[3]
                    body = chunks[0] if len(chunks) == 1 else b"".join(chunks)
                    await self._deliver_fast(cid, partial, body)
                return True
        if ftype == FrameType.HEARTBEAT:
            return True
        out = self._assembler.feed_one(
            Frame(ftype, cid, payload))
        if out is not None:
            if isinstance(out, FrameError):
                await self._shutdown(
                    ConnectionClosedError(int(out.code), out.message))
                return False
            await self._on_command(out)
        return True

    async def _deliver_fast(self, cid: int, partial: list, body: bytes) -> None:
        consumer_tag, delivery_tag, redelivered, exchange, routing_key = partial[0]
        channel = self.channels.get(cid)
        if channel is None:
            return
        msg = DeliveredMessage(
            consumer_tag=consumer_tag, delivery_tag=delivery_tag,
            redelivered=redelivered, exchange=exchange,
            routing_key=routing_key, header_raw=partial[1], body=body,
        )
        callback = channel._consumers.get(consumer_tag)
        if callback is not None:
            result = callback(msg)
            if result is not None and asyncio.iscoroutine(result):
                await result
        else:
            channel._pending_deliveries.setdefault(consumer_tag, []).append(msg)

    async def _on_command(self, command: AMQCommand) -> None:
        method = command.method
        if command.channel == 0:
            if isinstance(method, am.Connection.Close):
                self._send_method(0, am.Connection.CloseOk())
                await self._shutdown(
                    ConnectionClosedError(method.reply_code, method.reply_text))
                return
            if isinstance(method, am.Connection.Blocked):
                self.server_blocked = True
                return
            if isinstance(method, am.Connection.Unblocked):
                self.server_blocked = False
                return
            for i, (types, fut) in enumerate(self._conn_waiters):
                if isinstance(method, types) and not fut.done():
                    self._conn_waiters.pop(i)
                    fut.set_result(method)
                    return
            return
        channel = self.channels.get(command.channel)
        if channel is not None:
            await channel._on_command(command)

    async def _wait_connection_method(
        self, types: tuple[type, ...], timeout: float = 10
    ) -> Any:
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._conn_waiters.append((types, fut))
        return await asyncio.wait_for(fut, timeout)

    async def _heartbeat_loop(self) -> None:
        try:
            while not self.closed:
                await asyncio.sleep(max(self.heartbeat_s / 2, 0.5))
                if self.writer is not None:
                    self.writer.write(HEARTBEAT_BYTES)
        except (asyncio.CancelledError, ConnectionResetError):
            pass


class ClientChannel:
    """One channel on a client connection."""

    def __init__(self, client: AMQPClient, channel_id: int) -> None:
        self.client = client
        self.id = channel_id
        self.closed = False
        self.close_reason: Optional[ChannelClosedError] = None
        self._waiters: list[tuple[tuple[type, ...], asyncio.Future]] = []
        self._consumers: dict[str, ConsumerCallback] = {}
        # deliveries racing the consume-ok -> registration gap are buffered
        self._pending_deliveries: dict[str, list[DeliveredMessage]] = {}
        self.returns: list[ReturnedMessage] = []
        # consumer tags the SERVER cancelled (queue died under them)
        self.cancelled_consumers: list[str] = []
        # server-initiated Channel.Flow state (broker overload throttle):
        # False while the broker asked us to stop publishing; flow_events
        # records every transition in order for tests/diagnostics
        self.flow_active = True
        self.flow_events: list[bool] = []
        # confirm mode
        self.confirm_mode = False
        self._publish_seq = 0
        self._confirm_waiters: dict[int, asyncio.Future] = {}
        # in-flight publish seqs, ascending (append at publish, popleft on
        # the broker's coalesced multiple-acks): confirming a prefix is
        # O(confirmed), not O(window) — a set comprehension re-scanning the
        # full in-flight window per ack was measurable at PerfTest windows
        self.unconfirmed: deque[int] = deque()
        self._confirm_event = asyncio.Event()
        # publish template cache: (exchange, routing_key, mandatory,
        # immediate, id(props)) -> (props_ref, props_snapshot, method_frame,
        # props_payload). The snapshot (a copy taken at encode time) is
        # compared against the live object on every hit, so mutating a
        # reused props object between publishes re-encodes instead of
        # silently sending stale bytes; the ref also pins the id against
        # allocator recycling.
        self._publish_cache: dict[tuple, tuple] = {}

    # -- RPC plumbing ------------------------------------------------------

    async def _wait(self, types: tuple[type, ...], timeout: float = 10) -> Any:
        if self.closed:
            raise self.close_reason or ChannelClosedError(0, "closed")
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._waiters.append((types, fut))
        return await asyncio.wait_for(fut, timeout)

    def _send(self, method: am.Method) -> None:
        if self.closed:
            raise self.close_reason or ChannelClosedError(0, "closed")
        self.client._send_method(self.id, method)

    async def _rpc(self, method: am.Method, reply_types: tuple[type, ...]) -> Any:
        self._send(method)
        return await self._wait(reply_types)

    async def _on_command(self, command: AMQCommand) -> None:
        method = command.method
        if isinstance(method, am.Basic.Deliver):
            msg = DeliveredMessage(
                consumer_tag=method.consumer_tag,
                delivery_tag=method.delivery_tag,
                redelivered=method.redelivered,
                exchange=method.exchange,
                routing_key=method.routing_key,
                properties=command.properties or BasicProperties(),
                body=command.body,
            )
            callback = self._consumers.get(method.consumer_tag)
            if callback is not None:
                result = callback(msg)
                if asyncio.iscoroutine(result):
                    await result
            else:
                self._pending_deliveries.setdefault(
                    method.consumer_tag, []).append(msg)
            return
        if isinstance(method, am.Basic.Cancel):
            # server-sent cancel: the queue died under this consumer
            # (consumer_cancel_notify capability)
            self._consumers.pop(method.consumer_tag, None)
            self.cancelled_consumers.append(method.consumer_tag)
            if not method.nowait:
                self.client._send_method(self.id, am.Basic.CancelOk(
                    consumer_tag=method.consumer_tag))
            return
        if isinstance(method, am.Basic.Return):
            self.returns.append(ReturnedMessage(
                reply_code=method.reply_code, reply_text=method.reply_text,
                exchange=method.exchange, routing_key=method.routing_key,
                properties=command.properties or BasicProperties(),
                body=command.body,
            ))
            return
        if isinstance(method, am.Basic.Ack) and self.confirm_mode:
            self._on_confirm(method.delivery_tag, method.multiple, nack=False)
            return
        if isinstance(method, am.Basic.Nack) and self.confirm_mode:
            self._on_confirm(method.delivery_tag, method.multiple, nack=True)
            return
        if isinstance(method, am.Channel.Close):
            self.client._send_method(self.id, am.Channel.CloseOk())
            self._closed_by_server(
                ChannelClosedError(method.reply_code, method.reply_text))
            return
        if isinstance(method, am.Channel.Flow):
            self.flow_active = method.active
            self.flow_events.append(method.active)
            self.client._send_method(self.id, am.Channel.FlowOk(active=method.active))
            return
        if isinstance(method, (am.Basic.GetOk, am.Basic.GetEmpty)):
            for i, (types, fut) in enumerate(self._waiters):
                if isinstance(method, types) and not fut.done():
                    self._waiters.pop(i)
                    if isinstance(method, am.Basic.GetOk):
                        fut.set_result(DeliveredMessage(
                            consumer_tag="",
                            delivery_tag=method.delivery_tag,
                            redelivered=method.redelivered,
                            exchange=method.exchange,
                            routing_key=method.routing_key,
                            properties=command.properties or BasicProperties(),
                            body=command.body,
                            message_count=method.message_count,
                        ))
                    else:
                        fut.set_result(None)
                    return
            return
        for i, (types, fut) in enumerate(self._waiters):
            if isinstance(method, types) and not fut.done():
                self._waiters.pop(i)
                fut.set_result(method)
                return

    def _closed_by_server(self, exc: ChannelClosedError) -> None:
        self.closed = True
        self.close_reason = exc
        self._confirm_event.set()  # wake wait_unconfirmed_below immediately
        if self.client.channels.pop(self.id, None) is not None:
            self.client._free_channel_ids.append(self.id)
        for _, fut in self._waiters:
            if not fut.done():
                fut.set_exception(exc)
        self._waiters.clear()
        for fut in self._confirm_waiters.values():
            if not fut.done():
                fut.set_exception(exc)
        self._confirm_waiters.clear()

    def _connection_lost(self, exc: Optional[Exception]) -> None:
        self._closed_by_server(
            exc if isinstance(exc, ChannelClosedError)
            else ChannelClosedError(0, str(exc) if exc else "connection closed"))

    # -- confirm tracking --------------------------------------------------

    def _on_confirm(self, delivery_tag: int, multiple: bool, nack: bool) -> None:
        unconfirmed = self.unconfirmed
        if multiple:
            tags = []
            while unconfirmed and unconfirmed[0] <= delivery_tag:
                tags.append(unconfirmed.popleft())
        else:
            tags = [delivery_tag]
            try:
                unconfirmed.remove(delivery_tag)  # rare: single ack/nack
            except ValueError:
                pass
        for tag in tags:
            fut = self._confirm_waiters.pop(tag, None)
            if fut is not None and not fut.done():
                if nack:
                    fut.set_exception(AMQPClientError(f"publish {tag} nacked"))
                else:
                    fut.set_result(True)
        self._confirm_event.set()

    async def wait_unconfirmed_below(self, n: int, timeout: float = 30) -> None:
        """Block until fewer than n publishes are awaiting confirmation
        (the PerfTest-style in-flight window)."""
        deadline = asyncio.get_event_loop().time() + timeout
        while len(self.unconfirmed) >= n:
            if self.closed:
                raise self.close_reason or ChannelClosedError(0, "closed")
            remaining = deadline - asyncio.get_event_loop().time()
            if remaining <= 0:
                raise asyncio.TimeoutError(
                    f"still {len(self.unconfirmed)} unconfirmed")
            self._confirm_event.clear()
            try:
                await asyncio.wait_for(self._confirm_event.wait(), remaining)
            except asyncio.TimeoutError:
                continue

    # -- channel ops -------------------------------------------------------

    async def close(self) -> None:
        if self.closed:
            return
        try:
            await self._rpc(
                am.Channel.Close(reply_code=200, reply_text="bye"),
                (am.Channel.CloseOk,))
        finally:
            self.closed = True
            if self.client.channels.pop(self.id, None) is not None:
                self.client._free_channel_ids.append(self.id)

    async def flow(self, active: bool) -> bool:
        ok = await self._rpc(am.Channel.Flow(active=active), (am.Channel.FlowOk,))
        return ok.active

    # -- exchange ops ------------------------------------------------------

    async def exchange_declare(
        self, exchange: str, type: str = "direct", *, passive: bool = False,
        durable: bool = False, auto_delete: bool = False, internal: bool = False,
        arguments: Optional[dict] = None,
    ) -> None:
        await self._rpc(am.Exchange.Declare(
            exchange=exchange, type=type, passive=passive, durable=durable,
            auto_delete=auto_delete, internal=internal, arguments=arguments,
        ), (am.Exchange.DeclareOk,))

    async def exchange_bind(
        self, destination: str, source: str, routing_key: str = "",
        arguments: Optional[dict] = None,
    ) -> None:
        await self._rpc(am.Exchange.Bind(
            destination=destination, source=source, routing_key=routing_key,
            arguments=arguments or {}), (am.Exchange.BindOk,))

    async def exchange_unbind(
        self, destination: str, source: str, routing_key: str = "",
        arguments: Optional[dict] = None,
    ) -> None:
        await self._rpc(am.Exchange.Unbind(
            destination=destination, source=source, routing_key=routing_key,
            arguments=arguments or {}), (am.Exchange.UnbindOk,))

    async def exchange_delete(self, exchange: str, *, if_unused: bool = False) -> None:
        await self._rpc(am.Exchange.Delete(exchange=exchange, if_unused=if_unused),
                        (am.Exchange.DeleteOk,))

    # -- queue ops ---------------------------------------------------------

    async def queue_declare(
        self, queue: str = "", *, passive: bool = False, durable: bool = False,
        exclusive: bool = False, auto_delete: bool = False,
        arguments: Optional[dict] = None,
    ) -> am.Method:
        """Returns DeclareOk (fields: queue, message_count, consumer_count)."""
        return await self._rpc(am.Queue.Declare(
            queue=queue, passive=passive, durable=durable, exclusive=exclusive,
            auto_delete=auto_delete, arguments=arguments,
        ), (am.Queue.DeclareOk,))

    async def queue_bind(
        self, queue: str, exchange: str, routing_key: str = "",
        arguments: Optional[dict] = None,
    ) -> None:
        await self._rpc(am.Queue.Bind(
            queue=queue, exchange=exchange, routing_key=routing_key,
            arguments=arguments,
        ), (am.Queue.BindOk,))

    async def queue_unbind(
        self, queue: str, exchange: str, routing_key: str = "",
        arguments: Optional[dict] = None,
    ) -> None:
        await self._rpc(am.Queue.Unbind(
            queue=queue, exchange=exchange, routing_key=routing_key,
            arguments=arguments,
        ), (am.Queue.UnbindOk,))

    async def queue_purge(self, queue: str) -> int:
        ok = await self._rpc(am.Queue.Purge(queue=queue), (am.Queue.PurgeOk,))
        return ok.message_count

    async def queue_delete(
        self, queue: str, *, if_unused: bool = False, if_empty: bool = False
    ) -> int:
        ok = await self._rpc(am.Queue.Delete(
            queue=queue, if_unused=if_unused, if_empty=if_empty,
        ), (am.Queue.DeleteOk,))
        return ok.message_count

    # -- basic ops ---------------------------------------------------------

    async def basic_qos(
        self, *, prefetch_size: int = 0, prefetch_count: int = 0,
        global_: bool = False,
    ) -> None:
        await self._rpc(am.Basic.Qos(
            prefetch_size=prefetch_size, prefetch_count=prefetch_count,
            global_=global_,
        ), (am.Basic.QosOk,))

    def basic_publish(
        self, body: bytes, *, exchange: str = "", routing_key: str = "",
        properties: Optional[BasicProperties] = None,
        mandatory: bool = False, immediate: bool = False,
    ) -> Optional[int]:
        """Fire-and-forget publish. In confirm mode returns the seq number.

        Hot loop: the method frame and encoded properties are cached per
        (exchange, routing-key, flags, properties object) — republishing
        with the same arguments only re-frames the header (body size varies)
        and the body."""
        if type(body) is not bytes:
            # snapshot mutable buffers (bytearray/memoryview) NOW: the body
            # rides the write buffer by reference until the next loop-tick
            # flush, and a caller-side mutation must not reach the wire
            body = bytes(body)
        key = (exchange, routing_key, mandatory, immediate, id(properties))
        entry = self._publish_cache.get(key)
        if entry is not None and properties is not None \
                and entry[1] != properties:
            entry = None  # props object mutated since it was cached
        if entry is None:
            props = properties or BasicProperties()
            method_payload = am.Basic.Publish(
                exchange=exchange, routing_key=routing_key,
                mandatory=mandatory, immediate=immediate).encode()
            method_frame = (
                _FRAME_HDR(1, self.id, len(method_payload))
                + method_payload + b"\xce")
            props_out = BytesIO()
            props.write_properties(props_out)
            if len(self._publish_cache) >= 256:
                self._publish_cache.clear()
            # entry[4]: body-length -> fully-rendered wire prefix (method
            # frame + header frame + body frame header) — a steady stream
            # of same-shaped publishes is a dict hit + 3 buffer appends
            entry = (properties, props.copy(), method_frame,
                     props_out.getvalue(), {})
            self._publish_cache[key] = entry
        if self.closed:
            raise self.close_reason or ChannelClosedError(0, "closed")
        body_len = len(body)
        size_cache = entry[4]
        prefix = size_cache.get(body_len)
        if prefix is None:
            method_frame, props_payload = entry[2], entry[3]
            cid = self.id
            frame_max = self.client.frame_max
            max_payload = (frame_max - FRAME_OVERHEAD) if frame_max else body_len
            header = (
                _FRAME_HDR(2, cid, 12 + len(props_payload))
                + b"\x00\x3c\x00\x00"  # class 60 (basic), weight 0
                + body_len.to_bytes(8, "big")
                + props_payload + b"\xce")
            if body_len == 0 or body_len <= max_payload:
                prefix = method_frame + header
                if body_len:
                    prefix += _FRAME_HDR(3, cid, body_len)
                if len(size_cache) >= 64:
                    size_cache.clear()
                size_cache[body_len] = prefix
            else:
                # oversized body: fragment without caching (size varies by
                # chunk; the cost is dominated by the copies anyway)
                parts = [method_frame, header]
                for off in range(0, body_len, max_payload):
                    chunk = body[off:off + max_payload]
                    parts += (_FRAME_HDR(3, cid, len(chunk)), chunk, b"\xce")
                self.client._write(b"".join(parts))
                if self.confirm_mode:
                    self._publish_seq += 1
                    self.unconfirmed.append(self._publish_seq)
                    return self._publish_seq
                return None
        client = self.client
        wparts = client._wparts
        if body_len:
            wparts += (prefix, body, b"\xce")
        else:
            wparts.append(prefix)
        if not client._wflush_scheduled:
            client._wflush_scheduled = True
            asyncio.get_event_loop().call_soon(client._flush_writes)
        if self.confirm_mode:
            self._publish_seq += 1
            self.unconfirmed.append(self._publish_seq)
            return self._publish_seq
        return None

    async def basic_publish_confirmed(
        self, body: bytes, *, exchange: str = "", routing_key: str = "",
        properties: Optional[BasicProperties] = None,
        mandatory: bool = False, immediate: bool = False, timeout: float = 10,
    ) -> None:
        """Publish and await the broker confirm (requires confirm_select)."""
        seq = self.basic_publish(
            body, exchange=exchange, routing_key=routing_key,
            properties=properties, mandatory=mandatory, immediate=immediate)
        assert seq is not None, "confirm_select first"
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._confirm_waiters[seq] = fut
        await asyncio.wait_for(fut, timeout)

    async def basic_consume(
        self, queue: str, callback: ConsumerCallback, *,
        consumer_tag: str = "", no_ack: bool = False, exclusive: bool = False,
        arguments: Optional[dict] = None,
    ) -> str:
        ok = await self._rpc(am.Basic.Consume(
            queue=queue, consumer_tag=consumer_tag, no_ack=no_ack,
            exclusive=exclusive, arguments=arguments,
        ), (am.Basic.ConsumeOk,))
        self._consumers[ok.consumer_tag] = callback
        for msg in self._pending_deliveries.pop(ok.consumer_tag, []):
            result = callback(msg)
            if asyncio.iscoroutine(result):
                await result
        return ok.consumer_tag

    async def basic_cancel(self, consumer_tag: str) -> None:
        await self._rpc(am.Basic.Cancel(consumer_tag=consumer_tag),
                        (am.Basic.CancelOk,))
        self._consumers.pop(consumer_tag, None)

    async def basic_get(
        self, queue: str, *, no_ack: bool = False
    ) -> Optional[DeliveredMessage]:
        self._send(am.Basic.Get(queue=queue, no_ack=no_ack))
        return await self._wait((am.Basic.GetOk, am.Basic.GetEmpty))

    def basic_ack(self, delivery_tag: int, *, multiple: bool = False) -> None:
        # hand-assembled 21-byte frame (header + class/method + tag + bit +
        # end): acks run once per consumed message in ack mode
        if self.closed:
            raise self.close_reason or ChannelClosedError(0, "closed")
        self.client._write(
            _FRAME_HDR(1, self.id, 13)
            + b"\x00\x3c\x00\x50"
            + delivery_tag.to_bytes(8, "big")
            + (b"\x01" if multiple else b"\x00")
            + b"\xce")

    def basic_nack(
        self, delivery_tag: int, *, multiple: bool = False, requeue: bool = True
    ) -> None:
        self._send(am.Basic.Nack(
            delivery_tag=delivery_tag, multiple=multiple, requeue=requeue))

    def basic_reject(self, delivery_tag: int, *, requeue: bool = True) -> None:
        self._send(am.Basic.Reject(delivery_tag=delivery_tag, requeue=requeue))

    async def basic_recover(self, *, requeue: bool = True) -> None:
        await self._rpc(am.Basic.Recover(requeue=requeue), (am.Basic.RecoverOk,))

    async def confirm_select(self) -> None:
        await self._rpc(am.Confirm.Select(), (am.Confirm.SelectOk,))
        self.confirm_mode = True

    # -- tx ----------------------------------------------------------------

    async def tx_select(self) -> None:
        await self._rpc(am.Tx.Select(), (am.Tx.SelectOk,))

    async def tx_commit(self) -> None:
        await self._rpc(am.Tx.Commit(), (am.Tx.CommitOk,))

    async def tx_rollback(self) -> None:
        await self._rpc(am.Tx.Rollback(), (am.Tx.RollbackOk,))
