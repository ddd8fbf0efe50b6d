"""Cluster interconnect fast path: the data plane.

The control plane (rpc.py) serializes every payload through the generic
AMQP field-table codec over ONE connection per peer — fine for queue
declares and membership gossip, ruinous for the per-message hot path
(BENCH_r05: the 2-node numbers ran at well under half of single-node
throughput). This module is the data plane the bench trajectory asked for,
in the spirit of RPCAcc's "strip generic serialization out of the RPC hot
path" and the Pulsar paper's broker-to-broker batching (PAPERS.md):

- **Binary zero-copy frames.** Message bodies and property headers travel
  as length-prefixed raw bytes. Encode never joins them into a frame (the
  writer takes a buffer list); decode slices them as memoryviews of the
  read buffer straight into ``Message.body``.
- **Adaptive micro-batching.** Pushes and ack settlements coalesce PER
  PEER across channels and connections inside a flush window
  (``chana.mq.cluster.flush-window-us``), cut short by byte/count caps or
  an explicit barrier demand — under load batches grow to the caps, under
  trickle the window bounds added latency.
- **Parallel streams.** ``chana.mq.cluster.streams`` connections per peer,
  each with its own bounded in-flight window; traffic stripes by queue so
  per-queue FIFO holds while one slow batch no longer head-of-line-blocks
  every other queue's deliveries.

Wire layout (shared head defined in rpc.py, kinds 4/5/6):

  push_many (request, method 1):
    u32 count | record*
    record: ss vhost | u8 nq | ss queue* | ss exchange | ss routing-key |
            u32 props-len | props | u32 body-len | body
  settle_many (request, method 2):
    u32 count | entry*
    entry: ss vhost | ss queue | u8 op (0=ack 1=drop 2=requeue) | ss tag |
           u32 credit | u32 n | u64 offset*
  deliver_many (event, method 3):
    ss vhost | ss queue | ss tag | u32 count | record*
    record: u64 offset | u8 flags (1=redelivered, 2=has-expiry) |
            u64 msg-id | [u64 expire-at-ms] | ss exchange | ss routing-key |
            u32 props-len | props | u32 body-len | body

(`ss` = u8 length-prefixed UTF-8 short string.)

All three payloads may carry an optional trace trailer AFTER the record
area (chanamq_tpu_torch/trace/): decoders iterate exactly ``count`` records and
ignore trailing bytes, so peers without the trailer logic interoperate in
both directions. The trailer is tail-anchored (length + magic in the last
8 bytes) so a receiver lifts trace contexts before the lazy record
decoders run; see trace.encode_trailer/decode_trailer.
"""

from __future__ import annotations

import asyncio
import logging
import struct
import time
from typing import Iterator, Optional

from .. import chaos, profile, trace
from .rpc import (
    KIND_DEVENT,
    KIND_DREQUEST,
    KIND_DRESPONSE,
    FrameTooLarge,
    ReconnectBackoff,
    RpcError,
    RpcTimeout,
    _read_frame,
    as_transport,
    encode_data_frame,
)

log = logging.getLogger("chanamq.dataplane")


def _chaos_data_error(fault) -> RpcError:
    return RpcError(fault.code, fault.message)

METHOD_PUSH_MANY = 1
METHOD_SETTLE_MANY = 2
METHOD_DELIVER_MANY = 3

OP_ACK = 0
OP_DROP = 1
OP_REQUEUE = 2
OPS = ("ack", "drop", "requeue")
OP_IDS = {"ack": OP_ACK, "drop": OP_DROP, "requeue": OP_REQUEUE}

_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

def _put_ss(buf: bytearray, text: str) -> None:
    data = text.encode("utf-8")
    if len(data) > 255:
        raise ValueError(f"short string too long: {len(data)}")
    buf.append(len(data))
    buf += data


class _Cursor:
    """Sequential decoder over one frame payload view. Bulk fields come
    back as sub-views (zero-copy); strings decode from their slice."""

    __slots__ = ("view", "pos")

    def __init__(self, view: memoryview) -> None:
        self.view = view
        self.pos = 0

    def u8(self) -> int:
        value = self.view[self.pos]
        self.pos += 1
        return value

    def u32(self) -> int:
        (value,) = _U32.unpack_from(self.view, self.pos)
        self.pos += 4
        return value

    def u64(self) -> int:
        (value,) = _U64.unpack_from(self.view, self.pos)
        self.pos += 8
        return value

    def ss(self) -> str:
        n = self.u8()
        text = str(self.view[self.pos:self.pos + n], "utf-8")
        self.pos += n
        return text

    def blob(self) -> memoryview:
        n = self.u32()
        view = self.view[self.pos:self.pos + n]
        if len(view) != n:
            raise RpcError("truncated", f"blob wanted {n}, got {len(view)}")
        self.pos += n
        return view


def encode_push_meta_head(
    vhost: str, queues: list[str], exchange: str, routing_key: str,
) -> bytes:
    """The route-constant prefix of one push record (vhost + queue names +
    exchange + routing key). Pure function of the route, so callers that
    publish the same route repeatedly cache it (the broker's cluster route
    cache) and skip the string encoding per message."""
    meta = bytearray()
    _put_ss(meta, vhost)
    meta.append(len(queues))
    for name in queues:
        _put_ss(meta, name)
    _put_ss(meta, exchange)
    _put_ss(meta, routing_key)
    return bytes(meta)


def encode_push_record(
    vhost: str, queues: list[str], exchange: str, routing_key: str,
    props_raw: bytes, body: bytes, head: Optional[bytes] = None,
) -> list:
    """One push as a buffer list [head, len, props, len, body]: the body
    (and props header) ride by reference — the publish frame's own bytes,
    never copied. head, when given, is a cached encode_push_meta_head."""
    if head is None:
        head = encode_push_meta_head(vhost, queues, exchange, routing_key)
    return [head, _U32.pack(len(props_raw)), props_raw,
            _U32.pack(len(body)), body]


def decode_push_many(view: memoryview) -> Iterator[tuple]:
    """Yields (vhost, queues, exchange, routing_key, props_view, body_view)
    with props/body as memoryview slices of the frame buffer."""
    cur = _Cursor(view)
    for _ in range(cur.u32()):
        vhost = cur.ss()
        queues = [cur.ss() for _ in range(cur.u8())]
        exchange = cur.ss()
        routing_key = cur.ss()
        props = cur.blob()
        body = cur.blob()
        yield vhost, queues, exchange, routing_key, props, body


def encode_settle_entry(
    vhost: str, queue: str, op: str, tag: str, credit: int,
    offsets: list[int],
) -> bytes:
    entry = bytearray()
    _put_ss(entry, vhost)
    _put_ss(entry, queue)
    entry.append(OP_IDS[op])
    _put_ss(entry, tag)
    entry += _U32.pack(credit)
    entry += _U32.pack(len(offsets))
    for offset in offsets:
        entry += _U64.pack(offset)
    return bytes(entry)


def decode_settle_many(view: memoryview) -> Iterator[tuple]:
    """Yields (vhost, queue, op, tag, credit, offsets)."""
    cur = _Cursor(view)
    for _ in range(cur.u32()):
        vhost = cur.ss()
        queue = cur.ss()
        op = OPS[cur.u8()]
        tag = cur.ss()
        credit = cur.u32()
        offsets = [cur.u64() for _ in range(cur.u32())]
        yield vhost, queue, op, tag, credit, offsets


def encode_deliver_head(vhost: str, queue: str, tag: str, count: int) -> bytes:
    head = bytearray()
    _put_ss(head, vhost)
    _put_ss(head, queue)
    _put_ss(head, tag)
    head += _U32.pack(count)
    return bytes(head)


# (exchange, routing_key) -> encoded short-string pair: deliveries off one
# queue repeat the same few routes, so the per-record string encode memoizes
_EXRK_MEMO: dict[tuple[str, str], bytes] = {}
_EXRK_MEMO_MAX = 1024


def encode_deliver_record(
    offset: int, redelivered: bool, msg_id: int, expire_at_ms: Optional[int],
    exchange: str, routing_key: str, props_raw: bytes, body: bytes,
) -> list:
    key = (exchange, routing_key)
    exrk = _EXRK_MEMO.get(key)
    if exrk is None:
        buf = bytearray()
        _put_ss(buf, exchange)
        _put_ss(buf, routing_key)
        exrk = bytes(buf)
        if len(_EXRK_MEMO) >= _EXRK_MEMO_MAX:
            _EXRK_MEMO.clear()
        _EXRK_MEMO[key] = exrk
    meta = bytearray(_U64.pack(offset))
    meta.append((1 if redelivered else 0) | (2 if expire_at_ms is not None else 0))
    meta += _U64.pack(msg_id)
    if expire_at_ms is not None:
        meta += _U64.pack(int(expire_at_ms))
    meta += exrk
    meta += _U32.pack(len(props_raw))
    meta += props_raw
    meta += _U32.pack(len(body))
    return [bytes(meta), body]


def decode_deliver_many(view: memoryview) -> tuple:
    """Returns (vhost, queue, tag, records-iterator); records yield
    (offset, redelivered, msg_id, expire_at_ms, exchange, routing_key,
    props_view, body_view)."""
    cur = _Cursor(view)
    vhost = cur.ss()
    queue = cur.ss()
    tag = cur.ss()
    count = cur.u32()

    def records() -> Iterator[tuple]:
        for _ in range(count):
            offset = cur.u64()
            flags = cur.u8()
            msg_id = cur.u64()
            expire_at_ms = cur.u64() if flags & 2 else None
            exchange = cur.ss()
            routing_key = cur.ss()
            props = cur.blob()
            body = cur.blob()
            yield (offset, bool(flags & 1), msg_id, expire_at_ms,
                   exchange, routing_key, props, body)

    return vhost, queue, tag, records()


def _all_of(futures: list) -> asyncio.Future:
    """A future that completes once every one of ``futures`` has: with the
    first failure among them, else True. Unlike ``asyncio.gather``,
    cancelling it leaves ``futures`` alone: they are batch futures that
    other pushes share."""
    out = asyncio.get_event_loop().create_future()
    left = [len(futures)]

    def done(fut: asyncio.Future) -> None:
        left[0] -= 1
        exc = (asyncio.CancelledError() if fut.cancelled()
               else fut.exception())
        if out.done():
            return
        if exc is not None:
            out.set_exception(exc)
        elif left[0] == 0:
            out.set_result(True)

    for fut in futures:
        fut.add_done_callback(done)
    return out


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

class DataStream:
    """One data-plane connection to a peer with its own in-flight window.

    Requests pipeline up to ``inflight`` outstanding before the next send
    awaits a slot — a full window applies backpressure to that stream only;
    sibling streams (other queues) keep moving."""

    def __init__(
        self, host, port: int = 0, *, inflight: int = 32,
        timeout_s: float = 20.0, connect_timeout_s: float = 3.0,
        metrics=None,
    ) -> None:
        # host may be a Transport (UDS shard fast path) or a plain host
        # string with a port (the historical TCP signature)
        self.transport = as_transport(host, port)
        self.host = getattr(self.transport, "host", self.transport.label)
        self.port = getattr(self.transport, "port", 0)
        self.timeout_s = timeout_s
        self.connect_timeout_s = connect_timeout_s
        self.metrics = metrics
        self._writer: Optional[asyncio.StreamWriter] = None
        self._reader_task: Optional[asyncio.Task] = None
        self._waiters: dict[int, asyncio.Future] = {}
        self._next_corr = 1
        self._connect_lock = asyncio.Lock()
        self._backoff = ReconnectBackoff()
        self._window = asyncio.Semaphore(max(1, inflight))
        self.inflight = 0
        # send order: a request takes a ticket on entry and writes on its
        # turn, so frames leave in the order requests were made. Without
        # it a request made just after a (re)connect finds the writer set
        # and writes before earlier ones still queued on the connect lock:
        # one publisher's pushes then reach a queue out of order
        self._tickets = 0
        self._turn = 0
        self._turns_done: set[int] = set()
        self._turn_waiters: dict[int, asyncio.Future] = {}
        self.last_error: Optional[str] = None
        self.closed = False

    def backoff_state(self) -> dict:
        state = self._backoff.state()
        state["last_error"] = self.last_error
        return state

    async def _ensure_connected(self) -> asyncio.StreamWriter:
        if self._writer is not None and not self._writer.is_closing():
            return self._writer
        self._backoff.check()
        async with self._connect_lock:
            if self._writer is not None and not self._writer.is_closing():
                return self._writer
            await self._fence_old_connection()
            self._backoff.check()
            try:
                if chaos.ACTIVE is not None:
                    fault = await chaos.ACTIVE.fire(
                        "data.connect", peer=self.transport.peer,
                        on_error=_chaos_data_error)
                    if fault is not None:
                        raise RpcError(fault.code, fault.message)
                reader, writer = await asyncio.wait_for(
                    self.transport.dial(), self.connect_timeout_s)
            except BaseException as exc:
                self._backoff.failed()
                self.last_error = repr(exc)
                raise
            self._backoff.succeeded()
            self._writer = writer
            self._reader_task = asyncio.get_event_loop().create_task(
                self._read_loop(reader, writer))
            return writer

    async def _fence_old_connection(self) -> None:
        """A redial writes nothing until the dropped connection is done:
        its read loop has ended, so every request written on it has been
        answered or failed back to its caller, and its last frames have
        left (a closing writer flushes before it closes). Without the
        fence a request made just after the drop rode a fresh connection
        ahead of frames still in flight on the old one. A connection that
        does not finish within the request timeout is aborted."""
        old = self._reader_task
        if old is None or old.done():
            return
        done, _ = await asyncio.wait({old}, timeout=self.timeout_s)
        if not done:
            transport = getattr(self._writer, "transport", None)
            if transport is not None:
                transport.abort()
            await asyncio.wait({old})

    async def _read_loop(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            while True:
                corr_id, kind, _method, payload = await _read_frame(reader)
                if chaos.ACTIVE is not None:
                    fault = chaos.ACTIVE.decide(
                        "data.read", peer=self.transport.peer)
                    if fault is not None:
                        if fault.kind == "latency":
                            await asyncio.sleep(fault.delay_s)
                        elif fault.kind == "drop":
                            continue  # response lost in flight
                        elif fault.kind in ("disconnect", "partition"):
                            break
                        else:  # error / corrupt: stream desync
                            raise FrameTooLarge(
                                f"chaos[{fault.rule}]: {fault.message}")
                if self.metrics is not None:
                    self.metrics.rpc_data_bytes_recv += len(payload) + 14
                if kind != KIND_DRESPONSE:
                    continue
                fut = self._waiters.pop(corr_id, None)
                if fut is None or fut.done():
                    continue
                if payload[0] == 0:
                    fut.set_result(payload[1:])
                else:
                    n = payload[1]
                    fut.set_exception(RpcError(
                        "remote", str(payload[2:2 + n], "utf-8", "replace")))
        except (asyncio.IncompleteReadError, ConnectionResetError, OSError) as exc:
            self.last_error = repr(exc)
        except FrameTooLarge as exc:
            log.warning("data stream %s desynced: %s; reconnecting",
                        self.transport.label, exc)
            self.last_error = repr(exc)
        finally:
            self._fail_waiters(
                RpcError("disconnected", self.transport.label))
            if self._writer is writer:
                self._writer = None
            try:
                writer.close()
            except Exception:
                pass

    def _fail_waiters(self, exc: Exception) -> None:
        for fut in self._waiters.values():
            if not fut.done():
                fut.set_exception(exc)
                # a cancelled request() may never await this waiter
                # (teardown): mark the exception retrieved
                fut.exception()
        self._waiters.clear()

    async def _await_turn(self, ticket: int) -> None:
        if self._turn != ticket:
            fut = asyncio.get_event_loop().create_future()
            self._turn_waiters[ticket] = fut
            try:
                await fut
            finally:
                self._turn_waiters.pop(ticket, None)

    def _pass_turn(self, ticket: int) -> None:
        """``ticket`` wrote its frame or gave up: the next ticket may
        write."""
        self._turns_done.add(ticket)
        while self._turn in self._turns_done:
            self._turns_done.discard(self._turn)
            self._turn += 1
        fut = self._turn_waiters.get(self._turn)
        if fut is not None and not fut.done():
            fut.set_result(None)

    async def request(
        self, method_id: int, parts: list,
        timeout_s: Optional[float] = None,
    ) -> memoryview:
        """One pipelined request; blocks only when the in-flight window is
        full. Returns the response payload past the status byte. Frames go
        out in the order the requests were made."""
        ticket = self._tickets
        self._tickets += 1
        try:
            await self._window.acquire()
        except BaseException:
            self._pass_turn(ticket)
            raise
        self.inflight += 1
        try:
            try:
                writer = await self._ensure_connected()
                if chaos.ACTIVE is not None:
                    fault = await chaos.ACTIVE.fire(
                        "data.send", peer=self.transport.peer,
                        on_error=_chaos_data_error)
                    if fault is not None:
                        if fault.kind == "drop":
                            # batch lost in flight: fail now, not after the
                            # full ask window
                            raise RpcTimeout(f"data:{method_id}")
                        writer.close()  # disconnect / corrupt
                        raise RpcError("disconnected",
                                       f"chaos[{fault.rule}]")
                await self._await_turn(ticket)
                corr_id = self._next_corr
                self._next_corr += 1
                fut: asyncio.Future = \
                    asyncio.get_event_loop().create_future()
                self._waiters[corr_id] = fut
                frame = encode_data_frame(corr_id, KIND_DREQUEST, method_id,
                                          parts)
                if self.metrics is not None:
                    self.metrics.rpc_data_bytes_sent += sum(
                        len(p) for p in frame)
                writer.writelines(frame)
            finally:
                self._pass_turn(ticket)
            await writer.drain()
            try:
                result = await asyncio.wait_for(
                    fut, timeout_s or self.timeout_s)
            except asyncio.TimeoutError:
                self._waiters.pop(corr_id, None)
                raise RpcTimeout(f"data:{method_id}") from None
            self._backoff.note_clean()
            return result
        finally:
            self.inflight -= 1
            self._window.release()

    async def send_event(self, method_id: int, parts: list) -> None:
        writer = await self._ensure_connected()
        if chaos.ACTIVE is not None:
            fault = await chaos.ACTIVE.fire(
                "data.event", peer=self.transport.peer,
                on_error=_chaos_data_error)
            if fault is not None:
                return  # fire-and-forget: any transport fault = silent loss
        frame = encode_data_frame(0, KIND_DEVENT, method_id, parts)
        if self.metrics is not None:
            self.metrics.rpc_data_bytes_sent += sum(len(p) for p in frame)
        writer.writelines(frame)
        await writer.drain()

    async def close(self) -> None:
        self.closed = True
        if self._reader_task:
            self._reader_task.cancel()
        if self._writer is not None:
            try:
                self._writer.close()
                await self._writer.wait_closed()
            except Exception:
                pass
            self._writer = None
        self._fail_waiters(RpcError("closed", "stream closed"))


class PeerDataPlane:
    """All data-plane state toward one peer: N streams plus the per-stream
    push/settle accumulators the flush window drains.

    Push submissions return the SHARED future of the batch that will carry
    them — the origin's confirm barrier awaits exactly the batches covering
    its publishes while later batches keep filling (pipelined, per-stream
    windowed). Settles accumulate per (queue, op, tag) and ride the same
    flush; ``drain_settles`` fences them for control-plane ordering."""

    def __init__(
        self, host, port: int = 0, *, streams: int = 2,
        inflight_per_stream: int = 32, flush_window_us: int = 200,
        flush_max_bytes: int = 1 << 20, flush_max_count: int = 512,
        timeout_s: float = 20.0, metrics=None, node_tag: str = "",
    ) -> None:
        self.metrics = metrics
        # local node name for trace span attribution (cluster-push and
        # flush-wait happen on the submitting side)
        self.node_tag = node_tag
        self.transport = as_transport(host, port)
        # intra-node shard hop: peer is a sibling shard over a Unix socket
        self.intra_node = self.transport.kind == "uds"
        self.flush_window_s = max(0.0, flush_window_us / 1e6)
        self.flush_max_bytes = max(1, flush_max_bytes)
        self.flush_max_count = max(1, flush_max_count)
        self.streams = [
            DataStream(self.transport, inflight=inflight_per_stream,
                       timeout_s=timeout_s, metrics=metrics)
            for _ in range(max(1, streams))
        ]
        n = len(self.streams)
        # per-stream push accumulator: [parts, count, bytes, future]
        self._push: list[Optional[list]] = [None] * n
        # per-stream settle accumulator: ({(vhost, queue, op, tag):
        #   [offsets, credit]}, shared future, trace entries)
        self._settle: list[Optional[tuple]] = [None] * n
        self._settle_inflight: set[asyncio.Future] = set()
        self._timer: Optional[asyncio.TimerHandle] = None
        self.closed = False
        # pressure mode (flow ladder stage 3, set by ClusterNode): shrink
        # the effective flush caps so batches toward this peer stay small
        # — less buffered per hop, and the per-stream in-flight windows
        # throttle submitters sooner
        self.pressure = False

    def buffered_bytes(self) -> int:
        """Bytes sitting in the unflushed push accumulators toward this
        peer (the flow accountant's per-peer data-plane share)."""
        total = 0
        for acc in self._push:
            if acc is not None:
                total += acc[2]
        return total

    # -- stream striping ---------------------------------------------------

    def stream_for(self, vhost: str, queue: str, tag: str = "") -> int:
        """Sticky stream assignment: everything that must stay FIFO for one
        (queue, consumer) hashes to the same stream."""
        return hash((vhost, queue, tag)) % len(self.streams)

    # -- pushes ------------------------------------------------------------

    def submit_push(
        self, vhost: str, queues: list[str], exchange: str,
        routing_key: str, props_raw: bytes, body: bytes,
        head: Optional[bytes] = None, tr=None,
    ) -> asyncio.Future:
        """Buffer one push; returns a future that completes when every
        batch carrying it has. The caller's barrier awaits it; caps may
        flush a batch before the window timer does. head: cached
        encode_push_meta_head, if any. tr: sampled trace riding this
        record — parked locally and shipped in the batch's trace trailer,
        keyed by record index.

        A fan-out record is split by stream: each queue's part rides that
        queue's stream (``stream_for``), so a later push to any one of its
        queues cannot overtake it on another stream. The body goes once
        per stream, and each part is a whole push_many record."""
        groups: dict[int, list[str]] = {}
        for name in queues or [""]:
            groups.setdefault(self.stream_for(vhost, name), []).append(name)
        if len(groups) == 1:
            ((idx, _),) = groups.items()
            return self._buffer_push(idx, encode_push_record(
                vhost, queues, exchange, routing_key, props_raw, body,
                head), tr)
        futures = [
            self._buffer_push(idx, encode_push_record(
                vhost, names, exchange, routing_key, props_raw, body),
                tr if n == 0 else None)
            for n, (idx, names) in enumerate(groups.items())]
        return _all_of(futures)

    def _buffer_push(self, idx: int, parts: list, tr) -> asyncio.Future:
        nbytes = sum(len(p) for p in parts)
        acc = self._push[idx]
        if acc is None:
            self._push[idx] = acc = [
                [], 0, 0, asyncio.get_event_loop().create_future(), []]
            self._arm_timer()
        if tr is not None:
            acc[4].append((acc[1], tr))
            tr.pending_ns = time.perf_counter_ns()
            rt = trace.ACTIVE
            if rt is not None:
                rt.park(tr)
            if self.metrics is not None:
                self.metrics.trace_ctx_sent += 1
        acc[0].extend(parts)
        acc[1] += 1
        acc[2] += nbytes
        if self.metrics is not None:
            self.metrics.rpc_push_records += 1
            if self.intra_node:
                self.metrics.shard_cross_pushes += 1
        fut = acc[3]
        max_count, max_bytes = self.flush_max_count, self.flush_max_bytes
        if self.pressure:
            max_count = max(1, max_count // 8)
            max_bytes = max(1, max_bytes // 8)
        if acc[1] >= max_count or acc[2] >= max_bytes:
            if self.metrics is not None:
                if acc[1] >= max_count:
                    self.metrics.rpc_flush_count += 1
                else:
                    self.metrics.rpc_flush_bytes += 1
            self._flush_push(idx)
        return fut

    def _flush_push(self, idx: int) -> None:
        prof = profile.ACTIVE
        t_prof = time.thread_time_ns() if prof is not None else 0
        acc, self._push[idx] = self._push[idx], None
        if acc is None:
            return
        parts, count, _nbytes, fut, traces = acc
        payload = [_U32.pack(count), *parts]
        if traces:
            payload.append(trace.encode_trailer(traces))
        stream = self.streams[idx]
        if self.metrics is not None:
            self.metrics.rpc_push_batches += 1
        if prof is not None:
            # batch-granular: payload assembly cost for the whole push
            # batch (thread-CPU: the window joins the top-level busy sum);
            # ns/calls therefore reads as µs per pushed message
            prof.stage_ns[profile.CLUSTER_PUSH] += (
                time.thread_time_ns() - t_prof)
            prof.stage_calls[profile.CLUSTER_PUSH] += count

        async def _send() -> None:
            t_sent = time.perf_counter_ns() if traces else 0
            try:
                await stream.request(METHOD_PUSH_MANY, payload)
            except BaseException as exc:
                if not fut.done():
                    fut.set_exception(exc)
                return
            if traces:
                # batch-granular attribution: every trace in the batch
                # shares the queue wait (submit->send) and the round trip
                now = time.perf_counter_ns()
                node = self.node_tag
                intra = self.intra_node
                for _i, tr in traces:
                    tr.span(trace.CLUSTER_PUSH, tr.pending_ns, t_sent, node)
                    tr.span(trace.FLUSH_WAIT, t_sent, now, node)
                    if intra:
                        # same wall-clock interval seen as a shard hop:
                        # lets stitched traces separate intra-node cost
                        tr.span(trace.INTRA_SHARD_HOP,
                                tr.pending_ns, now, node)
            if not fut.done():
                fut.set_result(True)

        task = asyncio.get_event_loop().create_task(_send())
        # the batch future is always awaited via submit_push's return; keep
        # the send task from being GC'd mid-flight
        fut._dp_task = task  # type: ignore[attr-defined]

    # -- settles -----------------------------------------------------------

    def submit_settle(
        self, vhost: str, queue: str, op: str, offsets: list[int],
        tag: str, credit: int, tr=None,
    ) -> asyncio.Future:
        idx = self.stream_for(vhost, queue, tag)
        acc = self._settle[idx]
        if acc is None:
            self._settle[idx] = acc = (
                {}, asyncio.get_event_loop().create_future(), [])
            self._arm_timer()
        entries, fut, traces = acc
        if tr is not None:
            # settle entries coalesce, so the trailer keys by entry order
            # at flush time; idx here is a placeholder the flush rewrites
            traces.append((len(traces), tr))
            if self.metrics is not None:
                self.metrics.trace_ctx_sent += 1
        key = (vhost, queue, op, tag)
        entry = entries.get(key)
        if entry is None:
            entries[key] = entry = [[], 0]
        entry[0].extend(offsets)
        entry[1] += credit
        if self.metrics is not None:
            self.metrics.rpc_settle_records += len(offsets)
        return fut

    def _flush_settle(self, idx: int) -> None:
        acc, self._settle[idx] = self._settle[idx], None
        if acc is None:
            return
        entries, fut, traces = acc
        payload = [_U32.pack(len(entries))]
        for (vhost, queue, op, tag), (offsets, credit) in entries.items():
            payload.append(
                encode_settle_entry(vhost, queue, op, tag, credit, offsets))
        if traces:
            payload.append(trace.encode_trailer(traces))
        stream = self.streams[idx]
        if self.metrics is not None:
            self.metrics.rpc_settle_batches += 1
        self._settle_inflight.add(fut)
        fut.add_done_callback(self._settle_inflight.discard)

        async def _send() -> None:
            try:
                await stream.request(METHOD_SETTLE_MANY, payload)
            except BaseException as exc:
                log.warning("settle batch to %s failed: %r",
                            stream.transport.label, exc)
                if not fut.done():
                    # settles are best-effort like the old settle_bg (an
                    # unacked delivery requeues via failure detection), so
                    # the fence future resolves rather than raises
                    fut.set_result(False)
                return
            if not fut.done():
                fut.set_result(True)

        fut._dp_task = asyncio.get_event_loop().create_task(_send())  # type: ignore[attr-defined]

    async def drain_settles(self) -> None:
        """Flush buffered settles and await every in-flight settle batch:
        the control-plane ordering fence (an ack buffered before a cancel /
        delete / purge must be APPLIED on the owner before that RPC runs)."""
        for idx in range(len(self.streams)):
            if self._settle[idx] is not None:
                self._flush_settle(idx)
        if self._settle_inflight:
            await asyncio.gather(
                *list(self._settle_inflight), return_exceptions=True)

    # -- deliveries --------------------------------------------------------

    def send_deliver_many(
        self, vhost: str, queue: str, tag: str, records: list,
        count: int, traces=None,
    ) -> None:
        """Fire one deliver_many event (owner -> origin), striped so one
        consumer's deliveries stay ordered. records is a pre-encoded buffer
        list (see encode_deliver_record). traces: [(record_idx, Trace)]
        shipped as the trailing trace trailer."""
        idx = self.stream_for(vhost, queue, tag)
        payload = [encode_deliver_head(vhost, queue, tag, count), *records]
        if traces:
            payload.append(trace.encode_trailer(traces))
            if self.metrics is not None:
                self.metrics.trace_ctx_sent += len(traces)
        stream = self.streams[idx]
        if self.metrics is not None:
            self.metrics.rpc_deliver_records += count
            self.metrics.rpc_deliver_batches += 1

        async def _send() -> None:
            try:
                await stream.send_event(METHOD_DELIVER_MANY, payload)
            except (RpcError, OSError) as exc:
                # delivery loss is the design contract (unacked copies
                # requeue via failure detection; no_ack is at-most-once)
                log.debug("deliver_many to %s dropped: %r",
                          stream.transport.label, exc)

        asyncio.get_event_loop().create_task(_send())

    # -- flush window ------------------------------------------------------

    def _arm_timer(self) -> None:
        if self._timer is None and not self.closed:
            self._timer = asyncio.get_event_loop().call_later(
                self.flush_window_s, self._on_timer)

    def _on_timer(self) -> None:
        self._timer = None
        if self.metrics is not None and (
                any(a is not None for a in self._push)
                or any(a is not None for a in self._settle)):
            self.metrics.rpc_flush_window += 1
        self.flush_all()

    def flush_all(self, demand: bool = False) -> None:
        """Flush every stream's accumulators now. demand=True marks a
        barrier-initiated flush (confirm barrier, settle fence) in the
        counters."""
        if demand and self.metrics is not None and (
                any(a is not None for a in self._push)
                or any(a is not None for a in self._settle)):
            self.metrics.rpc_flush_demand += 1
        for idx in range(len(self.streams)):
            self._flush_push(idx)
            self._flush_settle(idx)

    # -- introspection / lifecycle ----------------------------------------

    def stats(self) -> dict:
        return {
            "transport": self.transport.kind,
            "streams": len(self.streams),
            "inflight": [s.inflight for s in self.streams],
            "backoff": [s.backoff_state() for s in self.streams],
            "buffered_push_records": sum(
                a[1] for a in self._push if a is not None),
            "buffered_push_bytes": sum(
                a[2] for a in self._push if a is not None),
            "buffered_settle_keys": sum(
                len(a[0]) for a in self._settle if a is not None),
            "settle_batches_inflight": len(self._settle_inflight),
        }

    async def close(self) -> None:
        self.closed = True
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self.flush_all()
        for stream in self.streams:
            await stream.close()
