"""Host-to-host RPC over TCP or Unix-domain sockets.

The DCN control-plane analogue of the reference's Akka artery remoting
(chana-mq-base reference.conf:16-23; messaging pattern SURVEY.md §5:
request/response `ask` with timeout + fire-and-forget `tell`). Wire format
reuses the framework's own AMQP field-table codec for payloads (tables carry
nested tables, byte arrays, ints — everything entity ops need), so the
cluster layer introduces no second serialization scheme and no pickle.

Where a peer lives is abstracted behind a small :class:`Transport` seam:
``TcpTransport`` for inter-node links, ``UdsTransport`` for the intra-node
shard fast path (chanamq_tpu_torch/shard/). Both planes share one codec, flush,
and credit implementation; only the dial differs. Per-peer state keys on
(peer, transport.kind) so a UDS peer never collides with a TCP peer in
counters or backoff bookkeeping.

Frame: u32 body-length | u64 correlation-id | u8 kind | shortstr method |
       table payload
kinds: 0=request 1=response 2=error 3=event (fire-and-forget)

Data-plane frames (cluster/dataplane.py) share the listener but skip the
field-table codec entirely — after the common head comes a u8 method id and
a method-specific binary payload whose bulk fields (message bodies, property
headers) are length-prefixed raw bytes, decoded as memoryview slices of the
read buffer (no copy):

       u32 body-length | u64 correlation-id | u8 kind | u8 method-id | raw
kinds: 4=data-request 5=data-response 6=data-event
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import socket
import struct
from io import BytesIO
from typing import Awaitable, Callable, Optional, Union

from .. import chaos
from ..amqp import value_codec as vc

log = logging.getLogger("chanamq.rpc")

KIND_REQUEST = 0
KIND_RESPONSE = 1
KIND_ERROR = 2
KIND_EVENT = 3
# binary fast-path kinds (cluster/dataplane.py): payload is raw bytes after
# a u8 method id, never a field table
KIND_DREQUEST = 4
KIND_DRESPONSE = 5
KIND_DEVENT = 6

_HEAD = struct.Struct(">IQB")
MAX_FRAME = 64 * 1024 * 1024


def _set_nodelay(writer: asyncio.StreamWriter) -> None:
    """Disable Nagle on a TCP interconnect stream: RPC requests and
    data-plane pushes are small framed writes whose latency must not
    ride on the peer's delayed ACK (UDS transports no-op here)."""
    sock = writer.get_extra_info("socket")
    if sock is not None and hasattr(sock, "setsockopt"):
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass

Handler = Callable[[dict], Awaitable[Optional[dict]]]
# binary handler: memoryview payload -> response payload parts (None = ok)
BinaryHandler = Callable[[memoryview], Awaitable[Optional[list]]]


class RpcError(Exception):
    def __init__(self, code: str, message: str) -> None:
        super().__init__(f"{code}: {message}")
        self.code = code
        self.message = message


class RpcTimeout(RpcError):
    def __init__(self, method: str) -> None:
        super().__init__("timeout", f"rpc {method} timed out")


def _chaos_rpc_error(fault) -> RpcError:
    return RpcError(fault.code, fault.message)


def _encode(corr_id: int, kind: int, method: str, payload: dict) -> bytes:
    body = BytesIO()
    vc.write_shortstr(body, method)
    vc.write_table(body, payload)
    data = body.getvalue()
    return _HEAD.pack(len(data) + 9, corr_id, kind) + data


def encode_data_frame(
    corr_id: int, kind: int, method_id: int, parts: list,
) -> list:
    """Binary frame as a buffer list for writer.writelines: one packed head
    (+ method id) followed by the caller's payload parts verbatim — bodies
    and property blobs are never copied into a joined frame."""
    payload_len = sum(len(p) for p in parts)
    head = bytearray(_HEAD.pack(payload_len + 10, corr_id, kind))
    head.append(method_id)
    return [bytes(head), *parts]


async def _read_frame(
    reader: asyncio.StreamReader,
) -> tuple[int, int, Union[str, int], Union[dict, memoryview]]:
    """One frame off the wire. Table-coded kinds return (corr, kind,
    method-name, payload-dict); data-plane kinds return (corr, kind,
    method-id, payload-memoryview) — the view slices the read buffer, so
    bulk fields inside it are zero-copy all the way to Message.body."""
    head = await reader.readexactly(4)
    (length,) = struct.unpack(">I", head)
    if length > MAX_FRAME:
        # the oversized body is still in the stream: the connection is
        # desynced mid-frame and can only be dropped (callers close the
        # transport and surface a reconnectable error)
        raise FrameTooLarge(f"{length} bytes")
    body = await reader.readexactly(length)
    corr_id, kind = struct.unpack_from(">QB", body)
    if kind >= KIND_DREQUEST:
        view = memoryview(body)
        return corr_id, kind, view[9], view[10:]
    stream = BytesIO(body[9:])
    method = vc.read_shortstr(stream)
    payload = vc.read_table(stream)
    return corr_id, kind, method, payload


class FrameTooLarge(RpcError):
    """A peer announced a frame beyond MAX_FRAME: past this point the byte
    stream cannot be re-synchronized, so the connection must be closed and
    re-established (reconnectable, not a protocol-level reply)."""

    def __init__(self, detail: str) -> None:
        super().__init__("frame_too_large", detail)


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

class Transport:
    """Where a peer lives and how to dial it.

    ``label`` names the endpoint for logs and backoff surfaces; ``peer``
    is the identity the chaos seams match rules against — for a UDS link
    to a sibling shard it carries the peer's CLUSTER name, so a fault rule
    scoped to a node fires regardless of which transport reaches it."""

    __slots__ = ()
    kind: str = "tcp"

    @property
    def label(self) -> str:  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    def peer(self) -> str:
        return self.label

    async def dial(self):  # pragma: no cover - abstract
        raise NotImplementedError


class TcpTransport(Transport):
    __slots__ = ("host", "port")
    kind = "tcp"

    def __init__(self, host: str, port: int) -> None:
        self.host = host
        self.port = int(port)

    @property
    def label(self) -> str:
        return f"{self.host}:{self.port}"

    async def dial(self):
        reader, writer = await asyncio.open_connection(self.host, self.port)
        _set_nodelay(writer)
        return reader, writer

    def __repr__(self) -> str:
        return f"TcpTransport({self.label})"


class UdsTransport(Transport):
    """Unix-domain socket to a process on this machine (a sibling shard):
    same frames, same micro-batching, no TCP stack in the path."""

    __slots__ = ("path", "_peer")
    kind = "uds"

    def __init__(self, path: str, peer: Optional[str] = None) -> None:
        self.path = path
        self._peer = peer

    @property
    def label(self) -> str:
        return f"uds:{self.path}"

    @property
    def peer(self) -> str:
        return self._peer or self.label

    async def dial(self):
        opener = getattr(asyncio, "open_unix_connection", None)
        if opener is None:  # non-unix platform
            raise RpcError("unsupported", "unix sockets unavailable")
        return await opener(self.path)

    def __repr__(self) -> str:
        return f"UdsTransport({self.path})"


def as_transport(host, port: int = 0) -> Transport:
    """Back-compat shim: callers hand either a Transport or (host, port)."""
    return host if isinstance(host, Transport) else TcpTransport(host, port)


class RpcServer:
    """Listens for peer connections; dispatches requests to handlers.

    Besides the TCP endpoint an optional Unix-domain listener (``uds_path``)
    serves the same handlers over the same frames — the intra-node shard
    fast path dials it instead of looping through TCP."""

    def __init__(
        self, host: str, port: int, *, uds_path: Optional[str] = None,
    ) -> None:
        self.host = host
        self.port = port
        self.uds_path = uds_path
        self.handlers: dict[str, Handler] = {}
        self.binary_handlers: dict[int, BinaryHandler] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._uds_server: Optional[asyncio.AbstractServer] = None
        self._peer_writers: set[asyncio.StreamWriter] = set()
        self._stopping = False

    def register(self, method: str, handler: Handler) -> None:
        self.handlers[method] = handler

    def register_binary(self, method_id: int, handler: BinaryHandler) -> None:
        """Data-plane handler: receives the raw payload view; its return
        (a buffer list, or None for a bare ok) rides a KIND_DRESPONSE."""
        self.binary_handlers[method_id] = handler

    async def start(self) -> None:
        self._stopping = False
        self._server = await asyncio.start_server(self._on_client, self.host, self.port)
        if self.uds_path:
            starter = getattr(asyncio, "start_unix_server", None)
            if starter is None:  # non-unix platform: TCP only
                log.warning("unix sockets unavailable; skipping %s",
                            self.uds_path)
                self.uds_path = None
            else:
                # a stale socket file from a crashed predecessor blocks the
                # bind; the supervisor guarantees single ownership per path
                try:
                    os.unlink(self.uds_path)
                except FileNotFoundError:
                    pass
                self._uds_server = await starter(
                    self._on_client, path=self.uds_path)

    @property
    def bound_port(self) -> int:
        assert self._server is not None
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        # a connection accepted before the listener closed may have its
        # handler run only after the writers below were closed: that
        # handler closes at once (below, in _on_client), or wait_closed()
        # would wait for a peer that keeps its connection open, forever
        self._stopping = True
        servers = [s for s in (self._server, self._uds_server) if s is not None]
        self._server = self._uds_server = None
        if servers:
            for server in servers:
                server.close()
            # close accepted connections first: py3.12 wait_closed() blocks
            # until every connection handler finishes
            for writer in list(self._peer_writers):
                try:
                    writer.close()
                except Exception:
                    pass
            for server in servers:
                await server.wait_closed()
        if self.uds_path:
            try:
                os.unlink(self.uds_path)
            except OSError:
                pass

    async def _on_client(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        if self._stopping:
            writer.close()
            return
        _set_nodelay(writer)
        self._peer_writers.add(writer)
        try:
            while True:
                corr_id, kind, method, payload = await _read_frame(reader)
                if kind == KIND_EVENT:
                    handler = self.handlers.get(method)
                    if handler is not None:
                        # events are fire-and-forget; run concurrently
                        asyncio.get_event_loop().create_task(
                            self._run_event(handler, method, payload))
                    continue
                if kind == KIND_DEVENT:
                    bhandler = self.binary_handlers.get(method)
                    if bhandler is not None:
                        asyncio.get_event_loop().create_task(
                            self._run_binary_event(bhandler, method, payload))
                    continue
                if kind == KIND_DREQUEST:
                    asyncio.get_event_loop().create_task(
                        self._run_binary_request(
                            writer, corr_id, method, payload))
                    continue
                if kind != KIND_REQUEST:
                    continue
                asyncio.get_event_loop().create_task(
                    self._run_request(writer, corr_id, method, payload))
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except FrameTooLarge as exc:
            # desynced mid-stream: drop the connection (the peer's client
            # reconnects); replying in-band is impossible past this point
            log.warning("rpc server closing desynced peer connection: %s", exc)
        except Exception:
            log.exception("rpc server connection failed")
        finally:
            self._peer_writers.discard(writer)
            try:
                writer.close()
            except Exception:
                pass

    async def _run_event(self, handler: Handler, method: str, payload: dict) -> None:
        try:
            await handler(payload)
        except Exception:
            log.exception("rpc event handler %s failed", method)

    async def _run_request(
        self, writer: asyncio.StreamWriter, corr_id: int, method: str, payload: dict
    ) -> None:
        handler = self.handlers.get(method)
        try:
            if handler is None:
                raise RpcError("no_such_method", method)
            result = await handler(payload)
            frame = _encode(corr_id, KIND_RESPONSE, method, result or {})
        except RpcError as exc:
            frame = _encode(corr_id, KIND_ERROR, method,
                            {"code": exc.code, "message": exc.message})
        except Exception as exc:
            log.exception("rpc handler %s failed", method)
            frame = _encode(corr_id, KIND_ERROR, method,
                            {"code": "internal", "message": str(exc)})
        try:
            writer.write(frame)
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass

    async def _run_binary_event(
        self, handler: BinaryHandler, method_id: int, payload: memoryview
    ) -> None:
        try:
            await handler(payload)
        except Exception:
            log.exception("rpc binary event handler %d failed", method_id)

    async def _run_binary_request(
        self, writer: asyncio.StreamWriter, corr_id: int, method_id: int,
        payload: memoryview,
    ) -> None:
        """Serve one data-plane request; the reply is a status byte (0=ok)
        plus any handler payload parts, or 1 + shortstr error text."""
        handler = self.binary_handlers.get(method_id)
        try:
            if handler is None:
                raise RpcError("no_such_method", f"binary method {method_id}")
            result = await handler(payload)
            parts = [b"\x00", *(result or [])]
        except Exception as exc:
            if not isinstance(exc, RpcError):
                log.exception("rpc binary handler %d failed", method_id)
            text = str(exc).encode("utf-8", "replace")[:255]
            parts = [b"\x01", bytes((len(text),)), text]
        try:
            writer.writelines(
                encode_data_frame(corr_id, KIND_DRESPONSE, method_id, parts))
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass


class ReconnectBackoff:
    """Backoff shared by the control and data clients: after a failed
    connect, further attempts fail IMMEDIATELY until the deadline so a
    dead peer costs callers one fast exception, not a connect timeout
    each (satellite of the stacked interconnect PR). Success resets it.

    Delay growth is decorrelated jitter — next = uniform(base, prev*3),
    capped at max_s — so N clients dropped by the same peer failure spread
    their reconnects instead of retrying in lockstep. When a seeded chaos
    plan is active the draw comes from the plan's RNG, keeping chaos runs
    reproducible.

    A successful dial only clears the retry deadline; the accumulated
    delay survives until the peer has answered `clean_reset_calls`
    consecutive calls. A flapping peer that accepts connects and then
    drops them used to reset the delay to zero on every dial, turning
    backoff into a tight reconnect loop."""

    __slots__ = ("base_s", "max_s", "failures", "clean_reset_calls",
                 "_delay_s", "_retry_at", "_clean_calls")

    def __init__(
        self, base_s: float = 0.1, max_s: float = 5.0,
        clean_reset_calls: int = 8,
    ) -> None:
        self.base_s = base_s
        self.max_s = max_s
        self.clean_reset_calls = clean_reset_calls
        self.failures = 0  # consecutive failed connects since last success
        self._delay_s = 0.0
        self._retry_at = 0.0
        self._clean_calls = 0  # completed calls since the last failure

    def check(self) -> None:
        if self._delay_s and asyncio.get_event_loop().time() < self._retry_at:
            raise RpcError(
                "backoff", f"reconnect suppressed for {self._delay_s:.1f}s")

    def failed(self) -> None:
        prev = self._delay_s if self._delay_s else self.base_s
        rng = chaos.backoff_rng() or random
        self._delay_s = min(
            self.max_s,
            rng.uniform(self.base_s, max(self.base_s, prev * 3)))
        self.failures += 1
        self._clean_calls = 0
        self._retry_at = asyncio.get_event_loop().time() + self._delay_s

    def succeeded(self) -> None:
        # dial success is not proven health: keep the delay armed so a
        # peer that accepts and immediately drops still backs off
        self._retry_at = 0.0

    def note_clean(self) -> None:
        """A call round-tripped; after enough of them, forgive history."""
        if not self.failures and not self._delay_s:
            return
        self._clean_calls += 1
        if self._clean_calls >= self.clean_reset_calls:
            self._delay_s = 0.0
            self.failures = 0
            self._clean_calls = 0

    def state(self) -> dict:
        """Current backoff posture, surfaced by /admin/cluster."""
        return {
            "delay_s": round(self._delay_s, 4),
            "consecutive_failures": self.failures,
        }


class RpcClient:
    """One outgoing connection to a peer, with correlation-id matching.
    Reconnects lazily on next call after a drop, with exponential backoff
    after a failed connect (a dead peer fails callers fast instead of
    stalling each for the full ask window)."""

    def __init__(
        self, host, port: int = 0, *, timeout_s: float = 20.0,
        connect_timeout_s: float = 3.0,
    ) -> None:
        # host may be a Transport (UDS shard fast path) or a plain host
        # string with a port (the historical TCP signature)
        self.transport = as_transport(host, port)
        self.host = getattr(self.transport, "host", self.transport.label)
        self.port = getattr(self.transport, "port", 0)
        # default ask window (the reference's 20 s internal ask timeout);
        # every call() may override it per request
        self.timeout_s = timeout_s
        self.connect_timeout_s = connect_timeout_s
        self._writer: Optional[asyncio.StreamWriter] = None
        self._reader_task: Optional[asyncio.Task] = None
        self._waiters: dict[int, asyncio.Future] = {}
        self._next_corr = 1
        self._connect_lock = asyncio.Lock()
        self._backoff = ReconnectBackoff()
        self.last_error: Optional[str] = None
        self.closed = False

    def backoff_state(self) -> dict:
        state = self._backoff.state()
        state["last_error"] = self.last_error
        return state

    async def _ensure_connected(self) -> asyncio.StreamWriter:
        if self._writer is not None and not self._writer.is_closing():
            return self._writer
        # outside the lock too: callers queued BEHIND a reconnect attempt
        # fail fast once the holder's attempt has failed, instead of each
        # retrying the dial serially
        self._backoff.check()
        async with self._connect_lock:
            if self._writer is not None and not self._writer.is_closing():
                return self._writer
            self._backoff.check()
            try:
                if chaos.ACTIVE is not None:
                    fault = await chaos.ACTIVE.fire(
                        "rpc.connect", peer=self.transport.peer,
                        on_error=_chaos_rpc_error)
                    if fault is not None:
                        raise RpcError(fault.code, fault.message)
                reader, writer = await asyncio.wait_for(
                    self.transport.dial(), self.connect_timeout_s)
            except BaseException as exc:
                self._backoff.failed()
                self.last_error = repr(exc)
                # requests already queued on the lock see the fresh backoff
                raise
            self._backoff.succeeded()
            self._writer = writer
            self._reader_task = asyncio.get_event_loop().create_task(
                self._read_loop(reader, writer))
            return writer

    async def _read_loop(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            while True:
                corr_id, kind, _method, payload = await _read_frame(reader)
                if chaos.ACTIVE is not None:
                    fault = chaos.ACTIVE.decide(
                        "rpc.read", peer=self.transport.peer)
                    if fault is not None:
                        if fault.kind == "latency":
                            await asyncio.sleep(fault.delay_s)
                        elif fault.kind == "drop":
                            continue  # frame lost in flight
                        elif fault.kind in ("disconnect", "partition"):
                            break  # transport dies; finally reconnects
                        else:  # error / corrupt: stream desync
                            raise FrameTooLarge(
                                f"chaos[{fault.rule}]: {fault.message}")
                fut = self._waiters.pop(corr_id, None)
                if fut is None or fut.done():
                    continue
                if kind == KIND_RESPONSE:
                    fut.set_result(payload)
                elif kind == KIND_ERROR:
                    fut.set_exception(RpcError(
                        str(payload.get("code", "unknown")),
                        str(payload.get("message", ""))))
        except (asyncio.IncompleteReadError, ConnectionResetError, OSError) as exc:
            self.last_error = repr(exc)
        except FrameTooLarge as exc:
            # mid-stream desync: close the transport (finally below) so the
            # next call reconnects cleanly; in-flight waiters fail with a
            # reconnectable error rather than the loop dying unobserved
            log.warning("rpc client %s desynced: %s; reconnecting",
                        self.transport.label, exc)
            self.last_error = repr(exc)
        finally:
            self._fail_waiters(
                RpcError("disconnected", self.transport.label))
            # close OUR writer (dead peer), not whatever reconnect may have
            # installed since; abandoning it would leak the socket until GC
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
                # a cancelled/timed-out call may never await this waiter:
                # mark the exception retrieved so teardown stays silent
                fut.exception()
        self._waiters.clear()

    async def call(
        self, method: str, payload: Optional[dict] = None,
        timeout_s: Optional[float] = None,
    ) -> dict:
        writer = await self._ensure_connected()
        if chaos.ACTIVE is not None:
            fault = await chaos.ACTIVE.fire(
                "rpc.call", peer=self.transport.peer,
                on_error=_chaos_rpc_error)
            if fault is not None:
                if fault.kind == "drop":
                    # request lost in flight: surface the timeout now
                    # instead of making the soak wait out the ask window
                    raise RpcTimeout(method)
                writer.close()  # disconnect / corrupt: kill the transport
                raise RpcError("disconnected", f"chaos[{fault.rule}]")
        corr_id = self._next_corr
        self._next_corr += 1
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._waiters[corr_id] = fut
        writer.write(_encode(corr_id, KIND_REQUEST, method, payload or {}))
        await writer.drain()
        try:
            result = await asyncio.wait_for(fut, timeout_s or self.timeout_s)
        except asyncio.TimeoutError:
            self._waiters.pop(corr_id, None)
            raise RpcTimeout(method) from None
        self._backoff.note_clean()
        return result

    async def send_event(self, method: str, payload: Optional[dict] = None) -> None:
        """Fire-and-forget (the reference's `tell`)."""
        writer = await self._ensure_connected()
        if chaos.ACTIVE is not None:
            fault = await chaos.ACTIVE.fire(
                "rpc.event", peer=self.transport.peer,
                on_error=_chaos_rpc_error)
            if fault is not None:
                return  # fire-and-forget: any transport fault = silent loss
        writer.write(_encode(0, KIND_EVENT, method, payload or {}))
        await writer.drain()
        self._backoff.note_clean()

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
        self._fail_waiters(RpcError("closed", "client closed"))
