"""FederationLink: the shipping side of one named federation link.

One background task per link runs a connect → resume → pump loop:

- **connect**: dial the remote federation listener (chaos seam
  ``fed.connect``), handshake with ``fed.hello``, then ``fed.resume``
  every mirrored queue to learn the mirror's next expected offset — the
  remote is the source of truth, so a reconnect after a severed link
  resumes exactly where the last applied segment left off;
- **pump**: ship every sealed segment the remote hasn't seen (chaos seam
  ``fed.ship``, CRC32 stamped on the wire, blobs read through
  ``store.select_stream_segment`` so tiered-off cold segments rehydrate
  via the tier path), flush coalesced cursor commits, and drain the
  outbox of staged DLX forwards and Tx batches.

Sends pipeline through a :class:`DataStream` whose ``inflight``
semaphore is the per-link in-flight window; per queue, ships stay
sequential (the remote requires contiguous bases) while distinct queues
and outbox entries interleave freely inside the window. Any transport
or remote error marks the link down, backs off, and reconnects — state
staged locally (dirty cursors, outbox) survives the outage and drains
after heal.
"""

from __future__ import annotations

import asyncio
import logging
import uuid
import zlib
from collections import deque
from typing import TYPE_CHECKING, Optional

from .. import chaos
from ..cluster.dataplane import DataStream, _put_ss
from ..cluster.rpc import RpcClient, RpcError

if TYPE_CHECKING:  # pragma: no cover
    from .service import FederationService

log = logging.getLogger("chanamq.federation")

# binary method ids on the federation RpcServer (a dedicated listener:
# these share no namespace with the intra-cluster data plane's ids)
FED_SHIP = 1     # sealed segment ship
FED_TX = 2       # staged Tx publish batch (all-or-nothing far side)
FED_PUBLISH = 3  # single forwarded publish (DLX routing)

# staged-work bound per link: a long outage drops staged forwards
# rather than growing without bound (counted per kind, and documented as
# at-most-once for DLX/Tx forwarding across extended outages). Single
# DLX forwards shed before whole committed Tx batches — see _stage.
_OUTBOX_MAX = 10_000


def _chaos_fed_error(fault) -> RpcError:
    return RpcError(getattr(fault, "code", "chaos") or "chaos",
                    f"chaos[{fault.rule}]: {fault.message}")


class FederationLink:
    """Local half of one named link to a remote cluster."""

    def __init__(self, service: "FederationService", spec: dict) -> None:
        self.service = service
        self.name = str(spec["name"])
        self.host = str(spec["host"])
        self.port = int(spec["port"])
        self.vhost = str(spec.get("vhost", "/"))
        self.queues: list[str] = [str(q) for q in spec.get("queues", [])]
        self.exchanges: set[str] = {
            str(e) for e in spec.get("exchanges", [])}
        self.window = max(1, int(spec.get("window", service.window)))
        self.retry_s = float(spec.get("retry_s", service.retry_s))
        #: shared secret presented on every federation call (control and
        #: data plane); must match the remote listener's ``auth_token``
        self.token = str(spec.get("token", service.auth_token))
        #: per-boot shipper incarnation: the receiver keys its Tx/publish
        #: dedup high-water marks by (link, epoch), so a restarted
        #: shipper whose in-memory sequences reset to 0 starts a fresh
        #: dedup scope instead of having every batch swallowed as a
        #: duplicate of the previous incarnation's sequence space
        self.epoch = uuid.uuid4().hex[:16]
        self.rpc = RpcClient(self.host, self.port, timeout_s=10.0)
        self.data = DataStream(
            self.host, self.port, inflight=self.window, timeout_s=30.0,
            metrics=service.metrics)
        self.state = "down"
        self.remote_node = ""
        self.last_error: Optional[str] = None
        #: mirror's next expected offset per queue (from fed.resume /
        #: ship replies); shipping starts here after every (re)connect
        self.remote_next: dict[str, int] = {}
        #: coalesced cursor commits awaiting mirror flush
        self.dirty_cursors: dict[str, dict[str, int]] = {}
        #: staged DLX forwards and Tx batches, drained in order
        self.outbox: deque = deque()
        self._tx_seq = 0
        self._pub_seq = 0
        self._was_up = False
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._stopped = False

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._task = asyncio.get_event_loop().create_task(self._run())

    async def stop(self) -> None:
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None
        await self.rpc.close()
        await self.data.close()

    def wake(self) -> None:
        self._wake.set()

    # -- staging (called from broker hooks; must not await) ----------------

    def note_cursor(self, queue: str, name: str, offset: int) -> None:
        cursors = self.dirty_cursors.setdefault(queue, {})
        if offset > cursors.get(name, -1):
            cursors[name] = offset
        self._wake.set()

    def queue_publish(self, exchange: str, routing_key: str,
                      header_raw: bytes, body: bytes) -> None:
        self._pub_seq += 1
        self._stage(
            ("publish", self._pub_seq, exchange, routing_key,
             header_raw, body))

    def queue_tx(self, ops: list) -> None:
        self._tx_seq += 1
        self._stage(("tx", self._tx_seq, ops))
        self.service.metrics.federation_tx_batches += 1
        self.service.metrics.federation_tx_publishes += len(ops)

    def _stage(self, item: tuple) -> None:
        if len(self.outbox) >= _OUTBOX_MAX:
            # shed a single DLX forward before a whole committed Tx
            # batch: the oldest publish goes first, a tx entry only when
            # the outbox holds nothing else (counted per kind)
            metrics = self.service.metrics
            for idx, staged in enumerate(self.outbox):
                if staged[0] == "publish":
                    del self.outbox[idx]
                    metrics.federation_outbox_dropped_publish += 1
                    break
            else:
                self.outbox.popleft()
                metrics.federation_outbox_dropped_tx += 1
            metrics.federation_outbox_dropped += 1
        self.outbox.append(item)
        self._wake.set()

    # -- observability -----------------------------------------------------

    def queue_lag(self, qname: str) -> int:
        """Records appended locally but not yet applied on the mirror
        (includes the unsealed active segment: honest lag, not just
        shippable lag)."""
        try:
            queue = self.service.broker.get_queue(self.vhost, qname)
        except Exception:
            return 0
        if not getattr(queue, "is_stream", False):
            return 0
        return max(0, queue.next_offset - self.remote_next.get(qname, 0))

    def total_lag(self) -> int:
        return max((self.queue_lag(q) for q in self.queues), default=0)

    def info(self) -> dict:
        backoff = self.rpc.backoff_state()
        return {
            "name": self.name,
            "host": self.host, "port": self.port, "vhost": self.vhost,
            "state": self.state,
            "remote_node": self.remote_node,
            "window": self.window,
            "queues": {
                q: {"remote_next": self.remote_next.get(q, 0),
                    "lag": self.queue_lag(q)}
                for q in self.queues},
            "lag": self.total_lag(),
            "exchanges": sorted(self.exchanges),
            "cursors_pending": sum(
                len(c) for c in self.dirty_cursors.values()),
            "outbox": len(self.outbox),
            "last_error": self.last_error,
            "backoff": backoff,
        }

    # -- the link loop -----------------------------------------------------

    async def _run(self) -> None:
        while not self._stopped:
            try:
                await self._connect()
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                self._note_down(exc)
                await asyncio.sleep(self.retry_s)
                continue
            try:
                while not self._stopped:
                    await self._pump()
                    try:
                        await asyncio.wait_for(
                            self._wake.wait(), self.service.idle_s)
                    except asyncio.TimeoutError:
                        pass
                    self._wake.clear()
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                self._note_down(exc)
                await asyncio.sleep(self.retry_s)

    async def _connect(self) -> None:
        if chaos.ACTIVE is not None:
            fault = await chaos.ACTIVE.fire(
                "fed.connect", peer=self.name, on_error=_chaos_fed_error)
            if fault is not None:
                raise RpcError(fault.code or "chaos",
                               f"chaos[{fault.rule}]: {fault.message}")
        hello = await self.rpc.call(
            "fed.hello", {"link": self.name, "node": self.service.node_name,
                          "epoch": self.epoch, "token": self.token})
        self.remote_node = str(hello.get("node", ""))
        for qname in self.queues:
            resume = await self.rpc.call("fed.resume", {
                "link": self.name, "vhost": self.vhost, "queue": qname,
                "token": self.token})
            self.remote_next[qname] = int(resume.get("next", 0))
        resumed = self._was_up
        self._was_up = True
        self.state = "up"
        self.last_error = None
        payload = {"link": self.name, "remote": self.remote_node,
                   "queues": {q: self.remote_next.get(q, 0)
                              for q in self.queues}}
        self.service.record("link.up", payload)
        if resumed:
            self.service.metrics.federation_resumes += 1
            self.service.record("link.resumed", payload)

    def _note_down(self, exc: Exception) -> None:
        self.last_error = repr(exc)
        if self.state != "down":
            self.state = "down"
            self.service.metrics.federation_link_failures += 1
            self.service.record("link.down", {
                "link": self.name, "error": type(exc).__name__})

    async def _pump(self) -> None:
        # distinct queues ship concurrently inside the DataStream window;
        # within a queue, ships stay sequential (contiguous bases)
        if len(self.queues) > 1:
            results = await asyncio.gather(
                *(self._ship_queue(q) for q in self.queues),
                return_exceptions=True)
            for res in results:
                if isinstance(res, BaseException):
                    raise res
        elif self.queues:
            await self._ship_queue(self.queues[0])
        await self._flush_cursors()
        await self._flush_outbox()

    async def _ship_queue(self, qname: str) -> None:
        broker = self.service.broker
        try:
            queue = broker.get_queue(self.vhost, qname)
        except Exception:
            return  # not declared locally yet: nothing to ship
        if not getattr(queue, "is_stream", False):
            return
        metrics = self.service.metrics
        while True:
            next_needed = self.remote_next.get(qname, 0)
            seg = None
            for candidate in queue._segments:
                if candidate.last_offset < next_needed:
                    continue
                seg = candidate
                break
            if seg is None:
                return
            if seg.base_offset > next_needed:
                # local retention truncated past the mirror's position:
                # nothing can fill the hole — hold until the remote
                # operator resets the mirror (counted, not silent)
                metrics.federation_ship_errors += 1
                log.warning(
                    "link %s: queue %s local head %d past mirror next %d",
                    self.name, qname, seg.base_offset, next_needed)
                return
            try:
                applied_next = await self._ship_segment(queue, seg)
            except RpcError as exc:
                gap = _parse_gap(exc)
                if gap is None:
                    raise
                # receiver knows better (e.g. a duplicate race after a
                # lost ack): adopt its position and retry from there
                metrics.federation_resyncs += 1
                self.remote_next[qname] = gap
                continue
            self.remote_next[qname] = applied_next
            metrics.federation_segments_shipped += 1

    async def _ship_segment(self, queue, seg) -> int:
        """Ship one sealed segment; returns the mirror's next offset."""
        # deferred: importing streams at module level before the broker
        # package finishes initializing would close an import cycle
        from ..streams.segment import pack_records

        if chaos.ACTIVE is not None:
            fault = await chaos.ACTIVE.fire(
                "fed.ship", peer=self.name, on_error=_chaos_fed_error)
            if fault is not None:
                raise RpcError(fault.code or "chaos",
                               f"chaos[{fault.rule}]: {fault.message}")
        if seg.records is not None:
            blob = pack_records([r for r in seg.records if r is not None])
        else:
            # evicted/cold segment: the store read rehydrates a tiered-off
            # blob through the tier offload path transparently
            blob = await self.service.broker.store.select_stream_segment(
                queue.vhost, queue.name, seg.base_offset)
            if blob is None:
                raise RpcError("missing",
                               f"segment {seg.base_offset} unreadable")
        head = bytearray()
        _put_ss(head, self.token)
        _put_ss(head, queue.vhost)
        _put_ss(head, queue.name)
        head += seg.base_offset.to_bytes(8, "big")
        head += seg.last_offset.to_bytes(8, "big")
        head += seg.first_ts_ms.to_bytes(8, "big")
        head += seg.last_ts_ms.to_bytes(8, "big")
        head += (zlib.crc32(blob) & 0xFFFFFFFF).to_bytes(4, "big")
        head += len(blob).to_bytes(4, "big")
        reply = await self.data.request(FED_SHIP, [bytes(head), blob])
        self.service.metrics.federation_segment_bytes += len(blob)
        return int.from_bytes(bytes(reply[:8]), "big")

    async def _flush_cursors(self) -> None:
        while self.dirty_cursors:
            qname = next(iter(self.dirty_cursors))
            cursors = self.dirty_cursors.pop(qname)
            # counted as the call is written: the receiver applies the
            # commit before it replies, so a count taken after the reply
            # lags a mirror that is already visible
            metrics = self.service.metrics
            metrics.federation_cursors_shipped += len(cursors)
            try:
                await self.rpc.call("fed.cursor", {
                    "link": self.name, "vhost": self.vhost, "queue": qname,
                    "cursors": cursors, "token": self.token})
            except BaseException:
                # not shipped: taken back, and the batch stays dirty;
                # re-merge (a commit may have landed since)
                metrics.federation_cursors_shipped -= len(cursors)
                merged = self.dirty_cursors.setdefault(qname, {})
                for name, offset in cursors.items():
                    if offset > merged.get(name, -1):
                        merged[name] = offset
                raise

    async def _flush_outbox(self) -> None:
        while self.outbox:
            item = self.outbox[0]
            if item[0] == "publish":
                _, seq, exchange, rkey, header, body = item
                buf = bytearray()
                _put_ss(buf, self.token)
                _put_ss(buf, self.name)
                _put_ss(buf, self.epoch)
                buf += seq.to_bytes(8, "big")
                _put_ss(buf, self.vhost)
                _put_ss(buf, exchange)
                _put_ss(buf, rkey)
                buf += len(header).to_bytes(4, "big")
                buf += header
                buf += len(body).to_bytes(4, "big")
                buf += body
                await self.data.request(FED_PUBLISH, [bytes(buf)])
            else:
                _, seq, ops = item
                buf = bytearray()
                _put_ss(buf, self.token)
                _put_ss(buf, self.name)
                _put_ss(buf, self.epoch)
                buf += seq.to_bytes(8, "big")
                _put_ss(buf, self.vhost)
                buf += len(ops).to_bytes(4, "big")
                for exchange, rkey, header, body in ops:
                    _put_ss(buf, exchange)
                    _put_ss(buf, rkey)
                    buf += len(header).to_bytes(4, "big")
                    buf += header
                    buf += len(body).to_bytes(4, "big")
                    buf += body
                await self.data.request(FED_TX, [bytes(buf)])
            self.outbox.popleft()


def _parse_gap(exc: RpcError) -> Optional[int]:
    """The receiver's resync hint: a remote ``RpcError("gap", "<next>")``
    arrives through the binary error reply as message ``"gap: <next>"``."""
    message = getattr(exc, "message", "") or ""
    if message.startswith("gap:"):
        try:
            return int(message[4:])
        except ValueError:
            return None
    return None
