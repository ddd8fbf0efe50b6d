"""Golden-wire conformance: byte-exact AMQP 0-9-1 fixtures replayed against
a live server socket.

INDEPENDENCE GUARANTEE: nothing in this file imports or calls
``chanamq_tpu_torch.amqp``. Every client->server byte below is hand-assembled by
the tiny spec-rule builders in this file (struct.pack over the framing rules
of the AMQP 0-9-1 specification: frame = type octet, channel short, size
long, payload, 0xCE end; method payload = class short + method short + args;
shortstr = len octet + bytes; longstr/table = len long + bytes; bit fields
pack LSB-first into octets; content header = class short, weight short,
body-size longlong, 15-bit property flags, property list). Server responses
are asserted byte-for-byte against expectations assembled the same way —
only genuinely server-generated values (the Connection.Start server
properties table, Tune limits) are parsed structurally instead.

This is the analogue of the reference's de-facto conformance gate: driving
the broker with the official RabbitMQ Java client
(chana-mq-test/src/main/scala/chana/mq/test/SimplePublisher.scala:24-58).
No external AMQP client exists in this environment, so the fixtures below
are the spec-derived stand-in: a symmetric encode/decode bug in the repo's
own codec cannot hide here, because these bytes never touch that codec.

The port's copy of ``tests/test_golden_wire.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU; the assertions
are the reference's.
"""

import asyncio
import struct

import pytest

from chanamq_tpu_torch.broker.broker import Broker
from chanamq_tpu_torch.broker.server import BrokerServer

pytestmark = pytest.mark.asyncio


# ---------------------------------------------------------------------------
# spec-rule builders (this file's own, NOT chanamq_tpu_torch.amqp)
# ---------------------------------------------------------------------------

def shortstr(s: str) -> bytes:
    b = s.encode()
    assert len(b) < 256
    return bytes([len(b)]) + b


def longstr(b: bytes) -> bytes:
    return struct.pack(">I", len(b)) + b


def table(entries: bytes = b"") -> bytes:
    """Field table: long byte-count prefix."""
    return struct.pack(">I", len(entries)) + entries


def table_longstr_entry(key: str, value: bytes) -> bytes:
    return shortstr(key) + b"S" + longstr(value)


def frame(ftype: int, channel: int, payload: bytes) -> bytes:
    return struct.pack(">BHI", ftype, channel, len(payload)) + payload + b"\xce"


def method_frame(channel: int, class_id: int, method_id: int, args: bytes) -> bytes:
    return frame(1, channel, struct.pack(">HH", class_id, method_id) + args)


def content_header_frame(
    channel: int, body_size: int, flags: int, props: bytes
) -> bytes:
    payload = struct.pack(">HHQH", 60, 0, body_size, flags) + props
    return frame(2, channel, payload)


def body_frame(channel: int, body: bytes) -> bytes:
    return frame(3, channel, body)


# ---------------------------------------------------------------------------
# the canonical session's property set: all 14 basic properties
# ---------------------------------------------------------------------------

BODY = b'{"x":1}'
TIMESTAMP = 1700000000

# property presence flags, spec bit positions 15..2 (bit 0 = continuation)
ALL_14_FLAGS = 0xFFFC

ALL_14_PROPS = (
    shortstr("application/json")        # content-type    (bit 15)
    + shortstr("utf-8")                 # content-encoding (bit 14)
    + table(table_longstr_entry("k", b"v"))  # headers     (bit 13)
    + bytes([2])                        # delivery-mode   (bit 12)
    + bytes([5])                        # priority        (bit 11)
    + shortstr("corr-1")                # correlation-id  (bit 10)
    + shortstr("reply.q")               # reply-to        (bit 9)
    + shortstr("60000")                 # expiration      (bit 8)
    + shortstr("msg-1")                 # message-id      (bit 7)
    + struct.pack(">Q", TIMESTAMP)      # timestamp       (bit 6)
    + shortstr("t.ev")                  # type            (bit 5)
    + shortstr("guest")                 # user-id         (bit 4)
    + shortstr("gw")                    # app-id          (bit 3)
    + shortstr("cl")                    # cluster-id      (bit 2)
)


# ---------------------------------------------------------------------------
# socket helpers
# ---------------------------------------------------------------------------

async def read_frame(reader: asyncio.StreamReader) -> tuple[int, int, bytes]:
    """Read one frame with this file's own framing rules; returns
    (type, channel, payload) after asserting the 0xCE end octet."""
    header = await asyncio.wait_for(reader.readexactly(7), 10)
    ftype, channel, size = struct.unpack(">BHI", header)
    rest = await asyncio.wait_for(reader.readexactly(size + 1), 10)
    assert rest[-1] == 0xCE, f"missing frame-end octet, got {rest[-1]:#x}"
    return ftype, channel, rest[:-1]


async def expect_bytes(reader: asyncio.StreamReader, expected: bytes, what: str):
    got = await asyncio.wait_for(reader.readexactly(len(expected)), 10)
    assert got == expected, (
        f"{what}: wire bytes differ\n  expected {expected.hex()}\n  got      {got.hex()}"
    )


async def handshake(reader, writer, *, heartbeat: int = 0,
                    open_channel: bool = True) -> tuple[int, int]:
    """Non-golden handshake setup (the canonical-session test asserts these
    bytes; tests focused elsewhere reuse this): protocol header -> StartOk
    -> Tune -> TuneOk -> Connection.Open -> OpenOk [-> Channel.Open(1)]."""
    writer.write(b"AMQP\x00\x00\x09\x01")
    await read_frame(reader)  # Connection.Start
    writer.write(method_frame(0, 10, 11,
        table() + shortstr("PLAIN") + longstr(b"\x00guest\x00guest")
        + shortstr("en_US")))
    _, _, payload = await read_frame(reader)  # Connection.Tune
    channel_max, frame_max, _ = struct.unpack(">HIH", payload[4:12])
    writer.write(method_frame(0, 10, 31,
        struct.pack(">HIH", channel_max, frame_max, heartbeat)))
    writer.write(method_frame(0, 10, 40,
        shortstr("/") + shortstr("") + b"\x00"))
    await read_frame(reader)  # Connection.OpenOk
    if open_channel:
        writer.write(method_frame(1, 20, 10, shortstr("")))
        await read_frame(reader)  # Channel.OpenOk
    return channel_max, frame_max


# ---------------------------------------------------------------------------
# the test
# ---------------------------------------------------------------------------

async def test_golden_wire_canonical_session():
    srv = BrokerServer(broker=Broker(router_device="cpu"),
                       host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    reader, writer = await asyncio.open_connection("127.0.0.1", srv.bound_port)
    try:
        # -- protocol header ------------------------------------------------
        writer.write(b"AMQP\x00\x00\x09\x01")

        # -- Connection.Start (server-generated content: parse structurally)
        ftype, channel, payload = await read_frame(reader)
        assert (ftype, channel) == (1, 0)
        class_id, method_id = struct.unpack(">HH", payload[:4])
        assert (class_id, method_id) == (10, 10)  # connection.start
        assert payload[4:6] == b"\x00\x09"  # version-major 0, version-minor 9
        # server-properties table: skip by its long length prefix
        (tbl_len,) = struct.unpack(">I", payload[6:10])
        rest = payload[10 + tbl_len:]
        (mech_len,) = struct.unpack(">I", rest[:4])
        mechanisms = rest[4:4 + mech_len]
        assert b"PLAIN" in mechanisms
        (loc_len,) = struct.unpack(">I", rest[4 + mech_len:8 + mech_len])
        locales = rest[8 + mech_len:8 + mech_len + loc_len]
        assert b"en_US" in locales
        assert rest[8 + mech_len + loc_len:] == b""  # args end exactly here

        # -- Connection.StartOk --------------------------------------------
        writer.write(method_frame(0, 10, 11,
            table()                                  # client-properties
            + shortstr("PLAIN")                      # mechanism
            + longstr(b"\x00guest\x00guest")         # response
            + shortstr("en_US")))                    # locale

        # -- Connection.Tune (server limits: structural) --------------------
        ftype, channel, payload = await read_frame(reader)
        assert (ftype, channel) == (1, 0)
        assert payload[:4] == struct.pack(">HH", 10, 30)
        channel_max, frame_max, heartbeat = struct.unpack(">HIH", payload[4:12])
        assert len(payload) == 12
        assert channel_max >= 1 and frame_max >= 4096
        assert heartbeat == 0  # server configured with heartbeat off

        # -- Connection.TuneOk + Connection.Open ---------------------------
        writer.write(method_frame(0, 10, 31,
            struct.pack(">HIH", channel_max, frame_max, 0)))
        writer.write(method_frame(0, 10, 40,
            shortstr("/")        # virtual-host
            + shortstr("")       # reserved-1 (capabilities)
            + b"\x00"))          # reserved-2 bit

        # -- Connection.OpenOk: byte-exact ---------------------------------
        await expect_bytes(reader,
            method_frame(0, 10, 41, shortstr("")), "connection.open-ok")

        # -- Channel.Open(1) -> Channel.OpenOk byte-exact -------------------
        writer.write(method_frame(1, 20, 10, shortstr("")))  # reserved-1
        await expect_bytes(reader,
            method_frame(1, 20, 11, longstr(b"")), "channel.open-ok")

        # -- Exchange.Declare durable direct -> DeclareOk byte-exact --------
        writer.write(method_frame(1, 40, 10,
            struct.pack(">H", 0)     # reserved-1 (ticket)
            + shortstr("gw.ex")
            + shortstr("direct")
            + b"\x02"                # bits: passive=0 durable=1 auto-delete=0
                                     #       internal=0 no-wait=0
            + table()))
        await expect_bytes(reader,
            method_frame(1, 40, 11, b""), "exchange.declare-ok")

        # -- Queue.Declare durable with x-message-ttl -> DeclareOk ----------
        # (the reference smoke test declares with x-message-ttl=60000:
        #  SimplePublisher.scala:36-41). 'I' = long-int field value.
        ttl_entry = shortstr("x-message-ttl") + b"I" + struct.pack(">i", 60000)
        writer.write(method_frame(1, 50, 10,
            struct.pack(">H", 0)
            + shortstr("gw.q")
            + b"\x02"                # bits: passive=0 durable=1 excl=0
                                     #       auto-delete=0 no-wait=0
            + table(ttl_entry)))
        await expect_bytes(reader,
            method_frame(1, 50, 11,
                shortstr("gw.q") + struct.pack(">II", 0, 0)),
            "queue.declare-ok")

        # -- Queue.Bind -> BindOk byte-exact --------------------------------
        writer.write(method_frame(1, 50, 20,
            struct.pack(">H", 0)
            + shortstr("gw.q") + shortstr("gw.ex") + shortstr("quote")
            + b"\x00"                # no-wait=0
            + table()))
        await expect_bytes(reader,
            method_frame(1, 50, 21, b""), "queue.bind-ok")

        # -- Basic.Publish with all 14 properties ---------------------------
        writer.write(
            method_frame(1, 60, 40,
                struct.pack(">H", 0)
                + shortstr("gw.ex") + shortstr("quote")
                + b"\x00")           # mandatory=0 immediate=0
            + content_header_frame(1, len(BODY), ALL_14_FLAGS, ALL_14_PROPS)
            + body_frame(1, BODY))

        # -- Basic.Get -> GetOk + header + body, all byte-exact -------------
        writer.write(method_frame(1, 60, 70,
            struct.pack(">H", 0) + shortstr("gw.q") + b"\x00"))  # no-ack=0
        await expect_bytes(reader,
            method_frame(1, 60, 71,
                struct.pack(">Q", 1)          # delivery-tag 1
                + b"\x00"                     # redelivered=0
                + shortstr("gw.ex") + shortstr("quote")
                + struct.pack(">I", 0)),      # message-count after this get
            "basic.get-ok")
        # the content header must echo every property byte-for-byte
        await expect_bytes(reader,
            content_header_frame(1, len(BODY), ALL_14_FLAGS, ALL_14_PROPS),
            "content header (14 properties)")
        await expect_bytes(reader, body_frame(1, BODY), "body")

        # -- Basic.Ack ------------------------------------------------------
        writer.write(method_frame(1, 60, 80,
            struct.pack(">Q", 1) + b"\x00"))  # delivery-tag 1, multiple=0

        # -- Basic.Get on the now-empty queue -> GetEmpty byte-exact --------
        writer.write(method_frame(1, 60, 70,
            struct.pack(">H", 0) + shortstr("gw.q") + b"\x00"))
        await expect_bytes(reader,
            method_frame(1, 60, 72, shortstr("")),  # reserved cluster-id
            "basic.get-empty")

        # -- push delivery path: publish again, consume, expect Deliver -----
        writer.write(
            method_frame(1, 60, 40,
                struct.pack(">H", 0)
                + shortstr("gw.ex") + shortstr("quote")
                + b"\x00")
            + content_header_frame(1, len(BODY), ALL_14_FLAGS, ALL_14_PROPS)
            + body_frame(1, BODY))
        writer.write(method_frame(1, 60, 20,      # basic.consume
            struct.pack(">H", 0)
            + shortstr("gw.q")
            + shortstr("gold-tag")                # consumer-tag
            + b"\x00"                             # bits: no-local=0 no-ack=0
                                                  #       exclusive=0 no-wait=0
            + table()))
        await expect_bytes(reader,
            method_frame(1, 60, 21, shortstr("gold-tag")), "basic.consume-ok")
        await expect_bytes(reader,
            method_frame(1, 60, 60,               # basic.deliver
                shortstr("gold-tag")
                + struct.pack(">Q", 2)            # delivery-tag 2
                + b"\x00"                         # redelivered=0
                + shortstr("gw.ex") + shortstr("quote")),
            "basic.deliver")
        await expect_bytes(reader,
            content_header_frame(1, len(BODY), ALL_14_FLAGS, ALL_14_PROPS),
            "deliver content header")
        await expect_bytes(reader, body_frame(1, BODY), "deliver body")
        writer.write(method_frame(1, 60, 80,
            struct.pack(">Q", 2) + b"\x00"))      # ack the delivery
        # basic.cancel -> cancel-ok byte-exact
        writer.write(method_frame(1, 60, 30,
            shortstr("gold-tag") + b"\x00"))      # no-wait=0
        await expect_bytes(reader,
            method_frame(1, 60, 31, shortstr("gold-tag")), "basic.cancel-ok")

        # -- Channel.Close -> CloseOk byte-exact ----------------------------
        writer.write(method_frame(1, 20, 40,
            struct.pack(">H", 200) + shortstr("bye")
            + struct.pack(">HH", 0, 0)))
        await expect_bytes(reader,
            method_frame(1, 20, 41, b""), "channel.close-ok")

        # -- Connection.Close -> CloseOk byte-exact -------------------------
        writer.write(method_frame(0, 10, 50,
            struct.pack(">H", 200) + shortstr("bye")
            + struct.pack(">HH", 0, 0)))
        await expect_bytes(reader,
            method_frame(0, 10, 51, b""), "connection.close-ok")
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except Exception:
            pass
        await srv.stop()


async def test_golden_wire_heartbeat_and_bad_header():
    """Two framing edges straight from the spec: (a) a wrong protocol header
    is answered with the server's own header and a hangup; (b) a heartbeat
    frame is type 8, channel 0, empty payload."""
    srv = BrokerServer(broker=Broker(router_device="cpu"),
                       host="127.0.0.1", port=0, heartbeat_s=1)
    await srv.start()
    try:
        # (a) wrong protocol header (exactly 8 bytes: the server reads just
        # the header before closing; unread residue would turn FIN into RST)
        reader, writer = await asyncio.open_connection("127.0.0.1", srv.bound_port)
        writer.write(b"HTTP/1.1")
        got = await asyncio.wait_for(reader.readexactly(8), 10)
        assert got == b"AMQP\x00\x00\x09\x01"
        assert await asyncio.wait_for(reader.read(1), 10) == b""  # closed
        writer.close()

        # (b) negotiate a 1s heartbeat, then sit idle and expect the server's
        # heartbeat frame: exactly 08 0000 00000000 CE
        reader, writer = await asyncio.open_connection("127.0.0.1", srv.bound_port)
        await handshake(reader, writer, heartbeat=1, open_channel=False)
        await expect_bytes(reader, b"\x08\x00\x00\x00\x00\x00\x00\xce",
                           "heartbeat frame")
        writer.close()
    finally:
        await srv.stop()


async def test_golden_wire_confirms_and_mandatory_return():
    """Publisher-confirm and mandatory-return wire shapes: confirm.select ->
    select-ok; a pipelined burst of publishes is confirmed with ONE
    Basic.Ack(multiple=1) carrying the batch's highest seq (the server's
    documented coalescing, mirroring the reference's run-length confirm
    logic, FrameStage.scala:571-596); a mandatory publish to an unroutable
    key comes back as Basic.Return + the untouched header and body."""
    srv = BrokerServer(broker=Broker(router_device="cpu"),
                       host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    reader, writer = await asyncio.open_connection("127.0.0.1", srv.bound_port)
    try:
        await handshake(reader, writer)
        writer.write(method_frame(1, 50, 10,    # queue.declare default-bound
            struct.pack(">H", 0) + shortstr("cf.q") + b"\x00" + table()))
        await read_frame(reader)  # DeclareOk

        # confirm.select -> select-ok byte-exact (class 85, methods 10/11)
        writer.write(method_frame(1, 85, 10, b"\x00"))  # no-wait=0
        await expect_bytes(reader,
            method_frame(1, 85, 11, b""), "confirm.select-ok")

        # three pipelined publishes to the default exchange -> ONE coalesced
        # Basic.Ack with delivery-tag 3, multiple=1
        publish = (
            method_frame(1, 60, 40,
                struct.pack(">H", 0) + shortstr("") + shortstr("cf.q")
                + b"\x00")
            + content_header_frame(1, len(BODY), 0x1000, bytes([1]))
            + body_frame(1, BODY))
        writer.write(publish * 3)
        await expect_bytes(reader,
            method_frame(1, 60, 80, struct.pack(">Q", 3) + b"\x01"),
            "coalesced publisher confirm (tag 3, multiple)")

        # mandatory publish to an unroutable key: Basic.Return 312 NO_ROUTE
        # + the header and body echoed byte-for-byte, then its own confirm
        writer.write(
            method_frame(1, 60, 40,
                struct.pack(">H", 0) + shortstr("") + shortstr("no.such.q")
                + b"\x01")           # mandatory=1
            + content_header_frame(1, len(BODY), ALL_14_FLAGS, ALL_14_PROPS)
            + body_frame(1, BODY))
        await expect_bytes(reader,
            method_frame(1, 60, 50,
                struct.pack(">H", 312) + shortstr("NO_ROUTE")
                + shortstr("") + shortstr("no.such.q")),
            "basic.return")
        await expect_bytes(reader,
            content_header_frame(1, len(BODY), ALL_14_FLAGS, ALL_14_PROPS),
            "returned content header")
        await expect_bytes(reader, body_frame(1, BODY), "returned body")
        await expect_bytes(reader,
            method_frame(1, 60, 80, struct.pack(">Q", 4) + b"\x01"),
            "confirm for the returned publish")
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except Exception:
            pass
        await srv.stop()


async def test_golden_wire_tx_and_exchange_bind():
    """tx and exchange-to-exchange-bind wire shapes, spec-rule bytes only:
    tx.select/commit/rollback-ok frames (class 90), exchange.bind-ok
    (40,31) and the spec-quirk exchange.unbind-ok method id 51 (not 41),
    commit visibility through an e2e hop via byte-exact basic.get-ok /
    get-empty responses."""
    srv = BrokerServer(broker=Broker(router_device="cpu"),
                       host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    reader, writer = await asyncio.open_connection("127.0.0.1", srv.bound_port)
    try:
        await handshake(reader, writer)
        no_bits = b"\x00"
        # exchange.declare src(direct) + dst(fanout); queue gx.q bound to dst
        writer.write(method_frame(1, 40, 10,
            struct.pack(">H", 0) + shortstr("gx.src") + shortstr("direct")
            + no_bits + table()))
        await expect_bytes(reader, method_frame(1, 40, 11, b""),
                           "exchange.declare-ok (src)")
        writer.write(method_frame(1, 40, 10,
            struct.pack(">H", 0) + shortstr("gx.dst") + shortstr("fanout")
            + no_bits + table()))
        await expect_bytes(reader, method_frame(1, 40, 11, b""),
                           "exchange.declare-ok (dst)")
        writer.write(method_frame(1, 50, 10,
            struct.pack(">H", 0) + shortstr("gx.q") + no_bits + table()))
        await read_frame(reader)  # queue.declare-ok (counts vary)
        writer.write(method_frame(1, 50, 20,
            struct.pack(">H", 0) + shortstr("gx.q") + shortstr("gx.dst")
            + shortstr("") + no_bits + table()))
        await expect_bytes(reader, method_frame(1, 50, 21, b""),
                           "queue.bind-ok")

        # exchange.bind dst <- src on key "k" -> bind-ok (40,31) byte-exact
        writer.write(method_frame(1, 40, 30,
            struct.pack(">H", 0) + shortstr("gx.dst") + shortstr("gx.src")
            + shortstr("k") + no_bits + table()))
        await expect_bytes(reader, method_frame(1, 40, 31, b""),
                           "exchange.bind-ok")

        # tx.select -> select-ok (90,10 -> 90,11)
        writer.write(method_frame(1, 90, 10, b""))
        await expect_bytes(reader, method_frame(1, 90, 11, b""),
                           "tx.select-ok")

        # a buffered publish is invisible before commit: get-empty
        publish = (
            method_frame(1, 60, 40,
                struct.pack(">H", 0) + shortstr("gx.src") + shortstr("k")
                + no_bits)
            + content_header_frame(1, len(BODY), 0x1000, bytes([1]))
            + body_frame(1, BODY))
        writer.write(publish)
        get = method_frame(1, 60, 70,
                           struct.pack(">H", 0) + shortstr("gx.q") + b"\x01")
        writer.write(get)
        await expect_bytes(reader,
            method_frame(1, 60, 72, shortstr("")), "get-empty before commit")

        # commit -> commit-ok, then the message is visible through the e2e
        # hop: get-ok with server tag 1, exchange gx.src, key k, 0 remaining
        writer.write(method_frame(1, 90, 20, b""))
        await expect_bytes(reader, method_frame(1, 90, 21, b""),
                           "tx.commit-ok")
        writer.write(get)
        await expect_bytes(reader,
            method_frame(1, 60, 71,
                struct.pack(">Q", 1) + b"\x00" + shortstr("gx.src")
                + shortstr("k") + struct.pack(">I", 0)),
            "get-ok after commit")
        await expect_bytes(reader,
            content_header_frame(1, len(BODY), 0x1000, bytes([1])),
            "got content header")
        await expect_bytes(reader, body_frame(1, BODY), "got body")

        # rollback discards: publish, rollback -> rollback-ok, get-empty
        writer.write(publish)
        writer.write(method_frame(1, 90, 30, b""))
        await expect_bytes(reader, method_frame(1, 90, 31, b""),
                           "tx.rollback-ok")
        writer.write(get)
        await expect_bytes(reader,
            method_frame(1, 60, 72, shortstr("")), "get-empty after rollback")

        # exchange.unbind -> unbind-ok with the spec-quirk method id 51
        writer.write(method_frame(1, 40, 40,
            struct.pack(">H", 0) + shortstr("gx.dst") + shortstr("gx.src")
            + shortstr("k") + no_bits + table()))
        await expect_bytes(reader, method_frame(1, 40, 51, b""),
                           "exchange.unbind-ok (method id 51)")
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except Exception:
            pass
        await srv.stop()
