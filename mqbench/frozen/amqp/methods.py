"""AMQP 0-9-1 method classes — declarative registry and generic codec.

Capability parity with the reference's method-class hierarchy
(chana-mq-base .../method/Method.scala:20-71 and the per-class files
Connection.scala, Channel.scala, Exchange.scala, Queue.scala, Basic.scala,
Tx.scala, Confirm.scala, Access.scala), built differently: instead of one
hand-written case class + codec per method, every method is *declared* as a
field-spec tuple and a single generic codec (with AMQP bit-packing: adjacent
bit fields share octets) derives encode/decode for all of them.

Usage:
    m = Basic.Publish(exchange="logs", routing_key="k", mandatory=True)
    payload = m.encode()              # method-frame payload incl. class/method ids
    m2 = decode_method(payload)       # -> Basic.Publish instance
"""

from __future__ import annotations

import struct
from io import BytesIO
from typing import Any, BinaryIO, ClassVar

from . import value_codec as vc
from .constants import ClassId

# field domains
OCTET = "octet"
SHORT = "short"
LONG = "long"
LONGLONG = "longlong"
BIT = "bit"
SHORTSTR = "shortstr"
LONGSTR = "longstr"
TABLE = "table"

_DEFAULTS: dict[str, Any] = {
    OCTET: 0,
    SHORT: 0,
    LONG: 0,
    LONGLONG: 0,
    BIT: False,
    SHORTSTR: "",
    LONGSTR: b"",
    TABLE: None,
}

_registry: dict[tuple[int, int], type["Method"]] = {}


class Method:
    """Base for all AMQP methods. Subclasses are generated by `_method`."""

    CLASS_ID: ClassVar[int]
    METHOD_ID: ClassVar[int]
    NAME: ClassVar[str]
    FIELDS: ClassVar[tuple[tuple[str, str], ...]]
    # True when the method frame is followed by content header + body frames.
    HAS_CONTENT: ClassVar[bool] = False
    # True when the method is a synchronous request expecting a reply.
    EXPECT_RESPONSE: ClassVar[bool] = False

    __slots__ = ("_values",)

    def __init__(self, **kwargs: Any) -> None:
        values = {}
        for name, domain in self.FIELDS:
            value = kwargs.pop(name, _DEFAULTS[domain])
            if domain == TABLE and value is None:
                value = {}
            values[name] = value
        if kwargs:
            raise TypeError(
                f"{self.NAME}: unexpected fields {sorted(kwargs)}; "
                f"valid: {[f for f, _ in self.FIELDS]}"
            )
        object.__setattr__(self, "_values", values)

    def __getattr__(self, name: str) -> Any:
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(name) from None

    def __eq__(self, other: object) -> bool:
        # compare declared fields only: fast decoders may stash extra
        # derived entries (e.g. basic.publish's exrk_raw wire slice) in
        # _values that a generically-built method won't have
        return (
            isinstance(other, Method)
            and other.CLASS_ID == self.CLASS_ID
            and other.METHOD_ID == self.METHOD_ID
            and all(
                other._values.get(name) == self._values.get(name)
                for name, _ in self.FIELDS
            )
        )

    def __hash__(self) -> int:
        # Field values may contain dicts (tables); the wire encoding is the
        # canonical hashable form.
        return hash((self.CLASS_ID, self.METHOD_ID, self.encode()))

    def __repr__(self) -> str:
        args = ", ".join(
            f"{name}={self._values[name]!r}"
            for name, _ in self.FIELDS if name in self._values)
        return f"{self.NAME}({args})"

    # -- codec ------------------------------------------------------------

    def encode(self) -> bytes:
        """Encode to a METHOD-frame payload: class-id, method-id, arguments."""
        out = BytesIO()
        out.write(struct.pack(">HH", self.CLASS_ID, self.METHOD_ID))
        bit_accum = 0
        bit_count = 0
        for name, domain in self.FIELDS:
            value = self._values[name]
            if domain == BIT:
                if bit_count == 8:
                    vc.write_octet(out, bit_accum)
                    bit_accum = bit_count = 0
                if value:
                    bit_accum |= 1 << bit_count
                bit_count += 1
                continue
            if bit_count:
                vc.write_octet(out, bit_accum)
                bit_accum = bit_count = 0
            if domain == OCTET:
                vc.write_octet(out, value)
            elif domain == SHORT:
                vc.write_short(out, value)
            elif domain == LONG:
                vc.write_long(out, value)
            elif domain == LONGLONG:
                vc.write_longlong(out, value)
            elif domain == SHORTSTR:
                vc.write_shortstr(out, value)
            elif domain == LONGSTR:
                vc.write_longstr(out, value)
            elif domain == TABLE:
                vc.write_table(out, value)
            else:  # pragma: no cover
                raise AssertionError(domain)
        if bit_count:
            vc.write_octet(out, bit_accum)
        return out.getvalue()

    @classmethod
    def decode_args(cls, stream: BinaryIO) -> "Method":
        """Decode method arguments (after class/method ids were consumed)."""
        values: dict[str, Any] = {}
        bit_accum = 0
        bit_count = 8  # force a fresh octet on first bit field
        for name, domain in cls.FIELDS:
            if domain == BIT:
                if bit_count == 8:
                    bit_accum = vc.read_octet(stream)
                    bit_count = 0
                values[name] = bool(bit_accum & (1 << bit_count))
                bit_count += 1
                continue
            bit_count = 8
            if domain == OCTET:
                values[name] = vc.read_octet(stream)
            elif domain == SHORT:
                values[name] = vc.read_short(stream)
            elif domain == LONG:
                values[name] = vc.read_long(stream)
            elif domain == LONGLONG:
                values[name] = vc.read_longlong(stream)
            elif domain == SHORTSTR:
                values[name] = vc.read_shortstr(stream)
            elif domain == LONGSTR:
                values[name] = vc.read_longstr_bytes(stream)
            elif domain == TABLE:
                values[name] = vc.read_table(stream)
            else:  # pragma: no cover
                raise AssertionError(domain)
        return cls(**values)


class MethodDecodeError(vc.CodecError):
    pass


def decode_method(payload: bytes) -> Method:
    """Decode a METHOD-frame payload into a Method instance."""
    if len(payload) < 4:
        raise MethodDecodeError("method payload shorter than 4 bytes")
    class_id, method_id = struct.unpack_from(">HH", payload)
    fast = _FAST_DECODERS.get((class_id, method_id))
    if fast is not None:
        try:
            return fast(payload)
        except (IndexError, UnicodeDecodeError) as exc:
            raise MethodDecodeError(f"truncated/bad method payload: {exc}") from None
    cls = _registry.get((class_id, method_id))
    if cls is None:
        raise MethodDecodeError(f"unknown method class={class_id} method={method_id}")
    return cls.decode_args(BytesIO(payload[4:]))


def _method(
    holder: type,
    class_id: int,
    method_id: int,
    name: str,
    fields: tuple[tuple[str, str], ...],
    *,
    content: bool = False,
    response: bool = False,
) -> None:
    cls_name = name.split(".", 1)[1].replace("-", "_").title().replace("_", "")
    cls = type(
        cls_name,
        (Method,),
        {
            "CLASS_ID": class_id,
            "METHOD_ID": method_id,
            "NAME": name,
            "FIELDS": fields,
            "HAS_CONTENT": content,
            "EXPECT_RESPONSE": response,
            "__slots__": (),
        },
    )
    _registry[(class_id, method_id)] = cls
    setattr(holder, cls_name, cls)


class Connection:
    """connection class (id 10) — lifecycle: start/start-ok, secure/secure-ok,
    tune/tune-ok, open/open-ok, close/close-ok, blocked/unblocked."""


class Channel:
    """channel class (id 20)."""


class Access:
    """access class (id 30) — deprecated in 0-9-1, kept for client compat."""


class Exchange:
    """exchange class (id 40)."""


class Queue:
    """queue class (id 50)."""


class Basic:
    """basic class (id 60) — content transfer."""


class Confirm:
    """confirm class (id 85) — RabbitMQ publisher-confirms extension."""


class Tx:
    """tx class (id 90) — transactions."""


_C = ClassId

_method(Connection, _C.CONNECTION, 10, "connection.start", (
    ("version_major", OCTET), ("version_minor", OCTET),
    ("server_properties", TABLE), ("mechanisms", LONGSTR), ("locales", LONGSTR),
), response=True)
_method(Connection, _C.CONNECTION, 11, "connection.start-ok", (
    ("client_properties", TABLE), ("mechanism", SHORTSTR),
    ("response", LONGSTR), ("locale", SHORTSTR),
))
_method(Connection, _C.CONNECTION, 20, "connection.secure", (("challenge", LONGSTR),), response=True)
_method(Connection, _C.CONNECTION, 21, "connection.secure-ok", (("response", LONGSTR),))
_method(Connection, _C.CONNECTION, 30, "connection.tune", (
    ("channel_max", SHORT), ("frame_max", LONG), ("heartbeat", SHORT),
), response=True)
_method(Connection, _C.CONNECTION, 31, "connection.tune-ok", (
    ("channel_max", SHORT), ("frame_max", LONG), ("heartbeat", SHORT),
))
_method(Connection, _C.CONNECTION, 40, "connection.open", (
    ("virtual_host", SHORTSTR), ("capabilities", SHORTSTR), ("insist", BIT),
), response=True)
_method(Connection, _C.CONNECTION, 41, "connection.open-ok", (("known_hosts", SHORTSTR),))
_method(Connection, _C.CONNECTION, 50, "connection.close", (
    ("reply_code", SHORT), ("reply_text", SHORTSTR),
    ("class_id", SHORT), ("method_id", SHORT),
), response=True)
_method(Connection, _C.CONNECTION, 51, "connection.close-ok", ())
_method(Connection, _C.CONNECTION, 60, "connection.blocked", (("reason", SHORTSTR),))
_method(Connection, _C.CONNECTION, 61, "connection.unblocked", ())

_method(Channel, _C.CHANNEL, 10, "channel.open", (("out_of_band", SHORTSTR),), response=True)
_method(Channel, _C.CHANNEL, 11, "channel.open-ok", (("channel_id", LONGSTR),))
_method(Channel, _C.CHANNEL, 20, "channel.flow", (("active", BIT),), response=True)
_method(Channel, _C.CHANNEL, 21, "channel.flow-ok", (("active", BIT),))
_method(Channel, _C.CHANNEL, 40, "channel.close", (
    ("reply_code", SHORT), ("reply_text", SHORTSTR),
    ("class_id", SHORT), ("method_id", SHORT),
), response=True)
_method(Channel, _C.CHANNEL, 41, "channel.close-ok", ())

_method(Access, _C.ACCESS, 10, "access.request", (
    ("realm", SHORTSTR), ("exclusive", BIT), ("passive", BIT),
    ("active", BIT), ("write", BIT), ("read", BIT),
), response=True)
_method(Access, _C.ACCESS, 11, "access.request-ok", (("ticket", SHORT),))

_method(Exchange, _C.EXCHANGE, 10, "exchange.declare", (
    ("ticket", SHORT), ("exchange", SHORTSTR), ("type", SHORTSTR),
    ("passive", BIT), ("durable", BIT), ("auto_delete", BIT),
    ("internal", BIT), ("nowait", BIT), ("arguments", TABLE),
), response=True)
_method(Exchange, _C.EXCHANGE, 11, "exchange.declare-ok", ())
_method(Exchange, _C.EXCHANGE, 20, "exchange.delete", (
    ("ticket", SHORT), ("exchange", SHORTSTR),
    ("if_unused", BIT), ("nowait", BIT),
), response=True)
_method(Exchange, _C.EXCHANGE, 21, "exchange.delete-ok", ())
_method(Exchange, _C.EXCHANGE, 30, "exchange.bind", (
    ("ticket", SHORT), ("destination", SHORTSTR), ("source", SHORTSTR),
    ("routing_key", SHORTSTR), ("nowait", BIT), ("arguments", TABLE),
), response=True)
_method(Exchange, _C.EXCHANGE, 31, "exchange.bind-ok", ())
_method(Exchange, _C.EXCHANGE, 40, "exchange.unbind", (
    ("ticket", SHORT), ("destination", SHORTSTR), ("source", SHORTSTR),
    ("routing_key", SHORTSTR), ("nowait", BIT), ("arguments", TABLE),
), response=True)
# Spec quirk: exchange.unbind-ok is method id 51, not 41.
_method(Exchange, _C.EXCHANGE, 51, "exchange.unbind-ok", ())

_method(Queue, _C.QUEUE, 10, "queue.declare", (
    ("ticket", SHORT), ("queue", SHORTSTR), ("passive", BIT), ("durable", BIT),
    ("exclusive", BIT), ("auto_delete", BIT), ("nowait", BIT), ("arguments", TABLE),
), response=True)
_method(Queue, _C.QUEUE, 11, "queue.declare-ok", (
    ("queue", SHORTSTR), ("message_count", LONG), ("consumer_count", LONG),
))
_method(Queue, _C.QUEUE, 20, "queue.bind", (
    ("ticket", SHORT), ("queue", SHORTSTR), ("exchange", SHORTSTR),
    ("routing_key", SHORTSTR), ("nowait", BIT), ("arguments", TABLE),
), response=True)
_method(Queue, _C.QUEUE, 21, "queue.bind-ok", ())
_method(Queue, _C.QUEUE, 30, "queue.purge", (
    ("ticket", SHORT), ("queue", SHORTSTR), ("nowait", BIT),
), response=True)
_method(Queue, _C.QUEUE, 31, "queue.purge-ok", (("message_count", LONG),))
_method(Queue, _C.QUEUE, 40, "queue.delete", (
    ("ticket", SHORT), ("queue", SHORTSTR),
    ("if_unused", BIT), ("if_empty", BIT), ("nowait", BIT),
), response=True)
_method(Queue, _C.QUEUE, 41, "queue.delete-ok", (("message_count", LONG),))
_method(Queue, _C.QUEUE, 50, "queue.unbind", (
    ("ticket", SHORT), ("queue", SHORTSTR), ("exchange", SHORTSTR),
    ("routing_key", SHORTSTR), ("arguments", TABLE),
), response=True)
_method(Queue, _C.QUEUE, 51, "queue.unbind-ok", ())

_method(Basic, _C.BASIC, 10, "basic.qos", (
    ("prefetch_size", LONG), ("prefetch_count", SHORT), ("global_", BIT),
), response=True)
_method(Basic, _C.BASIC, 11, "basic.qos-ok", ())
_method(Basic, _C.BASIC, 20, "basic.consume", (
    ("ticket", SHORT), ("queue", SHORTSTR), ("consumer_tag", SHORTSTR),
    ("no_local", BIT), ("no_ack", BIT), ("exclusive", BIT),
    ("nowait", BIT), ("arguments", TABLE),
), response=True)
_method(Basic, _C.BASIC, 21, "basic.consume-ok", (("consumer_tag", SHORTSTR),))
_method(Basic, _C.BASIC, 30, "basic.cancel", (
    ("consumer_tag", SHORTSTR), ("nowait", BIT),
), response=True)
_method(Basic, _C.BASIC, 31, "basic.cancel-ok", (("consumer_tag", SHORTSTR),))
_method(Basic, _C.BASIC, 40, "basic.publish", (
    ("ticket", SHORT), ("exchange", SHORTSTR), ("routing_key", SHORTSTR),
    ("mandatory", BIT), ("immediate", BIT),
), content=True)
_method(Basic, _C.BASIC, 50, "basic.return", (
    ("reply_code", SHORT), ("reply_text", SHORTSTR),
    ("exchange", SHORTSTR), ("routing_key", SHORTSTR),
), content=True)
_method(Basic, _C.BASIC, 60, "basic.deliver", (
    ("consumer_tag", SHORTSTR), ("delivery_tag", LONGLONG), ("redelivered", BIT),
    ("exchange", SHORTSTR), ("routing_key", SHORTSTR),
), content=True)
_method(Basic, _C.BASIC, 70, "basic.get", (
    ("ticket", SHORT), ("queue", SHORTSTR), ("no_ack", BIT),
), response=True)
_method(Basic, _C.BASIC, 71, "basic.get-ok", (
    ("delivery_tag", LONGLONG), ("redelivered", BIT),
    ("exchange", SHORTSTR), ("routing_key", SHORTSTR), ("message_count", LONG),
), content=True)
_method(Basic, _C.BASIC, 72, "basic.get-empty", (("cluster_id", SHORTSTR),))
_method(Basic, _C.BASIC, 80, "basic.ack", (("delivery_tag", LONGLONG), ("multiple", BIT)))
_method(Basic, _C.BASIC, 90, "basic.reject", (("delivery_tag", LONGLONG), ("requeue", BIT)))
_method(Basic, _C.BASIC, 100, "basic.recover-async", (("requeue", BIT),))
_method(Basic, _C.BASIC, 110, "basic.recover", (("requeue", BIT),), response=True)
_method(Basic, _C.BASIC, 111, "basic.recover-ok", ())
_method(Basic, _C.BASIC, 120, "basic.nack", (
    ("delivery_tag", LONGLONG), ("multiple", BIT), ("requeue", BIT),
))

_method(Confirm, _C.CONFIRM, 10, "confirm.select", (("nowait", BIT),), response=True)
_method(Confirm, _C.CONFIRM, 11, "confirm.select-ok", ())

_method(Tx, _C.TX, 10, "tx.select", (), response=True)
_method(Tx, _C.TX, 11, "tx.select-ok", ())
_method(Tx, _C.TX, 20, "tx.commit", (), response=True)
_method(Tx, _C.TX, 21, "tx.commit-ok", ())
_method(Tx, _C.TX, 30, "tx.rollback", (), response=True)
_method(Tx, _C.TX, 31, "tx.rollback-ok", ())


def registry_size() -> int:
    return len(_registry)


# ---------------------------------------------------------------------------
# hand-rolled hot-path codecs
# ---------------------------------------------------------------------------
# Basic.Publish / Basic.Deliver / Basic.Ack dominate broker and client CPU
# (they run once per message). These bypass the generic field-spec
# interpreter (encode()/decode_args() above) with direct byte slicing; the
# generic path remains the reference implementation for every other method
# and for these in tests (tests/test_methods.py asserts both agree).


def _mk(cls: type, values: dict) -> Method:
    m = cls.__new__(cls)
    object.__setattr__(m, "_values", values)
    return m


def parse_publish_wire(payload: bytes) -> tuple[str, str, int, int]:
    """Raw Basic.Publish argument parse, the one source of truth for the
    wire layout (SHORT ticket, SHORTSTR exchange, SHORTSTR routing-key,
    BITS mandatory/immediate): returns (exchange, routing_key, bits,
    bits_pos) where payload[6:bits_pos] is the length-prefixed
    exchange+routing-key slice basic.deliver reuses verbatim. Shared by the
    generic fast decoder and the connection's fused scan path."""
    pos = 6
    n = payload[pos]
    pos += 1
    exchange = payload[pos:pos + n].decode("utf-8")
    pos += n
    n = payload[pos]
    pos += 1
    routing_key = payload[pos:pos + n].decode("utf-8")
    pos += n
    if pos + 1 != len(payload):
        raise MethodDecodeError("basic.publish: trailing bytes")
    return exchange, routing_key, payload[pos], pos


def _fast_decode_publish(payload: bytes) -> Method:
    exchange, routing_key, bits, pos = parse_publish_wire(payload)
    return _mk(Basic.Publish, {
        "ticket": (payload[4] << 8) | payload[5],
        "exchange": exchange, "routing_key": routing_key,
        "mandatory": bool(bits & 1), "immediate": bool(bits & 2),
        # the length-prefixed exchange+routing-key wire slice, exactly as
        # basic.deliver needs it — lets the deliver render skip re-encoding
        "exrk_raw": payload[6:pos],
    })


def _fast_decode_deliver(payload: bytes) -> Method:
    # SHORTSTR consumer-tag, LONGLONG delivery-tag, BIT redelivered,
    # SHORTSTR exchange, SHORTSTR routing-key
    pos = 4
    n = payload[pos]
    pos += 1
    consumer_tag = payload[pos:pos + n].decode("utf-8")
    pos += n
    delivery_tag = int.from_bytes(payload[pos:pos + 8], "big")
    pos += 8
    redelivered = bool(payload[pos] & 1)
    pos += 1
    n = payload[pos]
    pos += 1
    exchange = payload[pos:pos + n].decode("utf-8")
    pos += n
    n = payload[pos]
    pos += 1
    routing_key = payload[pos:pos + n].decode("utf-8")
    pos += n
    if pos != len(payload):
        raise MethodDecodeError("basic.deliver: trailing bytes")
    return _mk(Basic.Deliver, {
        "consumer_tag": consumer_tag, "delivery_tag": delivery_tag,
        "redelivered": redelivered, "exchange": exchange,
        "routing_key": routing_key,
    })


def _fast_decode_ack(payload: bytes) -> Method:
    if len(payload) != 13:
        raise MethodDecodeError("basic.ack: bad length")
    return _mk(Basic.Ack, {
        "delivery_tag": int.from_bytes(payload[4:12], "big"),
        "multiple": bool(payload[12] & 1),
    })


_FAST_DECODERS = {
    (ClassId.BASIC, 40): _fast_decode_publish,
    (ClassId.BASIC, 60): _fast_decode_deliver,
    (ClassId.BASIC, 80): _fast_decode_ack,
}


def _fast_encode_publish(self: Method) -> bytes:
    v = self._values
    ex = v["exchange"].encode("utf-8")
    rk = v["routing_key"].encode("utf-8")
    bits = (1 if v["mandatory"] else 0) | (2 if v["immediate"] else 0)
    return b"".join((
        b"\x00\x3c\x00\x28",
        struct.pack(">H", v["ticket"]),
        bytes((len(ex),)), ex,
        bytes((len(rk),)), rk,
        bytes((bits,)),
    ))


def _fast_encode_deliver(self: Method) -> bytes:
    v = self._values
    ct = v["consumer_tag"].encode("utf-8")
    ex = v["exchange"].encode("utf-8")
    rk = v["routing_key"].encode("utf-8")
    return b"".join((
        b"\x00\x3c\x00\x3c",
        bytes((len(ct),)), ct,
        v["delivery_tag"].to_bytes(8, "big"),
        b"\x01" if v["redelivered"] else b"\x00",
        bytes((len(ex),)), ex,
        bytes((len(rk),)), rk,
    ))


def _fast_encode_ack(self: Method) -> bytes:
    v = self._values
    return (
        b"\x00\x3c\x00\x50"
        + v["delivery_tag"].to_bytes(8, "big")
        + (b"\x01" if v["multiple"] else b"\x00")
    )


Basic.Publish.encode = _fast_encode_publish  # type: ignore[method-assign]
Basic.Deliver.encode = _fast_encode_deliver  # type: ignore[method-assign]
Basic.Ack.encode = _fast_encode_ack  # type: ignore[method-assign]
