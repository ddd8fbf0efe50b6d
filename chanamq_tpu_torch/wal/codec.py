"""WAL record codec: framed, CRC-checked, length-prefixed op records.

Every durable store mutation becomes one record in the shard's log:

    u32 payload_len | u32 crc32(payload) | payload
    payload = u64 lsn | u8 op_index | encoded args tuple

The op index into :data:`OPS` is wire format (append-only, like the
trace stage tags); the argument values are encoded with a compact
self-describing binary codec covering exactly the types the store API
carries — None/bool/int/float/bytes/str/list/tuple/dict plus the three
Stored* dataclasses. No pickle: replay of a hostile or corrupted log
must never execute anything, only reconstruct data.

Tail semantics on read-back (scan_frames): a frame that runs past the
end of the file, or whose CRC fails on the very last frame, is a *torn*
write — the crash interrupted the append and everything before it is
intact, so recovery truncates the tail and replays the rest.  A CRC
failure with more data behind it is *corruption* — ordering below the
bad record can't be trusted, so replay stops there (skip-and-stop).
"""

from __future__ import annotations

import struct
from zlib import crc32

from ..store.api import StoredExchange, StoredMessage, StoredQueue

# Journaled op names. Index is wire format: append-only, never reorder.
OPS = (
    "insert_message",
    "delete_message",
    "delete_messages",
    "update_message_refer_count",
    "insert_queue_meta",
    "insert_queue_msg",
    "delete_queue_msg",
    "replace_queue_msgs",
    "replace_queue_unacks",
    "update_queue_last_consumed",
    "insert_queue_unacks",
    "delete_queue_msgs_offsets",
    "delete_queue_unacks",
    "archive_queue",
    "delete_queue",
    "purge_queue_msgs",
    "insert_stream_segment",
    "delete_stream_segments",
    "update_stream_cursor",
    "delete_stream_data",
    "insert_exchange",
    "delete_exchange",
    "insert_bind",
    "delete_bind",
    "delete_queue_binds",
    "insert_exchange_bind",
    "delete_exchange_bind",
    "delete_exchange_binds_dest",
    "insert_vhost",
    "delete_vhost",
    "worker_id_floor",  # replay-only: next_worker_id = max(current, n)
    # fused persistent publish: (msg, vhost, queue, offset, body_size,
    # expire_at_ms) — one record covers the blob and its queue-log row, so
    # the hot path frames (and CRCs) once per publish instead of twice.
    # Appended after the fact: wire indices above never move.
    "insert_published",
    # atomic transaction scope: ([(op_index, args), ...],) — every store
    # mutation a Tx.Commit staged, framed as ONE record with ONE CRC.
    # scan_frames cannot split inside a frame, so a crash either keeps the
    # whole transaction (record durable) or loses it whole (torn tail
    # truncated): the all-or-nothing guarantee multi-record commits cannot
    # give, because a group-commit batch can tear at record granularity.
    "tx_batch",
)
OP_INDEX = {name: i for i, name in enumerate(OPS)}

_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")
_U64 = struct.Struct("<Q")
_F64 = struct.Struct("<d")

# frames larger than this are treated as corruption on read-back (the
# engine never writes one: segment-bytes caps far below it)
MAX_FRAME = 256 * 1024 * 1024


class WalCodecError(ValueError):
    pass


# -- value codec -------------------------------------------------------------

def _enc_value(buf: bytearray, v) -> None:
    if v is None:
        buf += b"N"
    elif v is True:
        buf += b"T"
    elif v is False:
        buf += b"F"
    elif type(v) is int:
        if -(1 << 63) <= v < (1 << 63):
            buf += b"i"
            buf += _I64.pack(v)
        else:  # arbitrary-precision fallback (arguments dicts)
            raw = v.to_bytes((v.bit_length() + 8) // 8, "little", signed=True)
            buf += b"I"
            buf += _U32.pack(len(raw))
            buf += raw
    elif type(v) is float:
        buf += b"f"
        buf += _F64.pack(v)
    elif type(v) is bytes or type(v) is bytearray or type(v) is memoryview:
        raw = bytes(v)
        buf += b"b"
        buf += _U32.pack(len(raw))
        buf += raw
    elif type(v) is str:
        raw = v.encode("utf-8")
        buf += b"s"
        buf += _U32.pack(len(raw))
        buf += raw
    elif type(v) is list:
        buf += b"l"
        buf += _U32.pack(len(v))
        for item in v:
            _enc_value(buf, item)
    elif type(v) is tuple:
        buf += b"t"
        buf += _U32.pack(len(v))
        for item in v:
            _enc_value(buf, item)
    elif type(v) is dict:
        buf += b"d"
        buf += _U32.pack(len(v))
        for k, item in v.items():
            _enc_value(buf, k)
            _enc_value(buf, item)
    elif type(v) is StoredMessage:
        buf += b"M"
        _enc_value(buf, (v.id, v.properties_raw, v.body, v.exchange,
                         v.routing_key, v.refer_count, v.ttl_ms))
    elif type(v) is StoredQueue:
        buf += b"Q"
        _enc_value(buf, (v.vhost, v.name, v.durable, v.exclusive,
                         v.auto_delete, v.ttl_ms, v.last_consumed,
                         v.arguments, v.msgs, v.unacks))
    elif type(v) is StoredExchange:
        buf += b"X"
        _enc_value(buf, (v.vhost, v.name, v.type, v.durable, v.auto_delete,
                         v.internal, v.arguments, v.binds, v.ex_binds))
    else:
        raise WalCodecError(f"unencodable value type {type(v).__name__}")


def _dec_value(view, pos: int):
    tag = view[pos:pos + 1]
    pos += 1
    if tag == b"N":
        return None, pos
    if tag == b"T":
        return True, pos
    if tag == b"F":
        return False, pos
    if tag == b"i":
        return _I64.unpack_from(view, pos)[0], pos + 8
    if tag == b"I":
        n = _U32.unpack_from(view, pos)[0]
        pos += 4
        return int.from_bytes(bytes(view[pos:pos + n]), "little",
                              signed=True), pos + n
    if tag == b"f":
        return _F64.unpack_from(view, pos)[0], pos + 8
    if tag == b"b":
        n = _U32.unpack_from(view, pos)[0]
        pos += 4
        return bytes(view[pos:pos + n]), pos + n
    if tag == b"s":
        n = _U32.unpack_from(view, pos)[0]
        pos += 4
        return bytes(view[pos:pos + n]).decode("utf-8"), pos + n
    if tag in (b"l", b"t"):
        n = _U32.unpack_from(view, pos)[0]
        pos += 4
        items = []
        for _ in range(n):
            item, pos = _dec_value(view, pos)
            items.append(item)
        return (tuple(items) if tag == b"t" else items), pos
    if tag == b"d":
        n = _U32.unpack_from(view, pos)[0]
        pos += 4
        out = {}
        for _ in range(n):
            k, pos = _dec_value(view, pos)
            v, pos = _dec_value(view, pos)
            out[k] = v
        return out, pos
    if tag == b"M":
        f, pos = _dec_value(view, pos)
        return StoredMessage(id=f[0], properties_raw=f[1], body=f[2],
                             exchange=f[3], routing_key=f[4],
                             refer_count=f[5], ttl_ms=f[6]), pos
    if tag == b"Q":
        f, pos = _dec_value(view, pos)
        return StoredQueue(vhost=f[0], name=f[1], durable=f[2],
                           exclusive=f[3], auto_delete=f[4], ttl_ms=f[5],
                           last_consumed=f[6], arguments=f[7],
                           msgs=list(f[8]), unacks=dict(f[9])), pos
    if tag == b"X":
        f, pos = _dec_value(view, pos)
        return StoredExchange(vhost=f[0], name=f[1], type=f[2], durable=f[3],
                              auto_delete=f[4], internal=f[5], arguments=f[6],
                              binds=list(f[7]), ex_binds=list(f[8])), pos
    raise WalCodecError(f"bad value tag {tag!r} at {pos - 1}")


# -- hot-path framing --------------------------------------------------------
# The two ops every persistent publish journals (message blob + queue-log
# row) get hand-rolled builders: same wire bytes as encode_record, but one
# join instead of a recursive _enc_value walk (~3x fewer Python calls on
# the broker's event loop).  Any shape the fast path can't prove — exotic
# types, oversize ints — returns None and the caller falls back to the
# generic encoder, so the format stays defined in exactly one place.

_HDR = struct.Struct("<II")
_OP_INS_MSG = bytes([OP_INDEX["insert_message"]])
_OP_INS_QMSG = bytes([OP_INDEX["insert_queue_msg"]])
_OP_INS_PUB = bytes([OP_INDEX["insert_published"]])
_I64_MAX = 1 << 63


def encode_insert_message(lsn: int, msg) -> "bytes | None":
    body = msg.body
    props = msg.properties_raw
    ttl = msg.ttl_ms
    if (type(body) is not bytes or type(props) is not bytes
            or type(msg.exchange) is not str
            or type(msg.routing_key) is not str
            or not (type(msg.id) is int and 0 <= msg.id < _I64_MAX)
            or not (type(msg.refer_count) is int
                    and -_I64_MAX <= msg.refer_count < _I64_MAX)):
        return None
    if ttl is None:
        tail = b"N"
    elif type(ttl) is int and -_I64_MAX <= ttl < _I64_MAX:
        tail = b"i" + _I64.pack(ttl)
    else:
        return None
    exb = msg.exchange.encode("utf-8")
    rkb = msg.routing_key.encode("utf-8")
    payload = b"".join((
        _U64.pack(lsn), _OP_INS_MSG,
        b"t\x01\x00\x00\x00M" b"t\x07\x00\x00\x00",
        b"i", _I64.pack(msg.id),
        b"b", _U32.pack(len(props)), props,
        b"b", _U32.pack(len(body)), body,
        b"s", _U32.pack(len(exb)), exb,
        b"s", _U32.pack(len(rkb)), rkb,
        b"i", _I64.pack(msg.refer_count),
        tail,
    ))
    return _HDR.pack(len(payload), crc32(payload)) + payload


def queue_prefix(vhost: str, queue: str) -> bytes:
    """Encoded (vhost, queue) string pair — the per-queue constant chunk of
    row payloads; callers cache it so the hot path packs only the ints."""
    vb = vhost.encode("utf-8")
    qb = queue.encode("utf-8")
    return (b"s" + _U32.pack(len(vb)) + vb
            + b"s" + _U32.pack(len(qb)) + qb)


def encode_insert_queue_msg(lsn: int, vq: bytes, offset: int,
                            msg_id: int, body_size: int,
                            expire_at_ms) -> "bytes | None":
    if expire_at_ms is None:
        tail = b"N"
    elif type(expire_at_ms) is int and -_I64_MAX <= expire_at_ms < _I64_MAX:
        tail = b"i" + _I64.pack(expire_at_ms)
    else:
        return None
    if not (type(offset) is int and 0 <= offset < _I64_MAX
            and type(msg_id) is int and 0 <= msg_id < _I64_MAX
            and type(body_size) is int and 0 <= body_size < _I64_MAX):
        return None
    payload = b"".join((
        _U64.pack(lsn), _OP_INS_QMSG,
        b"t\x06\x00\x00\x00", vq,
        b"i", _I64.pack(offset),
        b"i", _I64.pack(msg_id),
        b"i", _I64.pack(body_size),
        tail,
    ))
    return _HDR.pack(len(payload), crc32(payload)) + payload


def encode_insert_published(lsn: int, msg, vq: bytes, offset: int,
                            body_size: int, expire_at_ms) -> "bytes | None":
    body = msg.body
    props = msg.properties_raw
    ttl = msg.ttl_ms
    if (type(body) is not bytes or type(props) is not bytes
            or type(msg.exchange) is not str
            or type(msg.routing_key) is not str
            or not (type(msg.id) is int and 0 <= msg.id < _I64_MAX)
            or not (type(msg.refer_count) is int
                    and -_I64_MAX <= msg.refer_count < _I64_MAX)
            or not (type(offset) is int and 0 <= offset < _I64_MAX)
            or not (type(body_size) is int and 0 <= body_size < _I64_MAX)):
        return None
    if ttl is None:
        ttl_tail = b"N"
    elif type(ttl) is int and -_I64_MAX <= ttl < _I64_MAX:
        ttl_tail = b"i" + _I64.pack(ttl)
    else:
        return None
    if expire_at_ms is None:
        exp_tail = b"N"
    elif (type(expire_at_ms) is int
            and -_I64_MAX <= expire_at_ms < _I64_MAX):
        exp_tail = b"i" + _I64.pack(expire_at_ms)
    else:
        return None
    exb = msg.exchange.encode("utf-8")
    rkb = msg.routing_key.encode("utf-8")
    payload = b"".join((
        _U64.pack(lsn), _OP_INS_PUB,
        b"t\x06\x00\x00\x00" b"M" b"t\x07\x00\x00\x00",
        b"i", _I64.pack(msg.id),
        b"b", _U32.pack(len(props)), props,
        b"b", _U32.pack(len(body)), body,
        b"s", _U32.pack(len(exb)), exb,
        b"s", _U32.pack(len(rkb)), rkb,
        b"i", _I64.pack(msg.refer_count),
        ttl_tail,
        vq,
        b"i", _I64.pack(offset),
        b"i", _I64.pack(body_size),
        exp_tail,
    ))
    return _HDR.pack(len(payload), crc32(payload)) + payload


# -- record framing ----------------------------------------------------------

def encode_record(lsn: int, op_index: int, args: tuple) -> bytes:
    payload = bytearray()
    payload += _U64.pack(lsn)
    payload.append(op_index)
    _enc_value(payload, args)
    payload = bytes(payload)
    return _U32.pack(len(payload)) + _U32.pack(crc32(payload)) + payload


def decode_payload(payload) -> "tuple[int, int, tuple]":
    view = memoryview(payload)
    lsn = _U64.unpack_from(view, 0)[0]
    op = view[8]
    args, end = _dec_value(view, 9)
    if end != len(view) or type(args) is not tuple:
        raise WalCodecError("record payload has trailing garbage")
    return lsn, op, args


def scan_frames(data) -> "tuple[list[bytes], int, str]":
    """Walk a segment's bytes frame by frame.

    Returns (payloads, good_bytes, status) where status is:
      "ok"      — every byte consumed by valid frames;
      "torn"    — the final frame was cut mid-write (runs past EOF, or
                  its CRC fails and nothing follows): truncate the tail
                  at good_bytes and keep everything before it;
      "corrupt" — a CRC failure with more data behind it: stop here, the
                  rest of the log cannot be trusted.
    """
    view = memoryview(data)
    total = len(view)
    pos = 0
    payloads: list[bytes] = []
    while pos < total:
        if total - pos < 8:
            return payloads, pos, "torn"
        length = _U32.unpack_from(view, pos)[0]
        want = _U32.unpack_from(view, pos + 4)[0]
        end = pos + 8 + length
        if length == 0 or length > MAX_FRAME:
            return payloads, pos, "torn" if end >= total else "corrupt"
        if end > total:
            return payloads, pos, "torn"
        payload = bytes(view[pos + 8:end])
        if crc32(payload) != want:
            return payloads, pos, "torn" if end == total else "corrupt"
        payloads.append(payload)
        pos = end
    return payloads, pos, "ok"
