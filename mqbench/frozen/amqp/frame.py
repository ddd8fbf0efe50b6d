"""AMQP frame model and incremental frame parser.

Capability parity with the reference's Frame model and streaming parser
(chana-mq-base .../model/Frame.scala:38-216,
 .../engine/FrameParser.scala:67-158): a frame is
type(1) channel(2) size(4) payload(size) end(0xCE); the parser is an
incremental push parser that accepts arbitrary byte chunks and yields complete
frames, enforcing the negotiated frame-max and yielding protocol errors
instead of raising mid-stream.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterator

from .constants import (
    FRAME_END,
    FRAME_HEADER_SIZE,
    FrameType,
    ErrorCode,
)

_HEADER_STRUCT = struct.Struct(">BHI")

# Packed egress record meta, 33 bytes little-endian, shared between the
# broker's egress buffer and chana_encode_deliveries_packed (which memcpy's
# the fields, so no alignment requirement):
#   int32 channel | uint64 tag | uint8 redelivered |
#   int32 prefix_len | int32 exrk_len | int32 header_len | int64 body_len
# followed in the blob by prefix || exrk || header || body.
ENC_META = struct.Struct("<iQBiiiq")


@dataclass(frozen=True, slots=True)
class Frame:
    type: int
    channel: int
    payload: bytes

    def to_bytes(self) -> bytes:
        # join, not +: payload may be a memoryview (cluster data-plane
        # bodies are zero-copy slices of the peer's read buffer)
        return b"".join((
            _HEADER_STRUCT.pack(self.type, self.channel, len(self.payload)),
            self.payload,
            b"\xce",
        ))

    @staticmethod
    def method(channel: int, payload: bytes) -> "Frame":
        return Frame(FrameType.METHOD, channel, payload)

    @staticmethod
    def header(channel: int, payload: bytes) -> "Frame":
        return Frame(FrameType.HEADER, channel, payload)

    @staticmethod
    def body(channel: int, payload: bytes) -> "Frame":
        return Frame(FrameType.BODY, channel, payload)


HEARTBEAT_FRAME = Frame(FrameType.HEARTBEAT, 0, b"")
HEARTBEAT_BYTES = HEARTBEAT_FRAME.to_bytes()


def deliveries_wire_size(records: list, frame_max: int) -> int:
    """Exact wire size of encode_deliveries(records, frame_max)."""
    max_payload = frame_max - FRAME_HEADER_SIZE - 1 if frame_max else 0
    total = 0
    for _cid, prefix, _tag, _red, exrk, header, body in records:
        total += 16 + len(prefix) + 9 + len(exrk) + len(header)
        blen = len(body)
        if blen:
            chunks = -(-blen // max_payload) if frame_max else 1
            total += blen + 8 * chunks
    return total


def encode_deliveries(records: list, frame_max: int) -> bytes:
    """Pure-Python reference for chana_encode_deliveries: render a batch of
    ``(channel_id, prefix, tag, redelivered, exrk, header, body)`` delivery
    records (prefix = the basic.deliver method payload up to the delivery
    tag, exrk = length-prefixed exchange + routing-key, header = encoded
    content-header payload) into one contiguous wire buffer. Body frames
    split at frame_max - 8; frame_max 0 means no splitting. Used as the
    egress fallback when the native encoder is unavailable, and as the
    parity oracle in tests (byte-identical output is a test invariant)."""
    pack = _HEADER_STRUCT.pack
    parts: list = []
    for cid, prefix, tag, redelivered, exrk, header, body in records:
        method_payload = b"".join((
            prefix, tag.to_bytes(8, "big"),
            b"\x01" if redelivered else b"\x00", exrk))
        parts += (
            pack(1, cid, len(method_payload)), method_payload, b"\xce",
            pack(2, cid, len(header)), header, b"\xce",
        )
        if body:
            max_payload = (frame_max - FRAME_HEADER_SIZE - 1) if frame_max \
                else len(body)
            if len(body) <= max_payload:
                parts += (pack(3, cid, len(body)), body, b"\xce")
            else:
                for off in range(0, len(body), max_payload):
                    chunk = body[off:off + max_payload]
                    parts += (pack(3, cid, len(chunk)), chunk, b"\xce")
    return b"".join(parts)


@dataclass(frozen=True, slots=True)
class FrameError:
    """A protocol-level framing error to be reported via Connection.Close."""

    code: ErrorCode
    message: str


class FrameParser:
    """Incremental frame parser.

    Feed byte chunks with :meth:`feed`; it yields `Frame` or `FrameError`
    items. After a `FrameError` the parser stops consuming (the connection is
    expected to close).
    """

    __slots__ = ("frame_max", "_buf", "_dead")

    def __init__(self, frame_max: int = 0) -> None:
        # frame_max == 0 means "not yet negotiated": accept any size.
        self.frame_max = frame_max
        self._buf = bytearray()
        self._dead = False

    def feed(self, data: bytes) -> Iterator[Frame | FrameError]:
        if self._dead:
            return
        buf = self._buf
        buf += data
        offset = 0
        n = len(buf)
        while n - offset >= FRAME_HEADER_SIZE:
            ftype, channel, size = _HEADER_STRUCT.unpack_from(buf, offset)
            # Validate the type from the header alone: a corrupt stream would
            # otherwise make us buffer up to a bogus 4-byte size field.
            if ftype not in (
                FrameType.METHOD,
                FrameType.HEADER,
                FrameType.BODY,
                FrameType.HEARTBEAT,
            ):
                self._dead = True
                yield FrameError(ErrorCode.FRAME_ERROR, f"unknown frame type {ftype}")
                return
            if self.frame_max and size + 8 > self.frame_max:
                self._dead = True
                yield FrameError(
                    ErrorCode.FRAME_ERROR,
                    f"frame size {size} exceeds negotiated frame-max {self.frame_max}",
                )
                return
            end = offset + FRAME_HEADER_SIZE + size
            if n < end + 1:
                break
            if buf[end] != FRAME_END:
                self._dead = True
                yield FrameError(
                    ErrorCode.FRAME_ERROR,
                    f"missing frame-end octet (got 0x{buf[end]:02x})",
                )
                return
            yield Frame(ftype, channel, bytes(buf[offset + FRAME_HEADER_SIZE : end]))
            offset = end + 1
        if offset:
            del buf[:offset]
