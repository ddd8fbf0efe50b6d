"""Segmented append-only log primitives for stream queues.

A stream is a sequence of immutable records partitioned into segments
(Pulsar/RabbitMQ-streams layout, PAPERS.md "1.5 Million Messages Per
Second on 3 Machines"): one mutable *active* segment accepts appends;
once it crosses a size/age threshold it is *sealed* — frozen, encoded to
a single blob, and spilled to the store. Sealed segments are the unit of
retention (whole-segment truncation) and of persistence (one store row
per segment instead of one per message).

Record wire layout inside a segment blob, repeated back to back:

    offset        uint64    stream offset (monotonic from 1)
    ts_ms         uint64    broker append time, epoch milliseconds
    exchange_len  uint16    + utf-8 exchange name
    rkey_len      uint16    + utf-8 routing key
    header_len    uint32    + content-header frame payload (wire format)
    body_len      uint32    + body bytes

The content header is stored as the raw frame payload so replay delivers
byte-identical property frames without a decode/encode round trip.
"""

from __future__ import annotations

import struct
from typing import Optional

_FIXED = struct.Struct(">QQHHII")
_FIXED_SIZE = _FIXED.size


class StreamRecord:
    """One immutable record in a stream."""

    __slots__ = ("offset", "ts_ms", "exchange", "routing_key",
                 "header_raw", "body")

    def __init__(
        self,
        offset: int,
        ts_ms: int,
        exchange: str,
        routing_key: str,
        header_raw: bytes,
        body: bytes,
    ) -> None:
        self.offset = offset
        self.ts_ms = ts_ms
        self.exchange = exchange
        self.routing_key = routing_key
        self.header_raw = header_raw
        self.body = body

    @property
    def wire_size(self) -> int:
        """Encoded size; the unit of every stream byte limit so active and
        sealed segments account identically."""
        return (_FIXED_SIZE + len(self.exchange.encode())
                + len(self.routing_key.encode())
                + len(self.header_raw) + len(self.body))


class Segment:
    """A sealed segment's metadata (+ its records while cached resident).

    records is None when the segment has been evicted from RAM; the blob
    is reloaded from the store on the first cursor that reads into it.
    """

    __slots__ = ("base_offset", "last_offset", "first_ts_ms", "last_ts_ms",
                 "size_bytes", "records")

    def __init__(
        self,
        base_offset: int,
        last_offset: int,
        first_ts_ms: int,
        last_ts_ms: int,
        size_bytes: int,
        records: Optional[list[StreamRecord]] = None,
    ) -> None:
        self.base_offset = base_offset
        self.last_offset = last_offset
        self.first_ts_ms = first_ts_ms
        self.last_ts_ms = last_ts_ms
        self.size_bytes = size_bytes
        self.records = records


def pack_records(records: list[StreamRecord]) -> bytes:
    out = bytearray()
    for rec in records:
        exchange = rec.exchange.encode()
        rkey = rec.routing_key.encode()
        out += _FIXED.pack(rec.offset, rec.ts_ms, len(exchange), len(rkey),
                           len(rec.header_raw), len(rec.body))
        out += exchange
        out += rkey
        out += rec.header_raw
        out += rec.body
    return bytes(out)


def unpack_records_indexed(
    blob: bytes, base_offset: int, last_offset: int
) -> "list[Optional[StreamRecord]]":
    """Slot list covering base..last inclusive, indexed by offset-base.

    The record wire format carries explicit offsets, so a blob that key
    compaction made *sparse* (chanamq_tpu/wal/tier.py) reconstructs with
    None holes where records were dropped — the read paths index
    ``records[offset - base_offset]`` and skip the holes, keeping every
    committed cursor offset valid across compaction.  A dense blob fills
    every slot and behaves exactly as before.
    """
    slots: "list[Optional[StreamRecord]]" = (
        [None] * (last_offset - base_offset + 1))
    for rec in unpack_records(blob):
        idx = rec.offset - base_offset
        if 0 <= idx < len(slots):
            slots[idx] = rec
    return slots


def unpack_records(blob: bytes) -> list[StreamRecord]:
    records: list[StreamRecord] = []
    pos = 0
    end = len(blob)
    while pos < end:
        offset, ts_ms, elen, rlen, hlen, blen = _FIXED.unpack_from(blob, pos)
        pos += _FIXED_SIZE
        exchange = blob[pos:pos + elen].decode()
        pos += elen
        rkey = blob[pos:pos + rlen].decode()
        pos += rlen
        header_raw = blob[pos:pos + hlen]
        pos += hlen
        body = blob[pos:pos + blen]
        pos += blen
        records.append(
            StreamRecord(offset, ts_ms, exchange, rkey, header_raw, body))
    return records
