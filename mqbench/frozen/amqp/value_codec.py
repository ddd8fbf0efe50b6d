"""AMQP field-table / field-value codec.

Capability parity with the reference's ValueReader/ValueWriter
(chana-mq-base .../model/ValueReader.scala:90-113, ValueWriter.scala:100-159):
the RabbitMQ field-value dialect — tags 'S' longstr, 'I' int32, 'D' decimal,
'T' timestamp, 'F' table, 'A' array, 'b' int8, 'd' double, 'f' float,
'l' int64, 's' int16, 't' bool, 'x' byte-array, 'V' void. Tables and arrays
are length-prefixed (uint32 byte length).

Python mapping: tables are dicts, arrays are lists, 'V' is None, decimals are
decimal.Decimal, timestamps are ints tagged via the Timestamp wrapper on write
(plain ints encode as 'l'; datetime/Timestamp encode as 'T').
"""

from __future__ import annotations

import datetime as _dt
import decimal
import struct
from io import BytesIO
from typing import Any, BinaryIO


class Timestamp(int):
    """An int subclass marking a value to be encoded as an AMQP timestamp ('T')."""


class CodecError(ValueError):
    pass


# ---------------------------------------------------------------------------
# primitive readers
# ---------------------------------------------------------------------------


def _read_exact(stream: BinaryIO, n: int) -> bytes:
    data = stream.read(n)
    if len(data) != n:
        raise CodecError(f"truncated read: wanted {n} bytes, got {len(data)}")
    return data


def read_octet(stream: BinaryIO) -> int:
    return _read_exact(stream, 1)[0]


def read_short(stream: BinaryIO) -> int:
    return struct.unpack(">H", _read_exact(stream, 2))[0]


def read_long(stream: BinaryIO) -> int:
    return struct.unpack(">I", _read_exact(stream, 4))[0]


def read_longlong(stream: BinaryIO) -> int:
    return struct.unpack(">Q", _read_exact(stream, 8))[0]


def read_shortstr(stream: BinaryIO) -> str:
    n = read_octet(stream)
    return _read_exact(stream, n).decode("utf-8")


def read_longstr_bytes(stream: BinaryIO) -> bytes:
    n = read_long(stream)
    return _read_exact(stream, n)


def read_table(stream: BinaryIO) -> dict[str, Any]:
    """Read a length-prefixed field table."""
    size = read_long(stream)
    payload = BytesIO(_read_exact(stream, size))
    table: dict[str, Any] = {}
    while payload.tell() < size:
        key = read_shortstr(payload)
        table[key] = read_field_value(payload)
    return table


def read_array(stream: BinaryIO) -> list[Any]:
    size = read_long(stream)
    payload = BytesIO(_read_exact(stream, size))
    out: list[Any] = []
    while payload.tell() < size:
        out.append(read_field_value(payload))
    return out


def read_field_value(stream: BinaryIO) -> Any:
    tag = _read_exact(stream, 1)
    if tag == b"S":
        return read_longstr_bytes(stream).decode("utf-8", errors="surrogateescape")
    if tag == b"I":
        return struct.unpack(">i", _read_exact(stream, 4))[0]
    if tag == b"D":
        scale = read_octet(stream)
        value = struct.unpack(">i", _read_exact(stream, 4))[0]
        return decimal.Decimal(value).scaleb(-scale)
    if tag == b"T":
        return Timestamp(read_longlong(stream))
    if tag == b"F":
        return read_table(stream)
    if tag == b"A":
        return read_array(stream)
    if tag == b"b":
        return struct.unpack(">b", _read_exact(stream, 1))[0]
    if tag == b"d":
        return struct.unpack(">d", _read_exact(stream, 8))[0]
    if tag == b"f":
        return struct.unpack(">f", _read_exact(stream, 4))[0]
    if tag == b"l":
        return struct.unpack(">q", _read_exact(stream, 8))[0]
    if tag == b"s":
        return struct.unpack(">h", _read_exact(stream, 2))[0]
    if tag == b"t":
        return read_octet(stream) != 0
    if tag == b"x":
        return read_longstr_bytes(stream)
    if tag == b"V":
        return None
    raise CodecError(f"unknown field-value tag: {tag!r}")


# ---------------------------------------------------------------------------
# primitive writers
# ---------------------------------------------------------------------------


def write_octet(out: BinaryIO, value: int) -> None:
    out.write(bytes((value & 0xFF,)))


def write_short(out: BinaryIO, value: int) -> None:
    out.write(struct.pack(">H", value & 0xFFFF))


def write_long(out: BinaryIO, value: int) -> None:
    out.write(struct.pack(">I", value & 0xFFFFFFFF))


def write_longlong(out: BinaryIO, value: int) -> None:
    out.write(struct.pack(">Q", value & 0xFFFFFFFFFFFFFFFF))


def write_shortstr(out: BinaryIO, value: str | None) -> None:
    data = (value or "").encode("utf-8")
    if len(data) > 255:
        raise CodecError(f"shortstr too long: {len(data)} bytes")
    write_octet(out, len(data))
    out.write(data)


def write_longstr(out: BinaryIO, value: str | bytes | None) -> None:
    if value is None:
        value = b""
    # surrogateescape mirrors the read side so a non-UTF-8 longstr received
    # from a peer can be re-encoded verbatim when forwarding.
    data = (
        value.encode("utf-8", errors="surrogateescape")
        if isinstance(value, str)
        else bytes(value)
    )
    write_long(out, len(data))
    out.write(data)


def write_table(out: BinaryIO, table: dict[str, Any] | None) -> None:
    payload = BytesIO()
    for key, value in (table or {}).items():
        write_shortstr(payload, key)
        write_field_value(payload, value)
    data = payload.getvalue()
    write_long(out, len(data))
    out.write(data)


def write_array(out: BinaryIO, values: list[Any]) -> None:
    payload = BytesIO()
    for value in values:
        write_field_value(payload, value)
    data = payload.getvalue()
    write_long(out, len(data))
    out.write(data)


def write_field_value(out: BinaryIO, value: Any) -> None:
    if value is None:
        out.write(b"V")
    elif isinstance(value, bool):
        out.write(b"t")
        write_octet(out, 1 if value else 0)
    elif isinstance(value, Timestamp):
        out.write(b"T")
        write_longlong(out, int(value))
    elif isinstance(value, int):
        if -(1 << 31) <= value < (1 << 31):
            out.write(b"I")
            out.write(struct.pack(">i", value))
        else:
            out.write(b"l")
            out.write(struct.pack(">q", value))
    elif isinstance(value, float):
        out.write(b"d")
        out.write(struct.pack(">d", value))
    elif isinstance(value, str):
        out.write(b"S")
        write_longstr(out, value)
    elif isinstance(value, (bytes, bytearray, memoryview)):
        out.write(b"x")
        write_longstr(out, bytes(value))
    elif isinstance(value, decimal.Decimal):
        out.write(b"D")
        # AMQP decimal = scale octet + int32, decoded as int_val * 10^-scale.
        # A positive decimal exponent (e.g. 1E+2) needs scale 0, not a negative
        # scale, so the value is expanded to an integer instead.
        scale = max(0, -value.as_tuple().exponent)
        write_octet(out, scale)
        out.write(struct.pack(">i", int(value.scaleb(scale))))
    elif isinstance(value, _dt.datetime):
        out.write(b"T")
        write_longlong(out, int(value.timestamp()))
    elif isinstance(value, dict):
        out.write(b"F")
        write_table(out, value)
    elif isinstance(value, (list, tuple)):
        out.write(b"A")
        write_array(out, list(value))
    else:
        raise CodecError(f"cannot encode field value of type {type(value).__name__}")


def encode_table(table: dict[str, Any] | None) -> bytes:
    out = BytesIO()
    write_table(out, table)
    return out.getvalue()


def decode_table(data: bytes) -> dict[str, Any]:
    return read_table(BytesIO(data))
