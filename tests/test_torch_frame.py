"""Frame model + incremental parser tests (golden bytes from the 0-9-1 spec).

The port's copy of ``tests/test_frame.py``: imports point at
``chanamq_tpu_torch``; the assertions are the reference's.
"""

import pytest

from chanamq_tpu_torch.amqp.constants import ErrorCode, FrameType, PROTOCOL_HEADER
from chanamq_tpu_torch.amqp.frame import (
    Frame,
    FrameError,
    FrameParser,
    HEARTBEAT_BYTES,
    HEARTBEAT_FRAME,
)


def test_protocol_header_bytes():
    assert PROTOCOL_HEADER == b"AMQP\x00\x00\x09\x01"


def test_heartbeat_frame_golden_bytes():
    # type=8, channel=0, size=0, end=0xCE
    assert HEARTBEAT_BYTES == b"\x08\x00\x00\x00\x00\x00\x00\xce"


def test_frame_roundtrip():
    f = Frame(FrameType.METHOD, 7, b"\x00\x0a\x00\x0a payload")
    raw = f.to_bytes()
    parser = FrameParser()
    out = list(parser.feed(raw))
    assert out == [f]


def test_parser_handles_arbitrary_chunking():
    frames = [
        Frame(FrameType.METHOD, 1, b"abc"),
        HEARTBEAT_FRAME,
        Frame(FrameType.BODY, 2, bytes(range(100))),
    ]
    raw = b"".join(f.to_bytes() for f in frames)
    for chunk_size in (1, 2, 3, 7, 8, 9, len(raw)):
        parser = FrameParser()
        out = []
        for i in range(0, len(raw), chunk_size):
            out.extend(parser.feed(raw[i : i + chunk_size]))
        assert out == frames, f"chunk_size={chunk_size}"


def test_parser_rejects_bad_end_octet():
    raw = bytearray(Frame(FrameType.METHOD, 0, b"xy").to_bytes())
    raw[-1] = 0x00
    out = list(FrameParser().feed(bytes(raw)))
    assert len(out) == 1
    assert isinstance(out[0], FrameError)
    assert out[0].code == ErrorCode.FRAME_ERROR


def test_parser_rejects_unknown_frame_type():
    raw = Frame(9, 0, b"").to_bytes()
    out = list(FrameParser().feed(raw))
    assert isinstance(out[0], FrameError)


def test_parser_enforces_frame_max():
    parser = FrameParser(frame_max=16)
    raw = Frame(FrameType.BODY, 1, b"x" * 64).to_bytes()
    out = list(parser.feed(raw))
    assert isinstance(out[0], FrameError)
    assert out[0].code == ErrorCode.FRAME_ERROR
    # dead parser consumes nothing further
    assert list(parser.feed(HEARTBEAT_BYTES)) == []


def test_parser_stops_after_error():
    raw = bytearray(Frame(FrameType.METHOD, 0, b"a").to_bytes())
    raw[-1] = 0x13
    parser = FrameParser()
    assert isinstance(list(parser.feed(bytes(raw)))[0], FrameError)
    assert list(parser.feed(HEARTBEAT_BYTES)) == []
