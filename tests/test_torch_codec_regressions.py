"""Regression tests for codec defects found in review/verification.

The port's copy of ``tests/test_codec_regressions.py``: imports point at
``chanamq_tpu_torch``; the assertions are the reference's.
"""

import decimal

import pytest

from chanamq_tpu_torch.amqp import value_codec as vc
from chanamq_tpu_torch.amqp import methods as m
from chanamq_tpu_torch.amqp.command import AMQCommand
from chanamq_tpu_torch.amqp.frame import FrameError, FrameParser
from chanamq_tpu_torch.amqp.properties import BasicProperties


def test_decimal_positive_exponent_roundtrip():
    # 1E+2 must survive as 100, not be scaled down to 1
    out = vc.decode_table(vc.encode_table({"d": decimal.Decimal("1E+2")}))
    assert out["d"] == 100


def test_non_utf8_longstr_reencodes_verbatim():
    raw = b"\x00\x00\x00\x09\x01kS\x00\x00\x00\x02\xff\xfe"
    assert vc.encode_table(vc.decode_table(raw)) == raw


def test_methods_with_tables_are_hashable():
    assert isinstance(hash(m.Queue.Declare(arguments={"x": 1})), int)
    assert hash(m.Basic.Ack(delivery_tag=1)) != hash(m.Basic.Ack(delivery_tag=2))


def test_render_rejects_degenerate_frame_max():
    cmd = AMQCommand(1, m.Basic.Publish(exchange="e"), BasicProperties(), b"abc")
    for bad in (1, 7, 8):
        with pytest.raises(ValueError):
            cmd.render_frames(bad)


def test_parser_rejects_garbage_from_header_alone():
    # corrupt stream with a huge bogus size field must error immediately,
    # not buffer gigabytes waiting for it
    out = list(FrameParser().feed(b"\x41" * 12))
    assert isinstance(out[0], FrameError)


def test_parser_assembler_fuzz_no_crashes():
    """Seeded fuzz over both parsers + the assembler: random garbage,
    bit-flipped valid publishes, and truncations, fed in random chunkings.
    Every input must end in frames, silence, or FrameError — never an
    exception or a hang (the broker's read loop treats anything else as a
    crash)."""
    import random
    import struct

    from chanamq_tpu_torch.amqp.command import CommandAssembler
    from chanamq_tpu_torch.amqp.frame import FrameError, FrameParser
    from chanamq_tpu_torch import native_ext

    rng = random.Random(0xC0DEC)

    def valid_publish(ch):
        m = b"\x00\x3c\x00\x28\x00\x00\x00\x05qq\x00"
        h = struct.pack(">HHQH", 60, 0, 4, 0x1000) + b"\x01"
        b = b"abcd"
        out = b""
        for t, p in ((1, m), (2, h), (3, b)):
            out += struct.pack(">BHI", t, ch, len(p)) + p + b"\xce"
        return out

    parser_classes = [FrameParser]
    if native_ext.available():
        parser_classes.append(native_ext.NativeFrameParser)
    for trial in range(600):
        kind = rng.randrange(3)
        if kind == 0:
            data = bytes(rng.randrange(256)
                         for _ in range(rng.randrange(1, 400)))
        elif kind == 1:
            base = bytearray(
                valid_publish(rng.randrange(1, 4)) * rng.randrange(1, 4))
            for _ in range(rng.randrange(1, 6)):
                base[rng.randrange(len(base))] = rng.randrange(256)
            data = bytes(base)
        else:
            data = valid_publish(1)[:rng.randrange(1, 60)]
        for parser_cls in parser_classes:
            parser = parser_cls()
            parser.frame_max = 131072
            assembler = CommandAssembler()
            pos = 0
            dead = False
            while pos < len(data) and not dead:
                chunk = data[pos:pos + rng.randrange(1, 64)]
                pos += len(chunk)
                for item in parser.feed(chunk):
                    if isinstance(item, FrameError):
                        dead = True
                        break
                    if item.type in (1, 2, 3):
                        out = assembler.feed_one(item)
                        if isinstance(out, FrameError):
                            dead = True
                            break
