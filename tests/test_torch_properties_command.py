"""BasicProperties presence-flag codec + AMQCommand render/assemble tests.

The port's copy of ``tests/test_properties_command.py``: imports point
at ``chanamq_tpu_torch``; the assertions are the reference's.
"""

import pytest

from chanamq_tpu_torch.amqp.command import AMQCommand, CommandAssembler
from chanamq_tpu_torch.amqp.constants import ErrorCode, FrameType
from chanamq_tpu_torch.amqp.frame import Frame, FrameError, FrameParser
from chanamq_tpu_torch.amqp import methods as m
from chanamq_tpu_torch.amqp.properties import BasicProperties


def test_empty_properties_golden():
    props = BasicProperties()
    payload = props.encode_header(0)
    # class 60, weight 0, size 0, flags 0
    assert payload == b"\x00\x3c\x00\x00" + b"\x00" * 8 + b"\x00\x00"


def test_properties_roundtrip_full():
    props = BasicProperties(
        content_type="application/json",
        content_encoding="utf-8",
        headers={"x-key": "val", "n": 3},
        delivery_mode=2,
        priority=5,
        correlation_id="corr-1",
        reply_to="reply.q",
        expiration="60000",
        message_id="msg-42",
        timestamp=1700000000,
        type="event",
        user_id="guest",
        app_id="test-app",
        cluster_id="c1",
    )
    payload = props.encode_header(1234)
    class_id, body_size, dec = BasicProperties.decode_header(payload)
    assert class_id == 60
    assert body_size == 1234
    assert dec == props
    assert dec.is_persistent
    assert dec.expiration_ms() == 60000


def test_properties_partial_roundtrip():
    props = BasicProperties(delivery_mode=1, expiration="100")
    _, _, dec = BasicProperties.decode_header(props.encode_header(0))
    assert dec.delivery_mode == 1
    assert dec.expiration == "100"
    assert dec.content_type is None
    assert not dec.is_persistent


def assemble_all(frames):
    asm = CommandAssembler()
    out = []
    for f in frames:
        out.extend(asm.feed(f))
    return out


def test_command_no_content_roundtrip():
    cmd = AMQCommand(5, m.Queue.Purge(queue="q"))
    frames = cmd.render_frames(4096)
    assert len(frames) == 1
    out = assemble_all(frames)
    assert out == [cmd]


def test_command_with_content_roundtrip():
    body = b"x" * 10
    cmd = AMQCommand(
        3,
        m.Basic.Publish(exchange="e", routing_key="k"),
        BasicProperties(delivery_mode=2),
        body,
    )
    out = assemble_all(cmd.render_frames(4096))
    assert len(out) == 1
    got = out[0]
    assert got.method == cmd.method
    assert got.body == body
    assert got.properties.delivery_mode == 2


def test_body_fragmentation_by_frame_max():
    body = bytes(range(256)) * 10  # 2560 bytes
    frame_max = 128  # payload max = 120
    cmd = AMQCommand(1, m.Basic.Publish(exchange="e"), BasicProperties(), body)
    frames = cmd.render_frames(frame_max)
    body_frames = [f for f in frames if f.type == FrameType.BODY]
    assert all(len(f.payload) <= frame_max - 8 for f in body_frames)
    assert b"".join(f.payload for f in body_frames) == body
    # wire roundtrip through the parser too
    parser = FrameParser(frame_max=frame_max)
    reparsed = list(parser.feed(cmd.render(frame_max)))
    out = assemble_all(reparsed)
    assert out[0].body == body


def test_zero_length_body():
    cmd = AMQCommand(1, m.Basic.Publish(exchange="e"), BasicProperties(), b"")
    frames = cmd.render_frames(4096)
    assert [f.type for f in frames] == [FrameType.METHOD, FrameType.HEADER]
    out = assemble_all(frames)
    assert out[0].body == b""


def test_interleaved_channels():
    c1 = AMQCommand(1, m.Basic.Publish(exchange="a"), BasicProperties(), b"one")
    c2 = AMQCommand(2, m.Basic.Publish(exchange="b"), BasicProperties(), b"two")
    f1, f2 = c1.render_frames(4096), c2.render_frames(4096)
    # interleave: m1 m2 h1 h2 b1 b2
    frames = [f1[0], f2[0], f1[1], f2[1], f1[2], f2[2]]
    out = assemble_all(frames)
    assert {cmd.channel for cmd in out} == {1, 2}
    assert {cmd.body for cmd in out} == {b"one", b"two"}


def test_unexpected_header_frame_is_error():
    props = BasicProperties()
    out = assemble_all([Frame.header(1, props.encode_header(0))])
    assert isinstance(out[0], FrameError)
    assert out[0].code == ErrorCode.UNEXPECTED_FRAME


def test_method_while_content_pending_is_error():
    cmd = AMQCommand(1, m.Basic.Publish(exchange="e"), BasicProperties(), b"xy")
    frames = cmd.render_frames(4096)
    out = assemble_all([frames[0], Frame.method(1, m.Basic.Ack(delivery_tag=1).encode())])
    assert any(isinstance(o, FrameError) for o in out)


def test_body_overflow_is_error():
    method = Frame.method(1, m.Basic.Publish(exchange="e").encode())
    header = Frame.header(1, BasicProperties().encode_header(2))
    body = Frame.body(1, b"toolong")
    out = assemble_all([method, header, body])
    assert isinstance(out[-1], FrameError)
