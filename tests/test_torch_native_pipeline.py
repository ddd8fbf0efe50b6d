"""Native fused ingress->egress pipeline parity.

The native pipeline must be invisible on the wire: chana_encode_deliveries
output is byte-identical to the pure-Python Frame rendering for every body
size (empty, straddling frame-max splits) and header permutation, the pool
exhaustion path falls back to heap encode with identical bytes, and
chana_scan_publish marks exactly the complete Basic.Publish triples the
fused fast path may consume.  A CHANAMQ_NATIVE=0 twin run of a confirm +
consume scenario asserts identical confirm/delivery ordering end to end.

The port's copy of ``tests/test_native_pipeline.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU; the assertions
are the reference's.
The library is the port's own build of ``native/chanamq_native.cpp``
(``chanamq_tpu_torch/_build/``).
"""

import ctypes
import os
import random
import subprocess
import sys

import pytest

from chanamq_tpu_torch import native_ext
from chanamq_tpu_torch.amqp.frame import Frame, deliveries_wire_size, encode_deliveries
from chanamq_tpu_torch.amqp.properties import BasicProperties

pytestmark = pytest.mark.skipif(
    not native_ext.pipeline_available(),
    reason="native pipeline unavailable")


def shortstr(s: bytes) -> bytes:
    return bytes([len(s)]) + s


def make_record(rng: random.Random, body: bytes, props: BasicProperties,
                channel: int | None = None) -> tuple:
    """One (channel_id, prefix, tag, redelivered, exrk, header, body)
    delivery record with randomized identifiers."""
    ctag = b"ctag-" + str(rng.randrange(10 ** 6)).encode()
    prefix = b"\x00\x3c\x00\x3c" + shortstr(ctag)
    exrk = shortstr(b"amq.topic") + shortstr(
        b"rk." + str(rng.randrange(1000)).encode())
    return (
        channel if channel is not None else rng.randrange(1, 2048),
        prefix,
        rng.randrange(1, 2 ** 63),
        rng.random() < 0.5,
        exrk,
        props.encode_header(len(body)),
        body,
    )


def reference_wire(records: list, frame_max: int) -> bytes:
    """Third, independent rendering built frame-by-frame from Frame()."""
    maxp = frame_max - 8 if frame_max else 0
    out = []
    for cid, prefix, tag, red, exrk, header, body in records:
        method = (prefix + tag.to_bytes(8, "big")
                  + (b"\x01" if red else b"\x00") + exrk)
        out.append(Frame.method(cid, method).to_bytes())
        out.append(Frame.header(cid, header).to_bytes())
        if body:
            step = maxp if frame_max else len(body)
            for off in range(0, len(body), step):
                out.append(Frame.body(cid, body[off:off + step]).to_bytes())
    return b"".join(out)


HEADER_PERMUTATIONS = [
    BasicProperties(),
    BasicProperties(delivery_mode=2),
    BasicProperties(content_type="application/json", delivery_mode=1),
    BasicProperties(priority=7, correlation_id="c" * 40, reply_to="amq.rpc"),
    BasicProperties(expiration="60000", message_id="m-1",
                    timestamp=1_700_000_000, type="event"),
    BasicProperties(user_id="guest", app_id="bench",
                    headers={"x-key": "value", "n": 42}),
]


def fresh_encoder(pool_buffers: int = 4,
                  pool_buffer_bytes: int = 64 * 1024):
    return native_ext.NativeEgressEncoder(pool_buffers, pool_buffer_bytes)


def encode_native(enc, records: list, frame_max: int) -> bytes:
    nbytes = deliveries_wire_size(records, frame_max)
    res = enc.encode(records, frame_max, nbytes)
    assert res is not None, "native encode disagreed with wire-size"
    buf, slot = res
    data = bytes(buf)
    if slot >= 0:
        enc.release(slot)
    return data


# ---------------------------------------------------------------------------
# batch egress encode parity
# ---------------------------------------------------------------------------


def test_encode_deliveries_parity_fuzz():
    """Random batches: native == pure-Python == frame-by-frame reference,
    byte for byte, across body sizes straddling every split boundary."""
    rng = random.Random(0xC0FFEE)
    enc = fresh_encoder()
    for frame_max in (0, 64, 4096, 131072):
        maxp = frame_max - 8 if frame_max else 0
        boundary_sizes = [0, 1, 17]
        if frame_max:
            boundary_sizes += [maxp - 1, maxp, maxp + 1,
                               2 * maxp, 3 * maxp + 7]
        for trial in range(8):
            records = []
            for size in boundary_sizes:
                body = bytes(rng.randrange(256) for _ in range(size))
                records.append(make_record(
                    rng, body, rng.choice(HEADER_PERMUTATIONS)))
            rng.shuffle(records)
            expected = encode_deliveries(records, frame_max)
            assert expected == reference_wire(records, frame_max)
            assert len(expected) == deliveries_wire_size(records, frame_max)
            assert encode_native(enc, records, frame_max) == expected


def test_encode_header_permutations_single_record():
    rng = random.Random(7)
    enc = fresh_encoder()
    for props in HEADER_PERMUTATIONS:
        records = [make_record(rng, b"payload", props, channel=3)]
        expected = reference_wire(records, 4096)
        assert encode_deliveries(records, 4096) == expected
        assert encode_native(enc, records, 4096) == expected


def test_encode_empty_batch_and_empty_bodies():
    rng = random.Random(11)
    enc = fresh_encoder()
    records = [make_record(rng, b"", BasicProperties()) for _ in range(5)]
    expected = encode_deliveries(records, 4096)
    assert encode_native(enc, records, 4096) == expected
    # no body frames at all: wire is exactly method+header pairs
    assert expected.count(b"\xce") >= 10


def test_encode_memoryview_fields():
    """Cluster/stream paths hand memoryview headers and bodies — the
    native encoder must accept them with identical output."""
    rng = random.Random(13)
    enc = fresh_encoder()
    base = make_record(rng, b"x" * 5000, BasicProperties(delivery_mode=2))
    cid, prefix, tag, red, exrk, header, body = base
    mv_record = (cid, prefix, tag, red, exrk,
                 memoryview(bytes(header)), memoryview(bytes(body)))
    for frame_max in (0, 4096):
        expected = encode_deliveries([base], frame_max)
        assert encode_native(enc, [mv_record], frame_max) == expected


def test_pool_exhaustion_heap_fallback_is_byte_identical():
    """With every arena slot held, encode lands in a fresh bytearray
    (slot -1) with the same bytes; released slots are reused."""
    enc = fresh_encoder(pool_buffers=2, pool_buffer_bytes=16 * 1024)
    rng = random.Random(17)
    records = [make_record(rng, b"b" * 512, BasicProperties())
               for _ in range(4)]
    nbytes = deliveries_wire_size(records, 4096)
    expected = encode_deliveries(records, 4096)

    buf1, slot1 = enc.encode(records, 4096, nbytes)
    buf2, slot2 = enc.encode(records, 4096, nbytes)
    assert slot1 >= 0 and slot2 >= 0 and slot1 != slot2
    assert bytes(buf1) == bytes(buf2) == expected
    # pool dry: heap fallback, still byte-identical
    buf3, slot3 = enc.encode(records, 4096, nbytes)
    assert slot3 == -1 and isinstance(buf3, bytearray)
    assert bytes(buf3) == expected
    enc.release(slot1)
    enc.release(slot2)
    buf4, slot4 = enc.encode(records, 4096, nbytes)
    assert slot4 >= 0
    assert bytes(buf4) == expected
    enc.release(slot4)


def test_oversized_batch_skips_pool():
    """A batch larger than one arena buffer must heap-encode, not
    truncate."""
    enc = fresh_encoder(pool_buffers=2, pool_buffer_bytes=4 * 1024)
    rng = random.Random(19)
    records = [make_record(rng, b"z" * 9000, BasicProperties())]
    nbytes = deliveries_wire_size(records, 4096)
    buf, slot = enc.encode(records, 4096, nbytes)
    assert slot == -1
    assert bytes(buf) == encode_deliveries(records, 4096)


# ---------------------------------------------------------------------------
# fused publish scan marks
# ---------------------------------------------------------------------------


def publish_frames(channel: int, exchange: bytes, rk: bytes, body: bytes,
                   *, frame_max: int = 0, bits: int = 0) -> bytes:
    """Hand-assembled Basic.Publish method+header+body wire bytes."""
    method = (b"\x00\x3c\x00\x28\x00\x00"
              + shortstr(exchange) + shortstr(rk) + bytes([bits]))
    header = BasicProperties().encode_header(len(body))
    wire = (Frame.method(channel, method).to_bytes()
            + Frame.header(channel, header).to_bytes())
    if body:
        step = frame_max - 8 if frame_max else len(body)
        for off in range(0, len(body), step):
            wire += Frame.body(channel, body[off:off + step]).to_bytes()
    return wire


def scan_marks(wire: bytes):
    parser = native_ext.NativeFrameParser(frame_max=0)
    batches = list(parser.scan_batches(wire))
    assert len(batches) == 1
    raw, n, types, channels, offsets, lengths, pub_mark, body_off, body_len \
        = batches[0]
    return raw, n, list(pub_mark[:n]), list(body_off[:n]), list(body_len[:n])


def test_scan_publish_marks_single_body_triple():
    body = b"hello fused world"
    wire = publish_frames(5, b"", b"q1", body)
    raw, n, marks, boffs, blens = scan_marks(wire)
    assert n == 3
    assert marks == [3, 0, 0]
    assert raw[boffs[0]:boffs[0] + blens[0]] == body


def test_scan_publish_marks_empty_body():
    wire = publish_frames(2, b"amq.topic", b"a.b", b"")
    raw, n, marks, _boffs, _blens = scan_marks(wire)
    assert n == 2
    assert marks == [2, 0]


def test_scan_publish_no_mark_with_mandatory_bit():
    # mandatory/immediate publishes take the slow path (they need the
    # full decode for basic.return handling)
    wire = publish_frames(1, b"", b"q", b"x", bits=1)
    _raw, n, marks, _o, _l = scan_marks(wire)
    assert n == 3
    assert marks == [0, 0, 0]


def test_scan_publish_no_mark_for_multiframe_body():
    body = b"m" * 300
    wire = publish_frames(1, b"", b"q", body, frame_max=136)  # 128B chunks
    _raw, n, marks, _o, _l = scan_marks(wire)
    assert n == 2 + 3  # method + header + 3 body chunks
    assert marks == [0] * n


def test_scan_publish_back_to_back_triples():
    wire = (publish_frames(1, b"", b"qa", b"one")
            + publish_frames(7, b"amq.direct", b"k", b"")
            + publish_frames(1, b"", b"qb", b"three"))
    raw, n, marks, boffs, blens = scan_marks(wire)
    assert n == 8
    assert marks == [3, 0, 0, 2, 0, 3, 0, 0]
    assert raw[boffs[0]:boffs[0] + blens[0]] == b"one"
    assert raw[boffs[5]:boffs[5] + blens[5]] == b"three"


def test_scan_publish_mark_requires_complete_triple():
    """A publish whose body frame has not arrived yet must NOT be marked
    (the fused path would read past the scanned window)."""
    wire = publish_frames(1, b"", b"q", b"tail-cut")
    # cut mid body frame: scanner sees method+header complete, body partial
    cut = wire[:len(wire) - 4]
    parser = native_ext.NativeFrameParser(frame_max=0)
    out = list(parser.scan_batches(cut))
    assert len(out) == 1
    _raw, n, _t, _c, _o, _l, marks, _bo, _bl = out[0]
    assert n == 2
    assert list(marks[:n]) == [0, 0]


# ---------------------------------------------------------------------------
# CHANAMQ_NATIVE=0 twin: identical confirm/delivery ordering end to end
# ---------------------------------------------------------------------------


TWIN_SCRIPT = r"""
import asyncio, os, sys
sys.path.insert(0, {repo!r})
from chanamq_tpu_torch.amqp.properties import BasicProperties
from chanamq_tpu_torch.broker.broker import Broker
from chanamq_tpu_torch.broker.server import BrokerServer
from chanamq_tpu_torch.client import AMQPClient

async def main():
    srv = BrokerServer(broker=Broker(router_device="cpu"),
                       host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.queue_declare("twin_q")
    await ch.confirm_select()
    confirms = []
    deliveries = []
    done = asyncio.Event()
    N = 40
    def cb(msg):
        deliveries.append((msg.delivery_tag, bytes(msg.body)[:16],
                           len(msg.body)))
        if len(deliveries) == N:
            done.set()
    await ch.basic_consume("twin_q", cb, no_ack=True)
    # mixed sizes: empty, small, multi-frame (> frame_max)
    sizes = [0, 1, 17, 1024, 200000, 5, 131064, 131065, 64, 0]
    for i in range(N):
        body = bytes([i % 251]) * sizes[i % len(sizes)]
        await ch.basic_publish_confirmed(
            body, routing_key="twin_q",
            properties=BasicProperties(message_id=str(i)))
        confirms.append(i)
    await asyncio.wait_for(done.wait(), 20)
    for tag, head, blen in deliveries:
        print("D", tag, head.hex(), blen)
    print("C", ",".join(map(str, confirms)))
    await c.close()
    await srv.stop()

asyncio.run(main())
"""


def test_native_vs_python_twin_ordering(tmp_path):
    script = tmp_path / "twin.py"
    script.write_text(TWIN_SCRIPT.format(
        repo=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    outputs = {}
    for native in ("1", "0"):
        env = dict(os.environ, CHANAMQ_NATIVE=native, JAX_PLATFORMS="cpu")
        proc = subprocess.run(
            [sys.executable, str(script)], env=env,
            capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outputs[native] = proc.stdout
    assert outputs["1"] == outputs["0"]
    assert outputs["1"].count("\nC ") or outputs["1"].startswith("C ") or \
        "C " in outputs["1"]
