"""Native hot-path tests: C++ frame scanner + topic trie vs the Python
reference implementations (property/parity testing), plus a speed sanity
check. Skipped when the toolchain can't build the library.

The port's copy of ``tests/test_native.py``: imports point at
``chanamq_tpu_torch``; the assertions are the reference's.
The library is the port's own build of ``native/chanamq_native.cpp``
(``chanamq_tpu_torch/_build/``).
"""

import random

import pytest

from chanamq_tpu_torch import native_ext
from chanamq_tpu_torch.amqp.constants import FrameType
from chanamq_tpu_torch.amqp.frame import Frame, FrameError, FrameParser, HEARTBEAT_FRAME
from chanamq_tpu_torch.broker.matchers import TopicMatcher

pytestmark = pytest.mark.skipif(
    not native_ext.available(), reason="native library unavailable")


def make_frames(count, seed=0):
    rng = random.Random(seed)
    frames = []
    for _ in range(count):
        ftype = rng.choice([FrameType.METHOD, FrameType.HEADER, FrameType.BODY,
                            FrameType.HEARTBEAT])
        payload = b"" if ftype == FrameType.HEARTBEAT else rng.randbytes(rng.randint(0, 300))
        channel = 0 if ftype == FrameType.HEARTBEAT else rng.randint(0, 100)
        frames.append(Frame(ftype, channel, payload))
    return frames


def test_native_parser_parity_random_chunking():
    frames = make_frames(200, seed=7)
    raw = b"".join(f.to_bytes() for f in frames)
    rng = random.Random(1)
    native, python = native_ext.NativeFrameParser(), FrameParser()
    out_native, out_python = [], []
    i = 0
    while i < len(raw):
        n = rng.randint(1, 701)
        chunk = raw[i : i + n]
        out_native.extend(native.feed(chunk))
        out_python.extend(python.feed(chunk))
        i += n
    assert out_native == out_python == frames


def test_native_parser_error_parity():
    bad_end = bytearray(Frame(FrameType.METHOD, 1, b"xy").to_bytes())
    bad_end[-1] = 0x00
    out = list(native_ext.NativeFrameParser().feed(bytes(bad_end)))
    assert isinstance(out[0], FrameError)
    # garbage rejected from the header alone
    out = list(native_ext.NativeFrameParser().feed(b"\x41" * 12))
    assert isinstance(out[0], FrameError)
    # frame-max enforcement
    parser = native_ext.NativeFrameParser()
    parser.frame_max = 16
    out = list(parser.feed(Frame(FrameType.BODY, 1, b"x" * 64).to_bytes()))
    assert isinstance(out[0], FrameError)
    # dead after error
    assert list(parser.feed(HEARTBEAT_FRAME.to_bytes())) == []


def test_native_parser_frames_before_error_are_delivered():
    good = Frame(FrameType.METHOD, 1, b"ok").to_bytes()
    bad = bytearray(Frame(FrameType.METHOD, 1, b"no").to_bytes())
    bad[-1] = 0x13
    out = list(native_ext.NativeFrameParser().feed(good + bytes(bad)))
    assert out[0] == Frame(FrameType.METHOD, 1, b"ok")
    assert isinstance(out[1], FrameError)


def random_topic_ops(seed, n_ops=400):
    rng = random.Random(seed)
    words = ["a", "b", "c", "stock", "nyse", "*", "#"]
    ops = []
    live = []
    for _ in range(n_ops):
        if live and rng.random() < 0.3:
            ops.append(("unbind", *rng.choice(live)))
        else:
            pattern = ".".join(rng.choice(words) for _ in range(rng.randint(1, 4)))
            queue = f"q{rng.randint(0, 20)}"
            ops.append(("bind", pattern, queue))
            live.append((pattern, queue))
    return ops


def test_native_trie_parity_randomized():
    rng = random.Random(42)
    key_words = ["a", "b", "c", "stock", "nyse", "x"]
    for seed in range(5):
        native, python = native_ext.NativeTopicMatcher(), TopicMatcher()
        for op in random_topic_ops(seed):
            kind, pattern, queue = op
            if kind == "bind":
                assert native.bind(pattern, queue) == python.bind(pattern, queue)
            else:
                assert native.unbind(pattern, queue) == python.unbind(pattern, queue)
        for _ in range(200):
            key = ".".join(rng.choice(key_words)
                           for _ in range(rng.randint(1, 5)))
            assert native.route(key) == python.route(key), (seed, key)
        assert native.bindings() == python.bindings()


def test_native_trie_wildcards():
    m = native_ext.NativeTopicMatcher()
    m.bind("stock.*.nyse", "q1")
    m.bind("stock.#", "q2")
    m.bind("#", "q3")
    assert m.route("stock.ibm.nyse") == {"q1", "q2", "q3"}
    assert m.route("stock") == {"q2", "q3"}
    assert m.route("bond") == {"q3"}
    m.unbind_queue("q2")
    assert m.route("stock.ibm.nyse") == {"q1", "q3"}


def test_native_trie_unbind_prunes():
    m = native_ext.NativeTopicMatcher()
    m.bind("a.b.c", "q1")
    assert m.unbind("a.b.c", "q1")
    assert not m.unbind("a.b.c", "q1")
    assert m.route("a.b.c") == set()


def test_native_faster_than_python_parser():
    """Sanity check, not a benchmark: the native scanner should beat the
    Python loop on a large frame stream."""
    import time

    frames = make_frames(2000, seed=3)
    raw = b"".join(f.to_bytes() for f in frames)

    t0 = time.perf_counter()
    for _ in range(5):
        assert sum(1 for _ in FrameParser().feed(raw)) == 2000
    t_python = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(5):
        assert sum(1 for _ in native_ext.NativeFrameParser().feed(raw)) == 2000
    t_native = time.perf_counter() - t0
    # be generous (CI noise): just require it not be slower
    assert t_native < t_python * 1.1, (t_native, t_python)


def test_native_trie_route_grows_past_buffer():
    """The route result buffer starts at 4096; a fanout-wide topic binding
    set larger than that must return EVERY queue, not a truncated set
    (regression: silent truncation flagged in rounds 1-2)."""
    m = native_ext.NativeTopicMatcher()
    n = 5000
    for i in range(n):
        m.bind("wide.key", f"q{i}")
    out = m.route("wide.key")
    assert len(out) == n
    assert out == {f"q{i}" for i in range(n)}
