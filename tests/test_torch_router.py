"""The port's router (``chanamq_tpu_torch.router``) against the JAX
package's (``chanamq_tpu.router``), on the CPU.

The same seeded binding tables and keys go through both packages:

(a) the port's compiled tables equal the reference's array for array,
    with the same ``vocab`` and ``bit_names``;
(b) ``route_batch(backend="torch", device="cpu")`` gives the reference's
    ``"python"`` and ``"jax"`` destination sets;
(c) the reference's own numpy tables, uploaded by ``tables_from_numpy``,
    give the reference ``_topic_kernel(np, ...)`` / ``_headers_kernel(np,
    ...)`` rows word for word through the plain PyTorch versions;
(d) the router-engine behaviour runs on the port's broker.

Outputs are integer bitmasks and name sets: every comparison is exact.
"""

import random

import numpy as np
import pytest
import torch

from chanamq_tpu.broker import matchers as ref_matchers
from chanamq_tpu.router import compile as ref_compile
from chanamq_tpu_torch.amqp.properties import BasicProperties
from chanamq_tpu_torch.broker.broker import Broker
from chanamq_tpu_torch.broker.matchers import HeadersMatcher, TopicMatcher
from chanamq_tpu_torch.kernels import router_match as rm
from chanamq_tpu_torch.router import compile as port_compile
from chanamq_tpu_torch.router.engine import TensorRouter
from chanamq_tpu_torch.router.tables import tables_from_numpy

CPU = torch.device("cpu")
WORDS = ["a", "b", "c", "dd", "e1", "", "orders", "x"]


def _rand_pattern(rng):
    return ".".join(
        rng.choice(WORDS + ["*", "#"]) for _ in range(rng.randint(1, 6)))


def _rand_key(rng):
    return ".".join(rng.choice(WORDS) for _ in range(rng.randint(0, 6)))


def _topic_cases():
    """The bind/unbind/route sequences of test_router.py's topic fuzz
    (same seed), as (bindings, keys) with one matcher per package."""
    rng = random.Random(0xC0FFEE)
    for _ in range(150):
        ref, port = ref_matchers.TopicMatcher(), TopicMatcher()
        bound = []
        for _ in range(rng.randint(1, 30)):
            pattern, queue = _rand_pattern(rng), f"q{rng.randint(0, 9)}"
            ref.bind(pattern, queue)
            port.bind(pattern, queue)
            bound.append((pattern, queue))
        for _ in range(rng.randint(0, len(bound) // 2)):
            pattern, queue = rng.choice(bound)
            ref.unbind(pattern, queue)
            port.unbind(pattern, queue)
        keys = [_rand_key(rng) for _ in range(rng.randint(1, 40))]
        yield ref, port, keys


def _headers_cases():
    rng = random.Random(0xBEEF)
    values = [1, "s", True, 2.5, "t", 0, False]
    for _ in range(150):
        ref, port = ref_matchers.HeadersMatcher(), HeadersMatcher()
        for _ in range(rng.randint(1, 15)):
            args = {f"h{rng.randint(0, 4)}": rng.choice(values)
                    for _ in range(rng.randint(0, 3))}
            if rng.random() < 0.8:
                args["x-match"] = rng.choice(["all", "any"])
            queue = f"q{rng.randint(0, 6)}"
            ref.bind("", queue, dict(args))
            port.bind("", queue, dict(args))
        msgs = [{f"h{rng.randint(0, 5)}": rng.choice(values)
                 for _ in range(rng.randint(0, 4))} for _ in range(25)]
        yield ref, port, msgs


def _assert_same_tables(ref_ce, port_ce):
    assert ref_ce.kind == port_ce.kind
    assert ref_ce.exact == port_ce.exact
    assert ref_ce.always == port_ce.always
    assert ref_ce.bit_names == port_ce.bit_names
    for attr in ("wild", "headers"):
        rt, pt = getattr(ref_ce, attr), getattr(port_ce, attr)
        assert (rt is None) == (pt is None)
        if rt is None:
            continue
        assert rt.keys() == pt.keys()
        for k, v in rt.items():
            if isinstance(v, np.ndarray):
                assert v.dtype == pt[k].dtype and np.array_equal(v, pt[k]), k
            else:
                assert v == pt[k], k


def _route_everywhere(ref_ce, port_ce, items):
    """Reference python + jax, and the port's torch-on-CPU backend; the
    memos are cleared between backends so each computes afresh."""
    py = ref_compile.route_batch(ref_ce, items, "python")
    ref_ce._route_memo.clear()
    jx = ref_compile.route_batch(ref_ce, items, "jax")
    got = port_compile.route_batch(port_ce, items, "torch", CPU)
    assert [set(a) for a in py] == [set(b) for b in jx]
    assert [set(a) for a in got] == [set(a) for a in py]
    return got


# -- (a) + (b): compiled tables and routed sets --------------------------------


def test_topic_tables_and_routes_match_reference():
    compiled = 0
    for ref, port, keys in _topic_cases():
        assert ref.bindings() == port.bindings()
        try:
            ref_ce = ref_compile.compile_exchange("topic", ref.bindings())
        except ref_compile.Uncompilable as exc:
            with pytest.raises(port_compile.Uncompilable) as got:
                port_compile.compile_exchange("topic", port.bindings())
            assert got.value.reason == exc.reason
            continue
        port_ce = port_compile.compile_exchange("topic", port.bindings())
        _assert_same_tables(ref_ce, port_ce)
        items = [(k, None) for k in keys]
        got = _route_everywhere(ref_ce, port_ce, items)
        for key, names in zip(keys, got):
            assert set(names) == port.route(key)
        compiled += 1
    assert compiled > 50


def test_headers_tables_and_routes_match_reference():
    for ref, port, msgs in _headers_cases():
        assert ref.bindings() == port.bindings()
        ref_ce = ref_compile.compile_exchange("headers", ref.bindings())
        port_ce = port_compile.compile_exchange("headers", port.bindings())
        _assert_same_tables(ref_ce, port_ce)
        items = [("", h) for h in msgs]
        got = _route_everywhere(ref_ce, port_ce, items)
        for headers, names in zip(msgs, got):
            assert set(names) == port.route("", headers)


TOPIC_EDGES = [
    (["#"], ["", "a", "a.b.c"]),
    (["a.#"], ["a", "a.b", "a.b.c", "b.a", ""]),
    (["#.a"], ["a", "b.a", "a.a.a", "a.b"]),
    (["a.#.b"], ["a.b", "a.x.b", "a.x.y.b", "a", "b"]),
    (["*.#"], ["", "a", "a.b", "a.b.c"]),
    (["#.*"], ["", "a", "a.b"]),
    (["..#"], ["", ".", "..", "..a", ".a."]),
    (["#.b.*"], ["b.a", "x.b.a", "b.b.b", "b"]),
    (["a.*.c", "a.#"], ["a.b.c", "a.c", "a.b.c.d"]),
]


@pytest.mark.parametrize("patterns,keys", TOPIC_EDGES)
def test_topic_hash_edge_cases(patterns, keys):
    ref, port = ref_matchers.TopicMatcher(), TopicMatcher()
    for i, pattern in enumerate(patterns):
        ref.bind(pattern, f"q{i}")
        port.bind(pattern, f"q{i}")
    ref_ce = ref_compile.compile_exchange("topic", ref.bindings())
    port_ce = port_compile.compile_exchange("topic", port.bindings())
    _assert_same_tables(ref_ce, port_ce)
    got = _route_everywhere(ref_ce, port_ce, [(k, None) for k in keys])
    for key, names in zip(keys, got):
        assert set(names) == port.route(key), (patterns, key)


def test_headers_unhashable_binding_uncompilable():
    m = HeadersMatcher()
    m.bind("", "q0", {"x-match": "all", "h": [1, 2]})
    with pytest.raises(port_compile.Uncompilable):
        port_compile.compile_exchange("headers", m.bindings())


def test_headers_unhashable_message_value_skipped():
    ref, port = ref_matchers.HeadersMatcher(), HeadersMatcher()
    for m in (ref, port):
        m.bind("", "q0", {"x-match": "any", "h": 1, "g": 2})
    ref_ce = ref_compile.compile_exchange("headers", ref.bindings())
    port_ce = port_compile.compile_exchange("headers", port.bindings())
    headers = {"h": [1, 2], "g": 2}
    got = _route_everywhere(ref_ce, port_ce, [("", headers)])
    assert set(got[0]) == port.route("", headers) == {"q0"}


def test_direct_fanout_compile():
    d = port_compile.compile_exchange(
        "direct", [("k1", "a", None), ("k1", "b", None), ("k2", "c", None)])
    got = port_compile.route_batch(
        d, [("k1", None), ("k2", None), ("zzz", None)], "torch", CPU)
    assert [set(g) for g in got] == [{"a", "b"}, {"c"}, set()]
    f = port_compile.compile_exchange(
        "fanout", [("ignored", "a", None), ("", "b", None)])
    got = port_compile.route_batch(f, [("anything", None), ("", None)],
                                   "torch", CPU)
    assert [set(g) for g in got] == [{"a", "b"}, {"a", "b"}]


def test_multi_hash_uncompilable_and_caps():
    m = TopicMatcher()
    m.bind("a.#.b.#", "q0")
    with pytest.raises(port_compile.Uncompilable):
        port_compile.compile_exchange("topic", m.bindings())
    m2 = TopicMatcher()
    for i in range(5):
        m2.bind(f"w{i}.*", f"q{i}")
    with pytest.raises(port_compile.Uncompilable):
        port_compile.compile_exchange("topic", m2.bindings(), max_wildcards=3)
    with pytest.raises(port_compile.Uncompilable):
        port_compile.compile_exchange("topic", m2.bindings(), max_queues=2)
    ref, port = ref_matchers.TopicMatcher(), TopicMatcher()
    for m in (ref, port):
        for i in range(50):
            m.bind(f"exact.{i}", f"q{i}")
        m.bind("wild.*", "qw")
    ref_ce = ref_compile.compile_exchange("topic", ref.bindings(),
                                          max_wildcards=1)
    port_ce = port_compile.compile_exchange("topic", port.bindings(),
                                            max_wildcards=1)
    _assert_same_tables(ref_ce, port_ce)
    got = _route_everywhere(
        ref_ce, port_ce, [("exact.7", None), ("wild.x", None), ("nope", None)])
    assert [set(g) for g in got] == [{"q7"}, {"qw"}, set()]


def test_unknown_backend_raises():
    ce = port_compile.compile_exchange("topic", [("a.*", "q", None)])
    with pytest.raises(ValueError):
        port_compile.route_batch(ce, [("a.b", None)], "jax")


def test_bit31_queue_decodes_and_terminates():
    """A queue at bit 31 of a word is a negative int32 on the device; the
    router views rows back to uint32 before _decode_mask, whose
    ``w & -w`` loop would never end on a negative Python int."""
    queues = [f"q{i:02d}" for i in range(64)]  # bits 0..63: W = 2
    bindings = [(f"k.{i}.*", q, None) for i, q in enumerate(queues)]
    bindings += [("all.#", q, None) for q in queues]
    ref_ce = ref_compile.compile_exchange("topic", bindings)
    port_ce = port_compile.compile_exchange("topic", bindings)
    _assert_same_tables(ref_ce, port_ce)
    assert port_ce.wild["mask_words"] == 2
    keys = ["k.31.x", "k.63.y", "k.0.z", "all", "all.x.y", "none"]
    got = _route_everywhere(ref_ce, port_ce, [(k, None) for k in keys])
    assert [set(g) for g in got] == [
        {"q31"}, {"q63"}, {"q00"}, set(queues), set(queues), set()]


def test_headers_rows_are_reference_bytes():
    """The headers memo is keyed by the row's bytes: the port's host rows
    must be the reference's uint32 rows byte for byte."""
    ref, port = ref_matchers.HeadersMatcher(), HeadersMatcher()
    for i in range(40):
        args = {"x-match": "any", "h": i}
        ref.bind("", f"q{i:02d}", dict(args))
        port.bind("", f"q{i:02d}", dict(args))
    ref_ce = ref_compile.compile_exchange("headers", ref.bindings())
    port_ce = port_compile.compile_exchange("headers", port.bindings())
    items = [("", {"h": i}) for i in range(40)] + [("", {"h": 99})]
    ref_compile.route_batch(ref_ce, items, "python")
    port_compile.route_batch(port_ce, items, "torch", CPU)
    assert ref_ce._route_memo.keys() == port_ce._route_memo.keys()
    assert len(port_ce._route_memo) == 41


def test_device_tables_uploaded_once_per_snapshot(monkeypatch):
    ce = port_compile.compile_exchange("topic", [("a.*", "q", None)])
    calls = []
    real = port_compile.tables_from_numpy

    def spy(table, device):
        calls.append(device)
        return real(table, device)

    monkeypatch.setattr(port_compile, "tables_from_numpy", spy)
    for i in range(3):
        ce._route_memo.clear()
        port_compile.route_batch(ce, [(f"a.{i}", None)], "torch", CPU)
    assert calls == [CPU]


# -- (c) the reference's tables through tables_from_numpy ---------------------


def _topic_table_and_messages(seed, n_patterns, n_queues, n_keys):
    rng = random.Random(seed)
    vocab = [f"w{i}" for i in range(12)]
    bindings = []
    for i in range(n_patterns):
        toks = [rng.choice(vocab + ["*"]) for _ in range(rng.randint(1, 5))]
        if rng.random() < 0.5:
            toks.insert(rng.randint(0, len(toks)), "#")
        if "*" not in toks and "#" not in toks:
            toks[0] = "*"
        for _ in range(rng.randint(1, 3)):
            bindings.append((".".join(toks), f"q{rng.randrange(n_queues)}",
                             None))
    keys = [".".join(rng.choice(vocab + ["zz"])
                     for _ in range(rng.randint(0, 7)))
            for _ in range(n_keys)]
    return bindings, keys


@pytest.mark.parametrize("seed,n_patterns,n_queues,n_keys", [
    (1, 7, 5, 3), (2, 40, 100, 37), (3, 120, 300, 64)])
def test_topic_plain_version_matches_reference_kernel(
        seed, n_patterns, n_queues, n_keys):
    bindings, keys = _topic_table_and_messages(
        seed, n_patterns, n_queues, n_keys)
    ce = ref_compile.compile_exchange("topic", bindings)
    wild = ce.wild
    b = ref_compile._bucket(len(keys), 16)
    pre_m, suf_m, mlen = ref_compile._tokenize_topic(wild, keys, b)
    want = ref_compile._topic_kernel(
        np, wild["pre"], wild["suf"], wild["plen"], wild["slen"],
        wild["has_hash"], wild["masks"], pre_m, suf_m, mlen)
    t = tables_from_numpy(wild, CPU)
    assert t.masks.dtype == torch.int32
    # the row-major tables are the compiled ones; the transposes beside them
    assert np.array_equal(t.pre.numpy(), wild["pre"])
    assert np.array_equal(t.suf.numpy(), wild["suf"])
    assert torch.equal(t.pre_t, t.pre.t()) and t.pre_t.is_contiguous()
    assert torch.equal(t.suf_t, t.suf.t()) and t.suf_t.is_contiguous()
    got = rm.topic_match_ref(
        t, torch.from_numpy(pre_m), torch.from_numpy(suf_m),
        torch.from_numpy(mlen))
    rows = got.numpy().view(np.uint32)
    assert rows.dtype == want.dtype and rows.shape == want.shape
    assert np.array_equal(rows, want)
    # the wrapper takes the plain version for CPU tensors, and counts no
    # launch for it
    before = rm.topic_match.launches
    again = rm.topic_match(
        t, torch.from_numpy(pre_m), torch.from_numpy(suf_m),
        torch.from_numpy(mlen))
    assert torch.equal(again, got) and rm.topic_match.launches == before


@pytest.mark.parametrize("seed,n_bindings,n_msgs", [
    (1, 5, 3), (2, 70, 40), (3, 200, 64)])
def test_headers_plain_version_matches_reference_kernel(
        seed, n_bindings, n_msgs):
    rng = random.Random(seed)
    bindings = []
    for i in range(n_bindings):
        args = {f"h{rng.randrange(6)}": rng.randrange(4)
                for _ in range(rng.randint(1, 4))}
        args["x-match"] = rng.choice(["all", "any"])
        bindings.append(("", f"q{i}", args))
    msgs = [{f"h{rng.randrange(7)}": rng.randrange(5)
             for _ in range(rng.randint(0, 6))} for _ in range(n_msgs)]
    ce = ref_compile.compile_exchange("headers", bindings)
    table = ce.headers
    b = ref_compile._bucket(n_msgs, 16)
    pids = ref_compile._tokenize_headers(table, msgs, b)
    want = ref_compile._headers_kernel(
        np, table["req"], table["rcount"], table["is_all"], table["masks"],
        pids)
    t = tables_from_numpy(table, CPU)
    assert np.array_equal(t.req.numpy(), table["req"])
    assert torch.equal(t.req_t, t.req.t()) and t.req_t.is_contiguous()
    # the pair ids are dense: the table holds every id of its vocabulary
    assert t.vocab == len(table["vocab"])
    got = rm.headers_match(t, torch.from_numpy(pids))
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_plain_version_bit31_rows():
    """Masks with bit 31 set in several words (W > 1) survive the int32
    round trip through the plain version exactly."""
    masks = np.zeros((4, 3), np.uint32)
    masks[0, 0] = 1 << 31
    masks[1, 1] = (1 << 31) | 1
    masks[2, 2] = 0xFFFFFFFF
    table = {"req": np.array([[0, -2], [1, -2], [0, 1], [-2, -2]], np.int32),
             "rcount": np.array([1, 1, 2, 0], np.int32),
             "is_all": np.array([True, False, True, False]),
             "masks": masks}
    pids = np.array([[0, 1], [1, -3], [-3, -3]], np.int32)
    want = ref_compile._headers_kernel(
        np, table["req"], table["rcount"], table["is_all"], masks, pids)
    t = tables_from_numpy(table, CPU)
    got = rm.headers_match_ref(t, torch.from_numpy(pids))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert want[0].tolist() == [1 << 31, (1 << 31) | 1, 0xFFFFFFFF]


def test_wrapper_refuses_other_devices():
    t = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    v = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        rm.headers_match(rm.HeadersTable(t, v, v.bool(), t, t, 1), t)
    with pytest.raises(ValueError):
        rm.topic_match(rm.TopicTable(t, t, v, v, v.bool(), t, t, t), t, t,
                       v)


def test_tables_are_checked_once_at_upload():
    """A table's tensors are checked when it is built, not on every call:
    a wrong dtype or shape, a token table wider than the kernel's 32
    cells, or a pair id that is neither PAD nor in [0, MAX_IDS) raises."""
    i32 = torch.int32
    pre = torch.zeros((4, 2), dtype=i32)
    v = torch.zeros(4, dtype=i32)
    masks = torch.zeros((4, 3), dtype=i32)
    got = rm.topic_table(pre, pre, v, v, v.bool(), masks)
    assert got.pre_t.shape == (2, 4)
    with pytest.raises(TypeError):
        rm.topic_table(pre.long(), pre, v, v, v.bool(), masks)
    with pytest.raises(ValueError):
        rm.topic_table(pre, pre, v[:3], v, v.bool(), masks)
    wide = torch.zeros((4, rm.MAX_TOKENS + 1), dtype=i32)
    with pytest.raises(ValueError):
        rm.topic_table(wide, pre, v, v, v.bool(), masks)
    req = torch.tensor([[0, 5], [rm.PAD, 2], [rm.PAD, rm.PAD], [1, rm.PAD]],
                       dtype=i32)
    assert rm.headers_table(req, v, v.bool(), masks).vocab == 6
    empty = torch.full((4, 2), rm.PAD, dtype=i32)
    assert rm.headers_table(empty, v, v.bool(), masks).vocab == 1
    for bad in (-1, -3, rm.MAX_IDS):
        with pytest.raises(ValueError):
            rm.headers_table(torch.where(req == 5, bad, req), v, v.bool(),
                             masks)


# -- (d) the engine on the port's broker --------------------------------------


def _mk_broker_with_topic(loop, **router):
    broker = Broker(router_device="cpu", **router)
    loop.run_until_complete(broker.create_vhost("/"))
    loop.run_until_complete(broker.declare_exchange("/", "ex", "topic"))
    loop.run_until_complete(broker.declare_queue("/", "q1"))
    loop.run_until_complete(broker.declare_queue("/", "q2"))
    loop.run_until_complete(broker.bind_queue("/", "q1", "ex", "a.*"))
    loop.run_until_complete(broker.bind_queue("/", "q2", "ex", "a.b"))
    return broker


def _entries(pairs):
    props = BasicProperties()
    return [(ex, rk, props, b"x", None, None, False) for ex, rk in pairs]


def test_engine_route_and_incremental_recompile(event_loop):
    broker = _mk_broker_with_topic(event_loop)
    router = broker.router
    assert router.backend == "torch" and router.device == CPU
    router.min_batch = 1
    routes, _, _ = router.route_pending("/", _entries([("ex", "a.b")] * 4))
    assert sorted(q.name for q in routes[0]) == ["q1", "q2"]
    gen1 = router.generation
    assert broker.metrics.router_compiles == 1
    router.route_pending("/", _entries([("ex", "a.c")]))
    assert router.generation == gen1
    event_loop.run_until_complete(
        broker.bind_queue("/", "q2", "ex", "c.#"))
    routes, _, _ = router.route_pending("/", _entries([("ex", "c.x.y")]))
    assert [q.name for q in routes[0]] == ["q2"]
    assert router.generation == gen1 + 1
    assert broker.metrics.router_compiles == 2


def test_engine_python_backend_and_fallback(event_loop):
    broker = _mk_broker_with_topic(event_loop, router_backend="python")
    router = broker.router
    router.min_batch = 1
    routes, _, _ = router.route_pending("/", _entries([("ex", "a.z")]))
    assert [q.name for q in routes[0]] == ["q1"]
    event_loop.run_until_complete(
        broker.bind_queue("/", "q1", "ex", "#.mid.#"))
    before = broker.metrics.router_fallback_msgs
    routes, _, _ = router.route_pending("/", _entries([("ex", "x.mid.y")]))
    assert [q.name for q in routes[0]] == ["q1"]
    assert broker.metrics.router_fallback_msgs == before + 1


def test_engine_min_batch_falls_back(event_loop):
    broker = _mk_broker_with_topic(event_loop)
    router = broker.router
    router.min_batch = 8
    before = broker.metrics.router_fallback_msgs
    routes, _, _ = router.route_pending("/", _entries([("ex", "a.b")] * 3))
    assert broker.metrics.router_fallback_msgs == before + 3
    assert sorted(q.name for q in routes[0]) == ["q1", "q2"]
    assert broker.metrics.router_batches == 0


def test_engine_verify_mode_clean(event_loop):
    broker = _mk_broker_with_topic(event_loop)
    router = broker.router
    router.min_batch = 1
    router.verify = True
    router.route_pending(
        "/", _entries([("ex", k) for k in ("a.b", "a.x", "q", "", "a.b.c")]))
    assert broker.metrics.router_parity_mismatches == 0
    assert broker.metrics.router_batches == 1


def test_engine_defer_ok_gates(event_loop):
    broker = _mk_broker_with_topic(event_loop)
    router = broker.router
    assert router.defer_ok("/", "ex")
    assert not router.defer_ok("/", "")
    assert not router.defer_ok("/", "missing")
    event_loop.run_until_complete(
        broker.declare_exchange("/", "alt-ex", "topic",
                                arguments={"alternate-exchange": "ex"}))
    assert not router.defer_ok("/", "alt-ex")
    event_loop.run_until_complete(broker.declare_exchange("/", "e2", "fanout"))
    assert router.defer_ok("/", "e2")
    event_loop.run_until_complete(
        broker.bind_exchange("/", "ex", "e2", "k"))
    assert router.defer_ok("/", "e2")
    event_loop.run_until_complete(broker.declare_exchange("/", "e3", "topic"))
    event_loop.run_until_complete(
        broker.bind_exchange("/", "ex", "e3", "x.*"))
    assert not router.defer_ok("/", "e3")


def test_engine_unknown_backend_raises():
    with pytest.raises(ValueError):
        TensorRouter(None, backend="jax", device="cpu")


def test_engine_routes_e2e_closure_on_device_tables(event_loop):
    """A flattened exchange-to-exchange closure routes through the torch
    backend like a single topic table."""
    broker = _mk_broker_with_topic(event_loop)
    router = broker.router
    router.min_batch = 1
    router.verify = True
    event_loop.run_until_complete(broker.declare_exchange("/", "root", "fanout"))
    event_loop.run_until_complete(broker.bind_exchange("/", "ex", "root", ""))
    routes, _, _ = router.route_pending(
        "/", _entries([("root", "a.b"), ("root", "a.q"), ("root", "z")]))
    assert [sorted(q.name for q in r) for r in routes] == [
        ["q1", "q2"], ["q1"], []]
    assert broker.metrics.router_parity_mismatches == 0
