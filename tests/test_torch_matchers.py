"""Routing matcher unit tests (the reference's TrieMatcher.main self-test
coverage, QueueMatcher.scala:75-139, extended with '#' and headers).

The port's copy of ``tests/test_matchers.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU; the
assertions are the reference's.
"""

from chanamq_tpu_torch.broker.matchers import (
    DirectMatcher,
    FanoutMatcher,
    HeadersMatcher,
    TopicMatcher,
    matcher_for,
)


def test_direct_exact_match():
    m = DirectMatcher()
    assert m.bind("k1", "q1")
    assert not m.bind("k1", "q1")  # duplicate
    m.bind("k1", "q2")
    m.bind("k2", "q3")
    assert m.route("k1") == {"q1", "q2"}
    assert m.route("k2") == {"q3"}
    assert m.route("k3") == set()
    assert m.unbind("k1", "q1")
    assert not m.unbind("k1", "q1")
    assert m.route("k1") == {"q2"}


def test_fanout_ignores_key():
    m = FanoutMatcher()
    m.bind("a", "q1")
    m.bind("b", "q2")
    assert m.route("anything") == {"q1", "q2"}
    m.unbind("a", "q1")
    assert m.route("x") == {"q2"}


def test_fanout_multiple_keys_same_queue():
    m = FanoutMatcher()
    m.bind("a", "q1")
    m.bind("b", "q1")
    m.unbind("a", "q1")
    assert m.route("x") == {"q1"}  # still bound via key b
    m.unbind("b", "q1")
    assert m.route("x") == set()


def test_topic_star_single_word():
    m = TopicMatcher()
    m.bind("stock.*.nyse", "q1")
    assert m.route("stock.ibm.nyse") == {"q1"}
    assert m.route("stock.goog.nyse") == {"q1"}
    assert m.route("stock.nyse") == set()
    assert m.route("stock.ibm.x.nyse") == set()


def test_topic_exact_and_star_coexist():
    m = TopicMatcher()
    m.bind("a.b.c", "exact")
    m.bind("a.*.c", "star")
    m.bind("*.b.c", "star2")
    assert m.route("a.b.c") == {"exact", "star", "star2"}
    assert m.route("a.x.c") == {"star"}
    assert m.route("z.b.c") == {"star2"}


def test_topic_hash_zero_or_more():
    m = TopicMatcher()
    m.bind("stock.#", "all_stock")
    m.bind("#", "everything")
    m.bind("#.nyse", "nyse_suffix")
    assert m.route("stock") == {"all_stock", "everything"}
    assert m.route("stock.ibm") == {"all_stock", "everything"}
    assert m.route("stock.ibm.nyse") == {"all_stock", "everything", "nyse_suffix"}
    assert m.route("nyse") == {"everything", "nyse_suffix"}
    assert m.route("bond") == {"everything"}


def test_topic_hash_middle():
    m = TopicMatcher()
    m.bind("a.#.z", "q")
    assert m.route("a.z") == {"q"}
    assert m.route("a.b.z") == {"q"}
    assert m.route("a.b.c.z") == {"q"}
    assert m.route("a.b") == set()


def test_topic_unbind_prunes():
    m = TopicMatcher()
    m.bind("a.b.c", "q1")
    m.bind("a.b", "q2")
    assert m.unbind("a.b.c", "q1")
    assert m.route("a.b.c") == set()
    assert m.route("a.b") == {"q2"}
    assert not m.unbind("a.b.c", "q1")
    # internal trie pruned back to just a.b
    assert m.bindings() == [("a.b", "q2", None)]


def test_topic_unbind_queue_bulk():
    m = TopicMatcher()
    m.bind("a.*", "q1")
    m.bind("b.*", "q1")
    m.bind("a.*", "q2")
    assert m.unbind_queue("q1") == 2
    assert m.route("a.x") == {"q2"}
    assert m.route("b.x") == set()


def test_headers_all_match():
    m = HeadersMatcher()
    m.bind("", "q1", {"x-match": "all", "type": "report", "fmt": "pdf"})
    assert m.route("", {"type": "report", "fmt": "pdf"}) == {"q1"}
    assert m.route("", {"type": "report", "fmt": "pdf", "extra": 1}) == {"q1"}
    assert m.route("", {"type": "report"}) == set()
    assert m.route("", {"type": "memo", "fmt": "pdf"}) == set()


def test_headers_any_match():
    m = HeadersMatcher()
    m.bind("", "q1", {"x-match": "any", "a": 1, "b": 2})
    assert m.route("", {"a": 1}) == {"q1"}
    assert m.route("", {"b": 2, "c": 3}) == {"q1"}
    assert m.route("", {"a": 9}) == set()
    assert m.route("", {}) == set()


def test_headers_empty_bindings_and_unbind():
    m = HeadersMatcher()
    m.bind("", "qall", {"x-match": "all"})       # empty all: matches anything
    m.bind("", "qany", {"x-match": "any"})       # empty any: never matches
    m.bind("", "q1", {"x-match": "all", "k": "v"})
    assert m.route("", {}) == {"qall"}
    assert m.route("", {"k": "v"}) == {"qall", "q1"}
    assert m.unbind("", "q1", {"x-match": "all", "k": "v"})
    assert m.route("", {"k": "v"}) == {"qall"}
    assert m.unbind_queue("qall") == 1
    assert m.route("", {"k": "v"}) == set()


def test_headers_unhashable_values_still_route():
    """Field-table arrays are unhashable: those bindings take the verified
    fallback bucket and must still match/unmatch correctly."""
    m = HeadersMatcher()
    m.bind("", "q1", {"x-match": "all", "tags": [1, 2]})
    m.bind("", "q2", {"x-match": "any", "tags": [1, 2], "k": "v"})
    assert m.route("", {"tags": [1, 2]}) == {"q1", "q2"}
    assert m.route("", {"tags": [9]}) == set()
    assert m.route("", {"k": "v"}) == {"q2"}
    # unhashable MESSAGE header against hashable bindings: no crash, no match
    m2 = HeadersMatcher()
    m2.bind("", "q3", {"x-match": "any", "k": "v"})
    assert m2.route("", {"k": [1]}) == set()


def test_headers_index_scales_route_not_bindings():
    """Route cost rides the index: with 2000 bindings on distinct values a
    route touches only its own candidates (observable: correctness over a
    large binding set; the per-route scan of every binding is gone)."""
    m = HeadersMatcher()
    for i in range(2000):
        m.bind("", f"q{i}", {"x-match": "all", "shard": i})
    assert m.route("", {"shard": 1234}) == {"q1234"}
    assert m.route("", {"shard": -1}) == set()


def test_matcher_factory():
    from chanamq_tpu_torch import native_ext

    assert isinstance(matcher_for("direct"), DirectMatcher)
    assert isinstance(matcher_for("fanout"), FanoutMatcher)
    topic = matcher_for("topic")
    if native_ext.available():
        assert isinstance(topic, native_ext.NativeTopicMatcher)
    else:
        assert isinstance(topic, TopicMatcher)
    assert isinstance(matcher_for("headers"), HeadersMatcher)


def test_topic_matchers_agree_randomized():
    """Seeded property test: the Python TopicMatcher, the native C++ trie,
    and a brute-force reference evaluator must agree on every (pattern
    set, routing key) pair across random topologies — including `*`/`#`
    in every position, empty words, and bind/unbind churn."""
    import random

    from chanamq_tpu_torch import native_ext
    from chanamq_tpu_torch.broker.matchers import TopicMatcher

    def naive_match(pattern: str, key: str) -> bool:
        # textbook recursive AMQP topic match over '.'-split words
        def rec(p, k):
            if not p:
                return not k
            if p[0] == "#":
                return any(rec(p[1:], k[i:]) for i in range(len(k) + 1))
            if not k:
                return False
            if p[0] == "*" or p[0] == k[0]:
                return rec(p[1:], k[1:])
            return False
        return rec(pattern.split("."), key.split("."))

    rng = random.Random(0x70C1C)
    words = ["a", "b", "cc", "*", "#"]
    key_words = ["a", "b", "cc", "d"]
    matchers = [TopicMatcher()]
    if native_ext.available():
        matchers.append(native_ext.NativeTopicMatcher())
    bound: set[tuple[str, str]] = set()
    for trial in range(400):
        op = rng.random()
        if op < 0.5 or not bound:
            pattern = ".".join(rng.choice(words)
                               for _ in range(rng.randrange(1, 5)))
            queue = f"q{rng.randrange(6)}"
            for m in matchers:
                m.bind(pattern, queue)
            bound.add((pattern, queue))
        elif op < 0.65:
            pattern, queue = rng.choice(sorted(bound))
            for m in matchers:
                m.unbind(pattern, queue)
            bound.discard((pattern, queue))
        key = ".".join(rng.choice(key_words)
                       for _ in range(rng.randrange(1, 5)))
        expected = {q for (p, q) in bound if naive_match(p, key)}
        for m in matchers:
            got = m.route(key)
            assert got == expected, (
                f"{type(m).__name__} diverged on key={key!r}: "
                f"{got} != {expected}; bound={sorted(bound)}")


def test_headers_matcher_agrees_with_naive_model():
    """Seeded property test: the inverted-index HeadersMatcher must agree
    with a brute-force evaluator across random binding sets (x-match all
    and any, overlapping keys, absent headers, bind/unbind churn)."""
    import random

    from chanamq_tpu_torch.broker.matchers import HeadersMatcher

    def naive_route(bindings, headers):
        out = set()
        headers = headers or {}
        for args, queue in bindings:
            pairs = {k: v for k, v in args.items() if not k.startswith("x-")}
            if not pairs:
                continue
            if args.get("x-match") == "any":
                ok = any(headers.get(k) == v for k, v in pairs.items())
            else:  # all (default)
                ok = all(headers.get(k) == v for k, v in pairs.items())
            if ok:
                out.add(queue)
        return out

    rng = random.Random(0x4EAD)
    keys = ["fmt", "region", "tier"]
    vals = ["a", "b", 1, 2]
    matcher = HeadersMatcher()
    bound: list[tuple[dict, str]] = []
    for trial in range(300):
        if rng.random() < 0.5 or not bound:
            args = {k: rng.choice(vals)
                    for k in rng.sample(keys, rng.randrange(1, 3))}
            if rng.random() < 0.5:
                args["x-match"] = rng.choice(["all", "any"])
            queue = f"q{rng.randrange(5)}"
            # HeadersMatcher dedupes on (args, queue); mirror that
            if not any(a == args and q == queue for a, q in bound):
                matcher.bind("", queue, args)
                bound.append((dict(args), queue))
        elif rng.random() < 0.3:
            args, queue = bound.pop(rng.randrange(len(bound)))
            matcher.unbind("", queue, args)
        headers = {k: rng.choice(vals)
                   for k in rng.sample(keys, rng.randrange(0, 4))}
        if rng.random() < 0.1:
            headers = None
        expected = naive_route(bound, headers)
        got = matcher.route("ignored", headers)
        assert got == expected, (trial, headers, sorted(
            (a, q) for a, q in bound), got, expected)
