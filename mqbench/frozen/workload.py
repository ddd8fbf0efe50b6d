"""The router deployment and its publish streams, made from seeds.

Copied from ``chip_smoke.py``'s ``Workload`` (the bindings at the router's
documented caps) and rewritten to import only from ``mqbench``: the host
matchers that keep every key and header set at 1-16 queues are the plain
reference's (``mqbench/reference/matchers.py``).

``Topology``: ``n_patterns`` topic patterns of 2-6 words from a
``vocab``-word vocabulary (a literal first word, then words or ``*``, at
most one ``#``) over ``n_queues`` queues, each queue bound once: half the
patterns own 1-3 queues, the rest share the remaining queues. Headers:
``header_bindings`` all/any bindings of 1-4 (header, value) pairs over 16
headers with 64 values each, one queue each, and ``header_sets`` message
header sets built around a binding. The configuration's seed fixes it, as
a deployment's bindings are fixed; the Zipf ranks of its patterns and its
pool of hot keys are part of it.

``Stream``: publisher ``p``'s messages under a traffic file. Message ``i``
is a pure function of (run seed, ``p``, ``i // 64``), so a check can make
any one again: topic (at the traffic's ``topic_share``) or headers. Topic keys
are ``device`` keys (a Zipf-ranked pattern instantiated with a device id
out of ``devices`` in one of its wildcard positions, so keys rarely
repeat) or ``pool`` keys (a Zipf-ranked pick from the fixed pool).
"""

from __future__ import annotations

import random
import struct

from mqbench.reference.matchers import HeadersMatcher, TopicMatcher

TOPIC_EXCHANGE = "bench.topic"
HEADERS_EXCHANGE = "bench.headers"
SEED_MASK = (1 << 63) - 1


def zipf_cum(n: int, s: float) -> list:
    """Cumulative Zipf(s) weights over ranks 1..n."""
    out, acc = [], 0.0
    for r in range(1, n + 1):
        acc += r ** -s
        out.append(acc)
    return out


class Topology:
    def __init__(self, seed: int, *, n_queues: int = 4096,
                 n_patterns: int = 512, vocab: int = 64,
                 header_bindings: int = 512, header_names: int = 16,
                 header_values: int = 64, header_sets: int = 1024,
                 max_fanout: int = 16, pool: int = 1024,
                 zipf_s: float = 1.0) -> None:
        rng = random.Random(seed)
        self.max_fanout = max_fanout
        self.queues = [f"q{i:04d}" for i in range(n_queues)]
        self.vocab = [f"w{i}" for i in range(vocab)]
        patterns: list = []
        seen: set = set()
        while len(patterns) < n_patterns:
            toks = [rng.choice(self.vocab)] + [
                rng.choice(self.vocab) if rng.random() < 0.8 else "*"
                for _ in range(rng.randint(1, 5))]
            if rng.random() < 0.3:
                toks[rng.randrange(1, len(toks))] = "#"
            elif "*" not in toks:
                toks[rng.randrange(1, len(toks))] = "*"
            pat = ".".join(toks)
            if pat not in seen:
                seen.add(pat)
                patterns.append(pat)
        self.patterns = patterns
        order = list(self.queues)
        rng.shuffle(order)
        n_small = self.n_small = n_patterns // 2
        sizes = [rng.randint(1, 3) for _ in range(n_small)]
        rest = n_queues - sum(sizes)
        n_large = n_patterns - n_small
        sizes += [rest // n_large + (1 if i < rest % n_large else 0)
                  for i in range(n_large)]
        self.topic_bindings: list = []
        pos = 0
        for pat, k in zip(patterns, sizes):
            for q in order[pos:pos + k]:
                self.topic_bindings.append((pat, q))
            pos += k
        self.topic = TopicMatcher()
        for pat, q in self.topic_bindings:
            self.topic.bind(pat, q)

        names = [f"h{i}" for i in range(header_names)]
        values = [f"v{i}" for i in range(header_values)]
        hq = rng.sample(self.queues, min(header_bindings, n_queues))
        self.headers_bindings: list = []
        for q in hq:
            args = {h: rng.choice(values)
                    for h in rng.sample(names, rng.randint(1, 4))}
            args["x-match"] = rng.choice(["all", "any"])
            self.headers_bindings.append((q, args))
        self.headers = HeadersMatcher()
        for q, args in self.headers_bindings:
            self.headers.bind(q, args)
        self.header_sets: list = []
        while len(self.header_sets) < header_sets:
            _, args = rng.choice(self.headers_bindings)
            hs = {h: v for h, v in args.items() if h != "x-match"}
            for h in rng.sample(names, rng.randint(1, 4)):
                hs.setdefault(h, rng.choice(values))
            if 1 <= len(self.headers.route(hs)) <= max_fanout:
                self.header_sets.append(hs)

        # Zipf ranks: a pattern's rank, and the hot-key pool in rank order
        self.pattern_rank = list(range(n_patterns))
        rng.shuffle(self.pattern_rank)
        self.pattern_cum = zipf_cum(n_patterns, zipf_s)
        self.pool: list = []
        pool_seen: set = set()
        while len(self.pool) < pool:
            i = rng.randrange(n_small) if rng.random() < 0.9 else \
                rng.randrange(n_small, n_patterns)
            words = []
            for t in patterns[i].split("."):
                if t == "#":
                    words += [rng.choice(self.vocab)
                              for _ in range(rng.randint(0, 2))]
                elif t == "*":
                    words.append(rng.choice(self.vocab) if rng.random() < 0.9
                                 else f"oov{rng.randrange(1000)}")
                else:
                    words.append(t)
            key = ".".join(words)
            if key not in pool_seen and self.fits(key):
                pool_seen.add(key)
                self.pool.append(key)
        self.pool_cum = zipf_cum(pool, zipf_s)

    def fits(self, key: str) -> bool:
        return 1 <= len(self.topic.route(key)) <= self.max_fanout

    def route(self, message: tuple) -> set:
        """The queues a message reaches (the reference's answer)."""
        kind, x = message
        return (self.topic.route(x) if kind == "t"
                else self.headers.route(self.header_sets[x]))


class Stream:
    """Publisher ``p``'s messages for run seed ``seed``, made in blocks of
    ``BLOCK`` from one generator each."""

    BLOCK = 64

    def __init__(self, topo: Topology, traffic: dict, seed: int,
                 p: int) -> None:
        self.topo, self.traffic, self.p = topo, traffic, p
        self.base = (((seed & SEED_MASK) << 8) | p) << 40
        self.filler = bytes((p * 131 + j * 7) & 0xFF
                            for j in range(traffic["body_bytes"] - 8))
        self._block = (-1, [])

    def message(self, i: int) -> tuple:
        """("t", routing key) or ("h", header-set index)."""
        b = i // self.BLOCK
        if self._block[0] != b:
            rng = random.Random(self.base + b)
            self._block = (b, [self._draw(rng) for _ in range(self.BLOCK)])
        return self._block[1][i % self.BLOCK]

    def _draw(self, rng: random.Random) -> tuple:
        t, topo = self.traffic, self.topo
        if rng.random() >= t["topic_share"]:
            return ("h", rng.randrange(len(topo.header_sets)))
        if t["keys"] == "pool":
            return ("t", rng.choices(topo.pool, cum_weights=topo.pool_cum)[0])
        while True:
            rank = rng.choices(range(len(topo.patterns)),
                               cum_weights=topo.pattern_cum)[0]
            toks = topo.patterns[topo.pattern_rank[rank]].split(".")
            wild = [j for j, w in enumerate(toks) if w in ("*", "#")]
            dev = rng.choice(wild)
            words = []
            for j, w in enumerate(toks):
                if j == dev:
                    words.append(f"d{rng.randrange(t['devices']):06d}")
                elif w == "*":
                    words.append(rng.choice(topo.vocab))
                elif w == "#":
                    words += [rng.choice(topo.vocab)
                              for _ in range(rng.randint(0, 2))]
                else:
                    words.append(w)
            key = ".".join(words)
            if topo.fits(key):
                return ("t", key)

    def body(self, i: int) -> bytes:
        return struct.pack("<II", self.p, i) + self.filler
