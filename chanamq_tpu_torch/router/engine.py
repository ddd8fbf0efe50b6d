"""TensorRouter: batched publish routing over compiled binding tables.

The broker owns one TensorRouter (``chana.mq.router.enabled``). The
connection read loop, instead of routing each fused publish inline, defers
eligible messages into a per-connection buffer and flushes the WHOLE read
batch through ``Broker.flush_deferred_publishes`` -> ``route_pending``
here: one compiled-table lookup per exchange and one device kernel call
per exchange per flush, instead of one trie walk per message.

Consistency model (why deferral is safe):

- Deferral only happens between awaits of a single connection's read-batch
  processing, and every path that can publish, run a generic AMQP command,
  release confirms, or close the connection flushes the buffer FIRST
  (synchronously — the single-node publish path never awaits). The event
  loop is single-threaded, so no other connection's topology mutation can
  interleave with an unflushed buffer: the vhost/exchange state observed
  at ``defer_ok`` time is still live at flush time.
- ``Broker.invalidate_routes(vhost, exchange)`` drops exactly that
  exchange's compiled snapshot (or all of them for bulk mutations);
  recompilation is lazy, at the next flush that routes through it, under a
  monotonically increasing generation counter. Snapshots are immutable —
  a flush in progress keeps routing against the snapshot it resolved.
- Exchanges the compiler rejects (``Uncompilable``) and sub-``min-batch``
  kernel batches fall back to the exchange's Python matcher — the always
  available, always-correct oracle. ``chana.mq.router.verify`` cross-checks
  every kernel result against the oracle and prefers the oracle on any
  mismatch (counted in ``router_parity_mismatches``).
"""

from __future__ import annotations

import logging
import time
from typing import TYPE_CHECKING, Optional

import torch

from . import compile as rcompile

if TYPE_CHECKING:  # pragma: no cover
    from ..broker.broker import Broker

log = logging.getLogger("chanamq.router")

_DEFERRABLE_TYPES = ("direct", "fanout", "topic", "headers")

# resolved (vhost, name-set) -> [Queue] memo cap; cleared on invalidate
_QUEUE_CACHE_CAP = 8192


def _classify_topic(pattern: str, queues, exact: dict, always: set,
                    wild: dict) -> None:
    """Sort one topic pattern into the universal closure shape: exact
    string key, unconditional, or genuine wildcard row."""
    toks = pattern.split(".")
    nhash = toks.count("#")
    if nhash == 0 and "*" not in toks:
        exact.setdefault(pattern, set()).update(queues)
    elif toks == ["#"]:
        always.update(queues)
    elif nhash > 1:
        raise rcompile.Uncompilable("multi-# pattern")
    else:
        wild.setdefault(pattern, set()).update(queues)


class TensorRouter:
    """Per-broker batch router over compiled binding tables."""

    def __init__(
        self,
        broker: "Broker",
        *,
        backend: str = "torch",
        device: "torch.device | str" = "cuda",
        min_batch: int = 16,
        max_wildcards: int = 512,
        max_queues: int = 4096,
        verify: bool = False,
    ) -> None:
        self.broker = broker
        if backend not in rcompile.BACKENDS:
            raise ValueError(f"unknown router backend {backend!r}")
        self.backend = backend
        # where the compiled tables live and the kernels run; "cuda" with
        # no card raises at the first kernel batch, never runs on the CPU
        self.device = torch.device(device)
        self.min_batch = max(1, min_batch)
        self.max_wildcards = max_wildcards
        self.max_queues = max_queues
        self.verify = verify
        self.generation = 0
        # (vhost, exchange) -> CompiledExchange | str (uncompilable reason)
        self._compiled: dict = {}
        # (vhost, exchange) -> bool deferral decision memo
        self._defer: dict = {}
        # (vhost, frozenset-of-names) -> [Queue]
        self._queue_cache: dict = {}
        # closure dependency edges: (vhost, member-exchange) -> set of
        # (vhost, root-exchange) whose flattened snapshot embeds the
        # member's bindings — a bind/unbind anywhere in a compiled e2e
        # graph must drop every root built over it
        self._closure_deps: dict = {}

    # -- invalidation ------------------------------------------------------

    def invalidate(self, vhost: Optional[str] = None,
                   exchange: Optional[str] = None) -> None:
        """Topology changed. With a (vhost, exchange) only that snapshot is
        dropped (dirty-exchange batching: untouched tables keep their
        compiled form); bulk mutations drop everything. Either way the
        deferral decisions and resolved-queue memo reset — they embed
        exchange structure and live Queue objects."""
        self._defer.clear()
        self._queue_cache.clear()
        if vhost is None or exchange is None:
            self._compiled.clear()
            self._closure_deps.clear()
        else:
            self._compiled.pop((vhost, exchange), None)
            # dependent invalidation: every flattened e2e root whose
            # closure walked through this exchange recompiles lazily too
            roots = self._closure_deps.pop((vhost, exchange), None)
            if roots:
                for root_key in roots:
                    self._compiled.pop(root_key, None)

    # -- deferral decision (publish hot path) ------------------------------

    def defer_ok(self, vhost_name: str, exchange_name: str) -> bool:
        """Whether a fused publish to this exchange may be deferred into
        the batch buffer. Memoized; any invalidate() clears the memo. The
        structural checks guarantee a later flush cannot raise: the
        exchange exists, is externally publishable, and carries none of
        the semantics (alternate exchange, e2e bindings) the batch path
        doesn't implement."""
        key = (vhost_name, exchange_name)
        ok = self._defer.get(key)
        if ok is None:
            ok = self._defer[key] = self._compute_defer(
                vhost_name, exchange_name)
        return ok

    def _compute_defer(self, vhost_name: str, exchange_name: str) -> bool:
        if exchange_name == "":
            return False  # default exchange: the dict hit is already optimal
        vhost = self.broker.vhosts.get(vhost_name)
        if vhost is None:
            return False
        exchange = vhost.exchanges.get(exchange_name)
        if exchange is None or exchange.internal:
            return False
        if exchange.alternate is not None:
            return False
        if exchange.type not in _DEFERRABLE_TYPES:
            return False
        if exchange.ex_matcher is not None:
            # e2e source: defer only when the graph closure flattened into
            # a compiled snapshot (semantics PR) — an uncompilable closure
            # keeps the inline per-message walk, since a batched fallback
            # would just re-run the same walk later
            return self._get_compiled(
                vhost, vhost_name, exchange_name) is not None
        return True

    # -- batch routing -----------------------------------------------------

    def _get_compiled(self, vhost, vhost_name: str, exchange_name: str):
        key = (vhost_name, exchange_name)
        comp = self._compiled.get(key)
        if comp is None:
            exchange = vhost.exchanges[exchange_name]
            self.generation += 1
            metrics = self.broker.metrics
            metrics.router_generation = self.generation
            try:
                if exchange.ex_matcher is not None:
                    comp = self._compile_closure(
                        vhost, vhost_name, exchange_name)
                else:
                    comp = rcompile.compile_exchange(
                        exchange.type, exchange.matcher.bindings(),
                        generation=self.generation,
                        max_wildcards=self.max_wildcards,
                        max_queues=self.max_queues)
                metrics.router_compiles += 1
            except rcompile.Uncompilable as exc:
                comp = exc.reason
                log.debug("exchange %s/%s not tensorizable: %s",
                          vhost_name, exchange_name, exc.reason)
            self._compiled[key] = comp
        return None if isinstance(comp, str) else comp

    # -- e2e closure flattening --------------------------------------------

    def _compile_closure(self, vhost, vhost_name: str, root: str):
        """Flatten `root`'s exchange-to-exchange graph closure into one
        compiled table: a publish routed through the snapshot reaches the
        exact queue set the runtime breadth-first walk would, with zero
        per-message graph traversal. Each hop's predicate composes by
        CONJUNCTION (every hop re-matches the ORIGINAL routing key), so
        only trivially-chainable graphs flatten — always-match edges
        (fanout, lone '#') merge the sub-closure wholesale, exact-key
        edges evaluate it at the known key, and a genuine-wildcard edge
        composes with exact/always sub-entries only. Anything else
        (wildcard-over-wildcard, headers, alternate-exchange fallbacks,
        recovered cycles) raises Uncompilable and stays on the walk."""
        exact: dict[str, set] = {}
        always: set = set()
        wild: dict[str, set] = {}
        self._flatten(vhost, vhost_name, root, root,
                      exact, always, wild, (root,))
        return rcompile.compile_effective(
            exact, always, wild, generation=self.generation,
            max_wildcards=self.max_wildcards, max_queues=self.max_queues)

    def _flatten(self, vhost, vhost_name: str, root: str, name: str,
                 exact: dict, always: set, wild: dict, path: tuple) -> None:
        # dependency edge FIRST (even for dangling/failing members): an
        # Uncompilable verdict cached for the root must also be dropped
        # when any member's bindings change
        self._closure_deps.setdefault((vhost_name, name), set()).add(
            (vhost_name, root))
        ex = vhost.exchanges.get(name)
        if ex is None:
            return  # dangling e2e target: routes nowhere until redeclared
        if ex.alternate is not None:
            raise rcompile.Uncompilable("alternate exchange in e2e closure")
        kind = ex.type
        if kind == "headers":
            raise rcompile.Uncompilable("headers exchange in e2e closure")
        if kind not in ("direct", "fanout", "topic"):
            raise rcompile.Uncompilable(f"e2e closure over {kind!r}")
        for key, queue, _args in ex.matcher.bindings():
            if kind == "fanout":
                always.add(queue)
            elif kind == "direct":
                exact.setdefault(key, set()).add(queue)
            else:
                _classify_topic(key, (queue,), exact, always, wild)
        if ex.ex_matcher is None:
            return
        for pkey, dst, _args in ex.ex_matcher.bindings():
            if dst in path:
                # a pre-guard (recovered) cycle: the walk dedups it, a
                # flat table cannot represent it
                raise rcompile.Uncompilable("cycle in e2e closure")
            s_exact: dict[str, set] = {}
            s_always: set = set()
            s_wild: dict[str, set] = {}
            self._flatten(vhost, vhost_name, root, dst,
                          s_exact, s_always, s_wild, path + (dst,))
            toks = pkey.split(".") if kind == "topic" else None
            if kind == "fanout" or (toks is not None and toks == ["#"]):
                # always-match hop: sub-closure merges wholesale
                always.update(s_always)
                for k, qs in s_exact.items():
                    exact.setdefault(k, set()).update(qs)
                for pat, qs in s_wild.items():
                    wild.setdefault(pat, set()).update(qs)
            elif kind == "direct" or ("#" not in toks and "*" not in toks):
                # exact-key hop: evaluate the sub-closure at the one key
                # that can traverse it (compile-time, never per-message)
                qs = set(s_exact.get(pkey, ())) | s_always
                for pat, sq in s_wild.items():
                    if rcompile.topic_match(pat, pkey):
                        qs |= sq
                if qs:
                    exact.setdefault(pkey, set()).update(qs)
            else:
                # genuine wildcard hop: p AND sub-predicate composes only
                # when the sub side is trivial (TRUE or an exact key)
                if toks.count("#") > 1:
                    raise rcompile.Uncompilable("multi-# e2e pattern")
                if s_always:
                    _classify_topic(pkey, s_always, exact, always, wild)
                for k, qs in s_exact.items():
                    if rcompile.topic_match(pkey, k):
                        exact.setdefault(k, set()).update(qs)
                if s_wild:
                    raise rcompile.Uncompilable(
                        "wildcard-over-wildcard e2e chain")

    def _queues(self, vhost_name: str, vhost, names) -> list:
        """Resolve a routed name-set to live Queue objects, memoized per
        distinct set (fan-out traffic repeats a handful of sets)."""
        cache = self._queue_cache
        key = (vhost_name, names)
        queues = cache.get(key)
        if queues is None:
            vq = vhost.queues
            queues = [vq[n] for n in names if n in vq]
            if len(cache) >= _QUEUE_CACHE_CAP:
                cache.clear()
            cache[key] = queues
        return queues

    def route_pending(self, vhost_name: str, entries: list):
        """Route one deferred flush. ``entries`` rows are
        ``(exchange, routing_key, props, body, header_raw, exrk_raw,
        confirmed)``; returns ``(queues_per_entry, t0_ns, t1_ns)`` with the
        batch routing window for ROUTE span stamping."""
        t0 = time.perf_counter_ns()
        metrics = self.broker.metrics
        vhost = self.broker.vhosts[vhost_name]
        out: list = [None] * len(entries)
        # group by exchange: one compiled snapshot + one kernel call each
        groups: dict[str, list[int]] = {}
        for idx, entry in enumerate(entries):
            groups.setdefault(entry[0], []).append(idx)
        for exchange_name, idxs in groups.items():
            compiled = self._get_compiled(vhost, vhost_name, exchange_name)
            use_kernel = compiled is not None and (
                compiled.kernel_rows == 0 or len(idxs) >= self.min_batch)
            if not use_kernel:
                # Python fallback: uncompilable table, or a batch too
                # small to amortize the kernel dispatch. An e2e source
                # falls back to the full graph walk, not the single-hop
                # matcher — the closure IS the exchange's route set.
                metrics.router_fallback_msgs += len(idxs)
                exchange = vhost.exchanges[exchange_name]
                if exchange.ex_matcher is not None:
                    for idx in idxs:
                        entry = entries[idx]
                        names = frozenset(vhost.route(
                            exchange_name, entry[1], entry[2].headers))
                        out[idx] = self._queues(vhost_name, vhost, names)
                else:
                    matcher = exchange.matcher
                    for idx in idxs:
                        entry = entries[idx]
                        names = frozenset(
                            matcher.route(entry[1], entry[2].headers))
                        out[idx] = self._queues(vhost_name, vhost, names)
                continue
            items = [(entries[i][1], entries[i][2].headers) for i in idxs]
            name_sets = rcompile.route_batch(
                compiled, items, self.backend, self.device)
            if self.verify:
                exchange = vhost.exchanges[exchange_name]
                if exchange.ex_matcher is not None:
                    # live oracle for a flattened closure is the runtime
                    # graph walk itself
                    def _oracle(k, h, _n=exchange_name):
                        return vhost.route(_n, k, h)
                else:
                    _oracle = exchange.matcher.route
                for pos, (key, headers) in enumerate(items):
                    oracle = _oracle(key, headers)
                    if set(name_sets[pos]) != oracle:
                        metrics.router_parity_mismatches += 1
                        log.error(
                            "router parity mismatch on %s/%s key=%r: "
                            "kernel=%r oracle=%r", vhost_name, exchange_name,
                            key, sorted(name_sets[pos]), sorted(oracle))
                        name_sets[pos] = frozenset(oracle)
            metrics.router_batches += 1
            metrics.router_batch_msgs += len(idxs)
            metrics.router_batch_size.observe_us(len(idxs))
            for idx, names in zip(idxs, name_sets):
                out[idx] = self._queues(vhost_name, vhost, names)
        return out, t0, time.perf_counter_ns()
