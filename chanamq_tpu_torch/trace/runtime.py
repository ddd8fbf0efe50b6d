"""Sampled end-to-end message tracing: fixed-slot spans per message.

A sampled publish mints a :class:`Trace` holding one slot per pipeline
stage (STAGES).  Stages stamp ``(start_ns, end_ns, node)`` tuples from
``time.perf_counter_ns()`` at the existing hot-path seams; nothing here
allocates per message unless the message was sampled.  Traces cross the
cluster planes as a compact blob appended *after* the record area of the
binary data-plane payloads (kinds 4/5/6) — old decoders iterate exactly
``count`` records and never look at trailing bytes, so the trailer is
wire-compatible in both directions.  The trailer is tail-anchored
(length + magic in the last 8 bytes) so a receiver can lift trace
contexts before the lazy record decoders consume the cursor.

Completed traces land in a bounded ring; traces slower than
``chana.mq.trace.slow-ms`` or touched by a chaos fire are additionally
kept in a slow ring so they survive churn (fault -> latency
causality must stay visible).
"""

from __future__ import annotations

import random
import struct
import time
from collections import OrderedDict, deque
from typing import Iterable, Optional, Sequence

from ..otel.context import W3CContext, derive_span_id
from ..otel.context import extract as _w3c_extract
from ..utils.metrics import Histogram, Metrics

# Fixed pipeline stages, one slot each.  Order is pipeline order; the
# indices are wire format (blob span tags), so append-only.
STAGES = (
    "ingress-parse",    # socket read -> frame/args/header parsed
    "route",            # exchange match / route-cache lookup
    "enqueue",          # fanout into queue ready lists
    "replicate-ship",   # staging into the replication log
    "cluster-push",     # batched in the data-plane accumulator
    "flush-wait",       # request in flight to the owner + response
    "remote-apply",     # owner-side decode + push_local
    "deliver",          # render + write toward the consumer
    "settle",           # ack/drop (or delivery for no-ack consumers)
    "intra-shard-hop",  # UDS hop between sibling shards on one node
    "wal-append",       # encode + buffer a WAL record (synchronous)
    "wal-commit",       # the group write+fsync that made it durable
    "flow-throttle",    # publish parked at the overload gate before run
)
INGRESS_PARSE = 0
ROUTE = 1
ENQUEUE = 2
REPLICATE_SHIP = 3
CLUSTER_PUSH = 4
FLUSH_WAIT = 5
REMOTE_APPLY = 6
DELIVER = 7
SETTLE = 8
INTRA_SHARD_HOP = 9
WAL_APPEND = 10
WAL_COMMIT = 11
FLOW_THROTTLE = 12

STAGE_KEYS = tuple("trace_" + s.replace("-", "_") + "_us" for s in STAGES)

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
TRAILER_MAGIC = 0x54524330  # "0CRT" on the wire, read back as TRC0


class Trace:
    __slots__ = ("trace_id", "origin", "slots", "chaos_rules", "finished",
                 "pending_ns", "w3c", "attrs")

    def __init__(self, trace_id: str, origin: str) -> None:
        self.trace_id = trace_id
        self.origin = origin
        self.slots: list = [None] * len(STAGES)
        self.chaos_rules: list = []
        self.finished = False
        # scratch timestamp used by the data plane between submit and flush
        self.pending_ns = 0
        # propagated W3C context (otel.context.W3CContext) — None unless
        # the publish carried a valid traceparent header
        self.w3c = None
        # routing attributes (exchange/queue/vhost/tenant), stamped at
        # enqueue time for sampled messages only; drives /admin/traces
        # filtering and the OTLP resource/span attributes
        self.attrs: "dict | None" = None

    def attr(self, key: str, value) -> None:
        a = self.attrs
        if a is None:
            a = self.attrs = {}
        if key not in a:
            a[key] = value

    def span(self, stage: int, start_ns: int, end_ns: int, node: str) -> None:
        self.slots[stage] = (start_ns, end_ns, node)

    def tag_chaos(self, rule: str) -> None:
        if rule not in self.chaos_rules:
            self.chaos_rules.append(rule)

    def merge(self, other: "Trace") -> None:
        """Fold spans from a revived wire copy into this (parked) trace."""
        for i, s in enumerate(other.slots):
            if s is not None and self.slots[i] is None:
                self.slots[i] = s
        for rule in other.chaos_rules:
            self.tag_chaos(rule)
        if self.w3c is None:
            self.w3c = other.w3c
        if other.attrs:
            for key, value in other.attrs.items():
                self.attr(key, value)

    @property
    def span_count(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def bounds_ns(self) -> "tuple[int, int] | None":
        starts = [s[0] for s in self.slots if s is not None]
        if not starts:
            return None
        return min(starts), max(s[1] for s in self.slots if s is not None)

    @property
    def total_us(self) -> float:
        b = self.bounds_ns()
        return (b[1] - b[0]) / 1000.0 if b else 0.0

    def to_dict(self) -> dict:
        b = self.bounds_ns()
        stages = {}
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            start_ns, end_ns, node = s
            stages[STAGES[i]] = {
                "offset_us": round((start_ns - b[0]) / 1000.0, 1),
                "dur_us": round((end_ns - start_ns) / 1000.0, 1),
                "node": node,
            }
        out = {
            "id": self.trace_id,
            "origin": self.origin,
            "total_us": round(self.total_us, 1),
            "spans": self.span_count,
            "nodes": sorted({s[2] for s in self.slots if s is not None}),
            "chaos_rules": list(self.chaos_rules),
            "stages": stages,
        }
        if self.w3c is not None:
            out["w3c"] = self.w3c.to_dict()
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        return out

    # -- wire blob: u8 ver | ss id | ss origin | u8 nrules | ss rule* |
    #    u8 nspans | (u8 stage | u64 t0 | u64 t1 | ss node)*
    #    v2 appends: u8 has_w3c | [ss tid | ss parent | ss root |
    #    u8 flags | ss tracestate] | u8 nattrs | (ss key | ss value)*
    #    Old decoders read exactly the v1 fields and ignore the tail, so
    #    v2 is forward-compatible inside a mixed-version cluster.
    def to_blob(self) -> bytes:
        parts = [b"\x02"]
        for text in (self.trace_id, self.origin):
            enc = text.encode("utf-8")[:255]
            parts.append(bytes((len(enc),)))
            parts.append(enc)
        rules = self.chaos_rules[:255]
        parts.append(bytes((len(rules),)))
        for rule in rules:
            enc = rule.encode("utf-8")[:255]
            parts.append(bytes((len(enc),)))
            parts.append(enc)
        spans = [(i, s) for i, s in enumerate(self.slots) if s is not None]
        parts.append(bytes((len(spans),)))
        for i, (t0, t1, node) in spans:
            enc = node.encode("utf-8")[:255]
            parts.append(bytes((i,)))
            parts.append(_U64.pack(t0))
            parts.append(_U64.pack(t1))
            parts.append(bytes((len(enc),)))
            parts.append(enc)
        w3c = self.w3c
        if w3c is None:
            parts.append(b"\x00")
        else:
            parts.append(b"\x01")
            for text in (w3c.trace_id, w3c.parent_span_id,
                         w3c.root_span_id, w3c.tracestate or ""):
                enc = text.encode("utf-8")[:255]
                parts.append(bytes((len(enc),)))
                parts.append(enc)
            parts.append(bytes((w3c.flags & 0xFF,)))
        attrs = list((self.attrs or {}).items())[:255]
        parts.append(bytes((len(attrs),)))
        for key, value in attrs:
            for text in (key, str(value)):
                enc = text.encode("utf-8")[:255]
                parts.append(bytes((len(enc),)))
                parts.append(enc)
        return b"".join(parts)

    @classmethod
    def from_blob(cls, blob) -> "Trace":
        view = memoryview(blob)
        version = view[0]
        pos = 1

        def ss():
            nonlocal pos
            n = view[pos]; pos += 1
            text = bytes(view[pos:pos + n]).decode("utf-8"); pos += n
            return text

        tr = cls(ss(), ss())
        nrules = view[pos]; pos += 1
        for _ in range(nrules):
            tr.chaos_rules.append(ss())
        nspans = view[pos]; pos += 1
        for _ in range(nspans):
            stage = view[pos]; pos += 1
            t0 = _U64.unpack_from(view, pos)[0]; pos += 8
            t1 = _U64.unpack_from(view, pos)[0]; pos += 8
            node = ss()
            if stage < len(STAGES):
                tr.slots[stage] = (t0, t1, node)
        if version >= 2 and pos < len(view):
            if view[pos]:  # has_w3c flag (the byte itself consumed below)
                pos += 1
                tid, parent, root, state = ss(), ss(), ss(), ss()
                flags = view[pos]; pos += 1
                tr.w3c = W3CContext(tid, parent, root, flags=flags,
                                    tracestate=state or None)
            else:
                pos += 1
            nattrs = view[pos]; pos += 1
            for _ in range(nattrs):
                key = ss()
                tr.attr(key, ss())
        return tr


def encode_trailer(entries: Sequence["tuple[int, Trace]"]) -> bytes:
    """Trace contexts for records ``idx`` of a data-plane payload.

    Layout: ``u16 n | (u32 idx | u16 blob_len | blob)* | u32 body_len |
    u32 magic`` — the last 8 bytes let a receiver find the trailer from
    the payload tail without walking the records first.
    """
    parts = [_U16.pack(len(entries))]
    for idx, tr in entries:
        blob = tr.to_blob()
        parts.append(_U32.pack(idx))
        parts.append(_U16.pack(len(blob)))
        parts.append(blob)
    body = b"".join(parts)
    return body + _U32.pack(len(body)) + _U32.pack(TRAILER_MAGIC)


def decode_trailer(payload) -> "dict[int, Trace] | None":
    """Lift {record_idx: Trace} off a payload tail; None if absent."""
    view = memoryview(payload)
    total = len(view)
    if total < 10:
        return None
    try:
        if _U32.unpack_from(view, total - 4)[0] != TRAILER_MAGIC:
            return None
        blen = _U32.unpack_from(view, total - 8)[0]
        if blen < 2 or blen > total - 8:
            return None
        body = view[total - 8 - blen: total - 8]
        count = _U16.unpack_from(body, 0)[0]
        pos = 2
        out: "dict[int, Trace]" = {}
        for _ in range(count):
            idx = _U32.unpack_from(body, pos)[0]; pos += 4
            n = _U16.unpack_from(body, pos)[0]; pos += 2
            out[idx] = Trace.from_blob(body[pos:pos + n]); pos += n
        return out
    except (struct.error, IndexError, UnicodeDecodeError, ValueError):
        return None  # accidental magic match in an untraced payload


class TraceRuntime:
    """Sampling, span accounting, ring buffers, and cross-node stitching.

    Installed as the module-global ``trace.ACTIVE`` (same gating idiom as
    chaos): disabled means every seam is one module-attribute load plus
    an ``is None`` check.  The sampling RNG is seeded (defaulting to the
    chaos seed when a plan is installed) and consumes exactly one uniform
    draw per publish, so the sampled subset is deterministic for a given
    seed regardless of the sample rate.
    """

    def __init__(self, sample_rate: float = 0.01, ring_size: int = 256,
                 slow_ms: float = 250.0, metrics: Optional[Metrics] = None,
                 seed: int = 0, node: str = "local") -> None:
        self.rate = float(sample_rate)
        self.ring_size = int(ring_size)
        self.slow_ms = float(slow_ms)
        self.metrics = metrics
        self.node = node
        self.seed = seed
        self._rng = random.Random(seed)
        self._seq = 0
        # forced (W3C-propagated) samples number their own sequence and
        # never touch _rng/_seq: a headerless run stays draw-for-draw and
        # id-for-id identical whether or not this path exists
        self._wseq = 0
        # set by the OTLP exporter: called with each trace finish() lands
        # in the ring, off the per-message hot path
        self.export_hook = None
        # trace attached to the publish currently being processed; only
        # set/cleared around synchronous sections (never held across await)
        self.current: Optional[Trace] = None
        # stamped by the connection read loop; begin_publish discards it
        # when stale (previous chunk, idle connection)
        self.ingress_ns = 0
        # (t0, t1) stamped by a connection releasing held publishes; the
        # first sampled publish after the release carries the span, then
        # it is consumed (one park episode -> one flow-throttle span)
        self.flow_ns: Optional[tuple] = None
        self.ring: deque = deque(maxlen=self.ring_size)
        self.slow: deque = deque(maxlen=self.ring_size)
        self._inflight: "OrderedDict[str, Trace]" = OrderedDict()
        self._inflight_cap = max(4 * self.ring_size, 64)
        self._recent_fires: deque = deque(maxlen=64)
        if metrics is not None:
            for key in STAGE_KEYS:
                metrics.trace_stage_us.setdefault(key, Histogram())

    # -- sampling ----------------------------------------------------------
    def sample(self) -> bool:
        return self._rng.random() < self.rate

    def begin_publish(self, node: Optional[str] = None,
                      headers: Optional[dict] = None) -> Optional[Trace]:
        """One uniform draw; mint + stamp ingress-parse when sampled.

        Always (re)sets ``current`` so a previous publish's trace can
        never leak onto the next message.

        A valid ``traceparent`` in ``headers`` force-samples on a
        SEPARATE path that skips the draw entirely: the seeded sampling
        sequence (and the ``node#seq`` ids it mints) stays byte-identical
        for every publish that does not carry a context, which is what
        the same-seed soak determinism gates compare. A malformed header
        falls through to the normal seeded path without breaking the
        publish (W3C: restart the trace).
        """
        if headers is not None:
            ctx = _w3c_extract(headers)
            if ctx is not None:
                return self._begin_forced(node, ctx)
        if self._rng.random() >= self.rate:
            self.current = None
            return None
        node = node or self.node
        self._seq += 1
        tr = Trace(f"{node}#{self._seq}", node)
        self._stamp_ingress(tr, node)
        self.current = tr
        if self.metrics is not None:
            self.metrics.trace_sampled += 1
        return tr

    def _begin_forced(self, node: Optional[str], ctx: tuple) -> Trace:
        """Mint a force-sampled trace for a propagated W3C context.

        Ids are derived (otel.context), never drawn, and the forced
        sequence counter is separate from the seeded one — see
        begin_publish for why."""
        node = node or self.node
        tid, parent, flags, state = ctx
        self._wseq += 1
        tr = Trace(f"{node}#w{self._wseq}", node)
        tr.w3c = W3CContext(
            tid, parent,
            derive_span_id(tid, parent, node, str(self._wseq)),
            flags=flags | 0x01, tracestate=state)
        self._stamp_ingress(tr, node)
        self.current = tr
        if self.metrics is not None:
            self.metrics.trace_sampled += 1
            self.metrics.otel_forced_samples += 1
        return tr

    def begin_remote(self, ctx: tuple, node: Optional[str] = None,
                     attrs: Optional[dict] = None) -> Trace:
        """Force-sampled trace for a context that arrived INSIDE shipped
        data rather than on a live publish (federation segment apply):
        no ingress window to stamp, the caller owns the stage spans."""
        node = node or self.node
        tid, parent, flags, state = ctx
        self._wseq += 1
        tr = Trace(f"{node}#w{self._wseq}", node)
        tr.w3c = W3CContext(
            tid, parent,
            derive_span_id(tid, parent, node, str(self._wseq)),
            flags=flags | 0x01, tracestate=state)
        if attrs:
            tr.attrs = dict(attrs)
        if self.metrics is not None:
            self.metrics.trace_sampled += 1
            self.metrics.otel_forced_samples += 1
        return tr

    def _stamp_ingress(self, tr: Trace, node: str) -> None:
        now = time.perf_counter_ns()
        t0 = self.ingress_ns
        if not t0 or t0 > now or now - t0 > 50_000_000:
            t0 = now  # stale stamp: connection idle or different conn
        tr.span(INGRESS_PARSE, t0, now, node)
        flow = self.flow_ns
        if flow is not None:
            self.flow_ns = None
            f0, f1 = flow
            if f1 <= now and now - f1 <= 50_000_000:
                # same staleness bound as ingress: the span belongs to the
                # publish stream released just now, not an old episode
                tr.span(FLOW_THROTTLE, f0, f1, node)

    # -- cross-node bookkeeping -------------------------------------------
    def park(self, tr: Trace) -> None:
        """Keep an origin-side trace while it rides the data plane."""
        inf = self._inflight
        inf[tr.trace_id] = tr
        if len(inf) > self._inflight_cap:
            inf.popitem(last=False)
            if self.metrics is not None:
                self.metrics.trace_evicted += 1

    def adopt(self, tr: Trace) -> Trace:
        """Merge a revived wire copy with its parked origin half.

        The parked entry stays inflight until finish() — in-process
        multi-node runs share one runtime and adopt the same id from the
        push AND the deliver plane; popping on first adopt would fork the
        deliver-side spans onto a disconnected copy."""
        parked = self._inflight.get(tr.trace_id)
        if parked is not None and parked is not tr:
            parked.merge(tr)
            return parked
        return tr

    # -- chaos correlation -------------------------------------------------
    def note_chaos_fire(self, rule: str) -> None:
        self._recent_fires.append((time.perf_counter_ns(), rule))
        cur = self.current
        if cur is not None:
            cur.tag_chaos(rule)

    # -- completion --------------------------------------------------------
    def on_settle(self, tr: Trace, node: Optional[str] = None) -> None:
        if tr.finished:
            return
        now = time.perf_counter_ns()
        d = tr.slots[DELIVER]
        start = d[1] if d is not None else now
        tr.span(SETTLE, start, now, node or self.node)
        self.finish(tr)

    def finish(self, tr: Trace) -> None:
        if tr.finished:
            return
        tr.finished = True
        self._inflight.pop(tr.trace_id, None)
        b = tr.bounds_ns()
        if b is None:
            return
        lo, hi = b
        total_us = (hi - lo) / 1000.0
        m = self.metrics
        if m is not None:
            m.trace_completed += 1
            stage_hs = m.trace_stage_us
            for i, s in enumerate(tr.slots):
                if s is None:
                    continue
                h = stage_hs.get(STAGE_KEYS[i])
                if h is not None:
                    h.observe_us(max(0.0, (s[1] - s[0]) / 1000.0))
        # chaos fires inside the trace window tag it even if the fire
        # happened off the publish path (e.g. a data-plane send seam)
        for fire_ns, rule in self._recent_fires:
            if lo <= fire_ns <= hi:
                tr.tag_chaos(rule)
        self.ring.append(tr)
        slow = total_us >= self.slow_ms * 1000.0
        if slow or tr.chaos_rules:
            self.slow.append(tr)
            if m is not None:
                if slow:
                    m.trace_slow += 1
                if tr.chaos_rules:
                    m.trace_chaos_tagged += 1
        hook = self.export_hook
        if hook is not None:
            try:
                hook(tr)
            except Exception:  # pragma: no cover - exporter bug
                # span export must never break message completion
                self.export_hook = None

    # -- inspection --------------------------------------------------------
    def find(self, trace_id: str) -> Optional[Trace]:
        # prefer the copy with the most spans: in-process multi-node runs
        # share one runtime and may finalize a partial owner-side view too
        best: Optional[Trace] = None
        pools: "Iterable[Iterable[Trace]]" = (
            self.slow, self.ring, self._inflight.values())
        for pool in pools:
            for tr in pool:
                if tr.trace_id == trace_id:
                    if best is None or tr.span_count > best.span_count:
                        best = tr
        return best

    def query(self, *, queue: Optional[str] = None,
              exchange: Optional[str] = None, vhost: Optional[str] = None,
              tenant: Optional[str] = None, stage: Optional[str] = None,
              min_duration_us: float = 0, limit: int = 50) -> "list[Trace]":
        """Filtered view over the completed rings (slow first, then
        recent), newest first, deduped by id — the /admin/traces query
        layer. ``queue`` matches any member of the comma-joined queue
        attr (a fanout lands in several); ``stage`` requires the named
        stage slot to be populated."""
        stage_idx = STAGES.index(stage) if stage in STAGES else None
        out: "list[Trace]" = []
        seen: set = set()
        for pool in (self.slow, self.ring):
            for tr in reversed(pool):
                if tr.trace_id in seen:
                    continue
                seen.add(tr.trace_id)
                a = tr.attrs or {}
                if exchange is not None and a.get("exchange") != exchange:
                    continue
                if vhost is not None and a.get("vhost") != vhost:
                    continue
                if tenant is not None and a.get("tenant") != tenant:
                    continue
                if queue is not None and \
                        queue not in (a.get("queue") or "").split(","):
                    continue
                if stage is not None and (
                        stage_idx is None or tr.slots[stage_idx] is None):
                    continue
                if min_duration_us and tr.total_us < min_duration_us:
                    continue
                out.append(tr)
                if len(out) >= limit:
                    return out
        return out

    def status(self, limit: int = 20) -> dict:
        return {
            "node": self.node,
            "sample_rate": self.rate,
            "ring_size": self.ring_size,
            "slow_ms": self.slow_ms,
            "seed": self.seed,
            "sampled": self._seq,
            "forced": self._wseq,
            "completed_in_ring": len(self.ring),
            "inflight": len(self._inflight),
            "recent": [t.to_dict() for t in list(self.ring)[-limit:]],
            "slow": [t.to_dict() for t in list(self.slow)[-limit:]],
        }
