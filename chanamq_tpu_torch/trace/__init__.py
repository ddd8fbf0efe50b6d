"""Message tracing gate — same idiom as :mod:`chanamq_tpu_torch.chaos`.

``ACTIVE`` is the module-level runtime; every hot-path seam costs one
module-attribute load plus an ``is None`` check when tracing is off, so
the disabled broker keeps its untraced numbers.  Enable via config::

    chana.mq.trace.enabled = true
    chana.mq.trace.sample-rate = 0.01
    chana.mq.trace.ring-size = 256
    chana.mq.trace.slow-ms = 250

or install a :class:`TraceRuntime` directly (tests, bench).
"""

from __future__ import annotations

from typing import Optional

from .runtime import (  # noqa: F401  (package API)
    CLUSTER_PUSH, DELIVER, ENQUEUE, FLOW_THROTTLE, FLUSH_WAIT, INGRESS_PARSE,
    INTRA_SHARD_HOP, REMOTE_APPLY, REPLICATE_SHIP, ROUTE, SETTLE, STAGE_KEYS,
    STAGES, WAL_APPEND, WAL_COMMIT, Trace, TraceRuntime, decode_trailer,
    encode_trailer,
)

ACTIVE: Optional[TraceRuntime] = None


def install(runtime: TraceRuntime) -> TraceRuntime:
    global ACTIVE
    ACTIVE = runtime
    return runtime


def clear() -> None:
    global ACTIVE
    ACTIVE = None


def current_trace_id() -> Optional[str]:
    """Trace id of the publish being processed right now, if sampled."""
    rt = ACTIVE
    if rt is None:
        return None
    cur = rt.current
    return cur.trace_id if cur is not None else None


def current_w3c_trace_id() -> Optional[str]:
    """The propagated W3C trace id of the current publish, if any — the
    join key structured logs share with exported spans and exemplars."""
    rt = ACTIVE
    if rt is None:
        return None
    cur = rt.current
    if cur is None or cur.w3c is None:
        return None
    return cur.w3c.trace_id


def enable_from_config(config, broker) -> Optional[TraceRuntime]:
    """Install tracing per the ``chana.mq.trace.*`` block.

    The sampling seed defaults to the installed chaos plan's seed so a
    seeded soak samples the same messages run over run.
    """
    if not config.bool("chana.mq.trace.enabled"):
        return None
    from .. import chaos  # lazy: avoid import cycle at package load

    if chaos.ACTIVE is not None:
        seed = chaos.ACTIVE.plan.seed
    else:
        seed = config.int("chana.mq.chaos.seed")
    runtime = TraceRuntime(
        sample_rate=float(config.get("chana.mq.trace.sample-rate")),
        ring_size=config.int("chana.mq.trace.ring-size"),
        slow_ms=float(config.get("chana.mq.trace.slow-ms")),
        metrics=broker.metrics,
        seed=seed,
        node=getattr(broker, "trace_node", "local"),
    )
    broker.trace_enabled = True
    return install(runtime)
