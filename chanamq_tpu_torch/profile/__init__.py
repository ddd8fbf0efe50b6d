"""Continuous performance observability (``chana.mq.profile.*``).

Three coupled parts, all always-cheap enough to leave on in production:

- a **per-message cost ledger**: the hot-path seams that already carry
  trace spans (ingress-parse / route / enqueue / wal-append / wal-commit /
  cluster-push / deliver / settle) accumulate aggregate per-stage
  CPU-ns and invocation counts into fixed numpy accumulators. There is no
  sampling decision on the hot path: every seam is gated on the same
  module-level ``ACTIVE is None`` check chaos and trace use, and the
  per-message stages accumulate at batch granularity wherever a batch
  exists (router flush, dispatch pass, scan pass), so the enabled cost
  stays inside the 2% budget ``bench.py --profile-overhead`` enforces.
- a **sampling wall profiler + stall attribution**: an off-loop thread
  samples ``sys._current_frames()`` into folded-stack counts (flamegraph
  collapsed format at ``GET /admin/profile/stacks``), doubles as the
  event-loop watchdog that captures the stack and duration of any
  callback stalling the loop past ``chana.mq.profile.slow-callback-ms``,
  and a ``gc.callbacks`` hook attributes collector pauses.
- the aggregate view at ``GET /admin/profile``: µs/msg by stage and by
  subsystem plus the fraction of process CPU the ledger attributes.
- the forecast service's worker thread (subsystem ``forecast``): a
  round, its batch build, train steps (forward, backward, update), the
  wait on the card and the forecast, and with the Moonlight backbone each
  layer's ``mla-attention`` and ``moe-route`` / ``-dispatch`` /
  ``-experts`` / ``-combine``, through ``span``; each also opens a torch
  profiler range of its name (``record_function``'s C form), and the last
  ``ring_size`` rounds' spans are kept for ``GET /admin/profile``.

Like ``trace`` and ``chaos``: disabled (the default) costs one module
attribute load + ``is None`` per seam (``span``: a call besides, and a
shared no-op context).
"""

from __future__ import annotations

import contextlib
from typing import Optional

from .runtime import (  # noqa: F401 — re-exported page for the seams
    CLUSTER_PUSH, DELIVER, DISPATCH, ENQUEUE, FLOW_THROTTLE,
    FORECAST_BATCH, FORECAST_PREDICT, FORECAST_ROUND, FORECAST_WAIT, GC,
    INGRESS_CYCLE, INGRESS_PARSE, MLA_ATTENTION, MOE_COMBINE, MOE_DISPATCH,
    MOE_EXPERTS, MOE_ROUTE, PARENT, ROUTE, SETTLE, STAGES,
    SUBSYSTEMS, TOP_LEVEL, TRAIN_BACKWARD, TRAIN_FORWARD, TRAIN_STEP,
    TRAIN_UPDATE, TX_COMMIT, WAL_APPEND, WAL_COMMIT, ProfileRuntime, Span,
)

# The gate. Hot-path seams do `prof = profile.ACTIVE` then
# `if prof is not None:` — one module attribute load when disabled.
ACTIVE: Optional[ProfileRuntime] = None


_OFF = contextlib.nullcontext()


def span(stage: int):
    """The seam of a forecast stage, ``with profile.span(stage): ...``:
    the active runtime's ``Span`` (ledger, profiler range, round ring), or
    a shared no-op context when profiling is off."""
    prof = ACTIVE
    return _OFF if prof is None else Span(prof, stage)


def install(runtime: ProfileRuntime) -> ProfileRuntime:
    global ACTIVE
    ACTIVE = runtime
    return runtime


def clear() -> None:
    global ACTIVE
    if ACTIVE is not None:
        ACTIVE.stop()
    ACTIVE = None


def enable_from_config(config, broker) -> ProfileRuntime:
    """Boot-time wiring (``chana.mq.profile.enabled``): build the runtime
    from the knobs, hang it off the broker for the admin surface, install
    the gate, and start the sampler/watchdog/GC hooks."""
    runtime = ProfileRuntime(
        metrics=broker.metrics,
        sample_hz=config.int("chana.mq.profile.sample-hz"),
        slow_callback_ms=config.int("chana.mq.profile.slow-callback-ms"),
        ring_size=config.int("chana.mq.profile.ring-size"),
        gc_hook=config.bool("chana.mq.profile.gc"),
        broker=broker,
    )
    broker.profile = runtime
    install(runtime)
    runtime.start()
    return runtime
