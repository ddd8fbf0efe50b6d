"""The per-message cost ledger and its aggregate view.

Stage indices are append-only (the Prometheus series and the admin
payload key off the names; reordering would silently re-label recorded
history on a scrape boundary). Two granularities coexist:

- **fine stages** mirror the trace seams (route, enqueue, wal-append,
  deliver, ...) and count *messages* in ``stage_calls``, so
  ``ns / calls`` reads directly as µs per message for that stage; they
  are wall windows (== CPU whenever the loop isn't preempted);
- **top-level stages** (``ingress-cycle``, ``dispatch``,
  ``cluster-push``) wrap whole event-loop work windows measured in
  **loop-thread CPU** (``time.thread_time_ns``), with any top-level
  window that ran inside an awaiting window subtracted back out
  (connection.py's ingress seam), so their sum never double-counts and
  is immune to CPU steal from sibling processes. The attribution claim
  is ``busy_ns / loop_cpu_ns`` — both visible in ``snapshot()``.

Fine stages nest inside top-level ones by design (route happens inside
an ingress cycle); only top-level stages are summed for attribution.

The ``forecast`` subsystem's stages are the forecast service's worker
thread, not the event loop: a round (``forecast-round``), inside it the
batch build, each train step, the wait on the card for the round's loss
and the forecast, and inside each step its forward, backward and update.
They are fine stages, wall time (``perf_counter_ns``), and their
``stage_calls`` count calls (rounds or steps), not messages. Their seam is
``span`` (``profile.span``): besides the ledger it opens a torch
profiler range of the stage's name (``record_function``'s C form), so a
profiler's trace carries the same names on its own clock, and it keeps
the last ``ring_size`` rounds' spans (``snapshot()["forecast"]``). Only
``forecast-round`` enters the subsystem rollup (its children lie inside
it).
"""

from __future__ import annotations

import asyncio
import gc
import itertools
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

STAGES = (
    "ingress-parse",   # 0  native frame scan, per read-chunk pass
    "route",           # 1  binding resolution (cache, matcher, or kernel)
    "enqueue",         # 2  Message build + store insert + queue.push fanout
    "wal-append",      # 3  WAL frame encode + ingest (pre-commit)
    "wal-commit",      # 4  group-commit write+fsync window (wall, batched)
    "cluster-push",    # 5  origin-side push-batch encode + flush
    "deliver",         # 6  dispatch-pass delivery rendering loop
    "settle",          # 7  ack/reject store cleanup + unrefer
    "flow-throttle",   # 8  publish-gate park window (wall, per episode)
    "dispatch",        # 9  whole coalesced dispatch pass (top-level)
    "ingress-cycle",   # 10 whole read-chunk consume cycle (top-level)
    "gc",              # 11 collector pauses (gc.callbacks)
    "tx-commit",       # 12 Tx.Commit staged replay: scope open -> sealed
    "forecast-round",  # 13 ForecastService._round (worker thread, a round)
    "forecast-batch",  # 14 normalization, training batch, copy to the card
    "train-step",      # 15 one train step
    "train-forward",   # 16 the step's loss (forward)
    "train-backward",  # 17 the step's gradients (autograd)
    "train-update",    # 18 the step's clipped momentum update
    "forecast-wait",   # 19 reading the round's loss: waits for the card
    "forecast-predict",  # 20 recast, forward, readback, de-normalization
    # the Moonlight backbone's layers, in its forward (models/moonlight.py)
    "mla-attention",   # 21 a layer's latent attention, norm to residual add
    "moe-route",       # 22 a mixture layer's router, top-k and weights
    "moe-dispatch",    # 23 its sort into expert groups and row gather
    "moe-experts",     # 24 its grouped expert products and shared experts
    "moe-combine",     # 25 its weighted combine and residual add
)
(INGRESS_PARSE, ROUTE, ENQUEUE, WAL_APPEND, WAL_COMMIT, CLUSTER_PUSH,
 DELIVER, SETTLE, FLOW_THROTTLE, DISPATCH, INGRESS_CYCLE, GC,
 TX_COMMIT, FORECAST_ROUND, FORECAST_BATCH, TRAIN_STEP, TRAIN_FORWARD,
 TRAIN_BACKWARD, TRAIN_UPDATE, FORECAST_WAIT,
 FORECAST_PREDICT, MLA_ATTENTION, MOE_ROUTE, MOE_DISPATCH, MOE_EXPERTS,
 MOE_COMBINE) = range(26)

SUBSYSTEMS = (
    "broker", "router", "broker", "wal", "wal", "cluster",
    "broker", "broker", "flow", "broker", "broker", "runtime",
    "broker", "forecast", "forecast", "forecast", "forecast", "forecast",
    "forecast", "forecast", "forecast",
    "forecast", "forecast", "forecast", "forecast", "forecast",
)

# the stage each forecast stage runs inside (a round's spans nest so)
PARENT = {
    FORECAST_BATCH: FORECAST_ROUND, TRAIN_STEP: FORECAST_ROUND,
    TRAIN_FORWARD: TRAIN_STEP, TRAIN_BACKWARD: TRAIN_STEP,
    TRAIN_UPDATE: TRAIN_STEP, FORECAST_WAIT: FORECAST_ROUND,
    FORECAST_PREDICT: FORECAST_ROUND,
    # a forward's layer stages: in a train step's forward (in a forecast
    # they run inside forecast-predict)
    MLA_ATTENTION: TRAIN_FORWARD, MOE_ROUTE: TRAIN_FORWARD,
    MOE_DISPATCH: TRAIN_FORWARD, MOE_EXPERTS: TRAIN_FORWARD,
    MOE_COMBINE: TRAIN_FORWARD,
}
# the stages whose spans carry their train step's index
_IN_STEP = frozenset({TRAIN_STEP, TRAIN_FORWARD, TRAIN_BACKWARD,
                      TRAIN_UPDATE})

# stages whose windows tile the event loop without overlapping: their sum
# is the measured busy time the attribution ratio divides by process CPU
TOP_LEVEL = frozenset({INGRESS_CYCLE, DISPATCH, CLUSTER_PUSH})


_range_type = None


def _profiler_range(name: str):
    """A profiler range named ``name`` (a context): torch's C range, what
    its own generated code opens (no dispatcher op; it records only while
    a profiler runs), or the public ``record_function`` where a build
    lacks it."""
    global _range_type
    if _range_type is None:
        import torch

        _range_type = getattr(torch._C._profiler, "_RecordFunctionFast",
                              None) or torch.profiler.record_function
    return _range_type(name)


class _OpenRound(threading.local):
    """The round open on this thread: ``(id, spans)`` or None, and the
    index of its current train step."""

    round = None
    step = -1


class Span:
    """A forecast stage's seam (``profile.span``): times its body
    into the ledger, opens a profiler range of the stage's name around it,
    and files ``[stage, step, start_ns, end_ns]`` in the round open on its
    thread (a ``forecast-round`` span opens and closes the round)."""

    __slots__ = ("prof", "stage", "rec", "range")

    def __init__(self, prof: "ProfileRuntime", stage: int) -> None:
        self.prof = prof
        self.stage = stage

    def __enter__(self) -> "Span":
        stage, open_ = self.stage, self.prof._open
        if stage == FORECAST_ROUND:
            open_.round = (next(self.prof._round_ids), [])
            open_.step = -1
        elif stage == TRAIN_STEP:
            open_.step += 1
        self.rec = [stage, open_.step if stage in _IN_STEP else None,
                    time.perf_counter_ns(), 0]
        if open_.round is not None:
            open_.round[1].append(self.rec)
        # the range opens and closes inside the span's own stamps
        self.range = _profiler_range(STAGES[stage])
        self.range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.range.__exit__(*exc)
        t1 = time.perf_counter_ns()
        rec, prof, stage = self.rec, self.prof, self.stage
        rec[3] = t1
        prof.stage_ns[stage] += t1 - rec[2]
        prof.stage_calls[stage] += 1
        if stage == FORECAST_ROUND:
            round_id, spans = prof._open.round
            prof._open.round = None
            prof.forecast_rounds.append(
                (round_id, tuple(tuple(r) for r in spans)))


class ProfileRuntime:
    """Fixed accumulators + the sampler/watchdog/GC hooks around them.

    ``stage_ns`` / ``stage_calls`` are fixed int64 numpy vectors; seams
    add into them directly (``prof.stage_ns[profile.ROUTE] += dt``) so
    the enabled hot path is two array adds, no method call, no dict, no
    allocation. Everything else (snapshot math, subsystem rollup) runs
    on the admin path only.
    """

    def __init__(
        self,
        node: str = "local",
        metrics=None,
        *,
        sample_hz: int = 0,
        slow_callback_ms: int = 100,
        ring_size: int = 64,
        gc_hook: bool = True,
        broker=None,
    ) -> None:
        self.node = node
        self.metrics = metrics
        self.broker = broker
        self.sample_hz = max(0, int(sample_hz))
        self.slow_callback_ms = max(0, int(slow_callback_ms))
        self.ring_size = max(1, int(ring_size))
        self.gc_hook = gc_hook
        self.stage_ns = np.zeros(len(STAGES), dtype=np.int64)
        self.stage_calls = np.zeros(len(STAGES), dtype=np.int64)
        # attribution denominators since enable: loop-thread CPU (the
        # busy ratio's), process CPU and wall (context). thread_time is
        # per-thread, so _tcpu0_ns is only meaningful against reads from
        # the same thread — start() re-stamps it on the loop thread and
        # snapshot() runs there too (the admin server shares the loop)
        self._tcpu0_ns = time.thread_time_ns()
        self._cpu0_ns = time.process_time_ns()
        self._wall0_ns = time.perf_counter_ns()
        # loop heartbeat for the watchdog (monotonic ns, written by the
        # heartbeat task; read by the sampler thread — GIL-atomic int)
        self.beat_ns = 0
        self.loop_thread_id = threading.get_ident()
        self.sampler = None
        self._hb_task: Optional[asyncio.Task] = None
        self._gc_t0 = 0
        self.gc_pauses = 0
        self.gc_pause_ns = 0
        self.gc_max_pause_ns = 0
        self._started = False
        # the last ring_size forecast rounds: (id, ((stage, step, start_ns,
        # end_ns), ...)) in start order, appended whole when a round ends
        self.forecast_rounds: deque = deque(maxlen=self.ring_size)
        self._round_ids = itertools.count(1)
        self._open = _OpenRound()

    # -- lifecycle ----------------------------------------------------------

    def start(self, loop: Optional[asyncio.AbstractEventLoop] = None) -> None:
        """Arm the off-ledger parts. Callable without a running loop (unit
        tests drive the ledger alone); the heartbeat task only starts when
        one is available."""
        if self._started:
            return
        self._started = True
        self.loop_thread_id = threading.get_ident()
        self._tcpu0_ns = time.thread_time_ns()
        if self.gc_hook:
            gc.callbacks.append(self._on_gc)
        if loop is None:
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                loop = None
        if loop is not None and self.slow_callback_ms > 0:
            self.beat_ns = time.monotonic_ns()
            self._hb_task = loop.create_task(self._heartbeat())
        if self.sample_hz > 0 or (
                loop is not None and self.slow_callback_ms > 0):
            from .sampler import Sampler

            self.sampler = Sampler(self)
            self.sampler.start()

    def stop(self) -> None:
        if not self._started:
            return
        self._started = False
        if self.gc_hook:
            try:
                gc.callbacks.remove(self._on_gc)
            except ValueError:
                pass
        if self._hb_task is not None:
            self._hb_task.cancel()
            self._hb_task = None
        if self.sampler is not None:
            self.sampler.shutdown()
            self.sampler = None

    async def _heartbeat(self) -> None:
        # beats 4x faster than the stall threshold so a missing beat means
        # the loop really is inside one long callback, not between beats
        interval = max(self.slow_callback_ms / 4000.0, 0.005)
        try:
            while True:
                self.beat_ns = time.monotonic_ns()
                await asyncio.sleep(interval)
        except asyncio.CancelledError:
            pass

    # -- GC pauses ----------------------------------------------------------

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter_ns()
        elif phase == "stop" and self._gc_t0:
            dt = time.perf_counter_ns() - self._gc_t0
            self._gc_t0 = 0
            self.stage_ns[GC] += dt
            self.stage_calls[GC] += 1
            self.gc_pauses += 1
            self.gc_pause_ns += dt
            if dt > self.gc_max_pause_ns:
                self.gc_max_pause_ns = dt
            m = self.metrics
            if m is not None:
                m.profile_gc_pauses_total += 1
                m.profile_gc_pause_ns_total += dt

    # -- cold-path helper (tests, non-seam callers) --------------------------

    def note(self, stage: int, dt_ns: int, calls: int = 1) -> None:
        self.stage_ns[stage] += dt_ns
        self.stage_calls[stage] += calls

    # -- aggregate view ------------------------------------------------------

    def snapshot(self) -> dict:
        """The /admin/profile payload: per-stage and per-subsystem µs plus
        the attribution ratio. Pure reads — safe on the admin path."""
        ns = self.stage_ns
        calls = self.stage_calls
        loop_cpu_ns = time.thread_time_ns() - self._tcpu0_ns
        cpu_ns = time.process_time_ns() - self._cpu0_ns
        wall_ns = time.perf_counter_ns() - self._wall0_ns
        stages = {}
        subsystems: dict = {}
        busy_ns = 0
        for i, name in enumerate(STAGES):
            n, c = int(ns[i]), int(calls[i])
            top = i in TOP_LEVEL
            stages[name] = {
                "subsystem": SUBSYSTEMS[i],
                "ns": n,
                "calls": c,
                "us_per_call": round(n / c / 1000.0, 3) if c else None,
                "top_level": top,
            }
            if top:
                busy_ns += n
            if not top and i != GC and i not in PARENT:
                # subsystem rollup from the fine stages only (the
                # top-level windows contain them, and a forecast round
                # its children; summing both would double-count the same
                # microseconds)
                sub = subsystems.setdefault(
                    SUBSYSTEMS[i], {"ns": 0, "calls": 0})
                sub["ns"] += n
                sub["calls"] += c
        out = {
            # follow the cluster's rename of the node tag (trace does the
            # same): "local" until ClusterNode.start names this node
            "node": (self.broker.trace_node
                     if self.broker is not None else self.node),
            "stages": stages,
            "subsystems": subsystems,
            "busy_ns": busy_ns,
            "loop_cpu_ns": loop_cpu_ns,
            "process_cpu_ns": cpu_ns,
            "wall_ns": wall_ns,
            "attributed_pct": (
                round(busy_ns / loop_cpu_ns * 100.0, 1)
                if loop_cpu_ns > 0 else None),
            "gc": {
                "pauses": self.gc_pauses,
                "pause_ns": self.gc_pause_ns,
                "max_pause_ns": self.gc_max_pause_ns,
            },
            "forecast": {"rounds": [
                {"round": round_id, "spans": [
                    {"stage": STAGES[stage], "step": step,
                     "parent": (STAGES[PARENT[stage]]
                                if stage in PARENT else None),
                     "start_ns": t0, "end_ns": t1}
                    for stage, step, t0, t1 in spans]}
                for round_id, spans in list(self.forecast_rounds)]},
        }
        sampler = self.sampler
        if sampler is not None:
            out["sampler"] = {
                "hz": self.sample_hz,
                "samples": sampler.samples,
                "distinct_stacks": len(sampler.stacks),
            }
            out["slow_callbacks"] = {
                "threshold_ms": self.slow_callback_ms,
                "count": sampler.slow_count,
                "recent": list(sampler.ring),
            }
        else:
            out["sampler"] = {"hz": self.sample_hz, "samples": 0,
                              "distinct_stacks": 0}
            out["slow_callbacks"] = {
                "threshold_ms": self.slow_callback_ms,
                "count": 0, "recent": []}
        return out

    def stage_detail(self, name: str) -> Optional[dict]:
        if name not in STAGES:
            return None
        i = STAGES.index(name)
        c = int(self.stage_calls[i])
        n = int(self.stage_ns[i])
        return {
            "stage": name,
            "subsystem": SUBSYSTEMS[i],
            "ns": n,
            "calls": c,
            "us_per_call": round(n / c / 1000.0, 3) if c else None,
            "top_level": i in TOP_LEVEL,
        }

    def collapsed(self) -> str:
        """Folded stacks in flamegraph collapsed format (one ``stack
        count`` line each), hottest first."""
        sampler = self.sampler
        if sampler is None:
            return ""
        return sampler.collapsed()
