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
"""

from __future__ import annotations

import asyncio
import gc
import threading
import time
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
)
(INGRESS_PARSE, ROUTE, ENQUEUE, WAL_APPEND, WAL_COMMIT, CLUSTER_PUSH,
 DELIVER, SETTLE, FLOW_THROTTLE, DISPATCH, INGRESS_CYCLE, GC,
 TX_COMMIT) = range(13)

SUBSYSTEMS = (
    "broker", "router", "broker", "wal", "wal", "cluster",
    "broker", "broker", "flow", "broker", "broker", "runtime",
    "broker",
)

# stages whose windows tile the event loop without overlapping: their sum
# is the measured busy time the attribution ratio divides by process CPU
TOP_LEVEL = frozenset({INGRESS_CYCLE, DISPATCH, CLUSTER_PUSH})


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
            if not top and i != GC:
                # subsystem rollup from the fine stages only (the
                # top-level windows contain them; summing both would
                # double-count the same microseconds)
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
