"""Off-loop sampling profiler + event-loop stall watchdog.

One daemon thread does both jobs:

- at ``chana.mq.profile.sample-hz`` it snapshots the event-loop thread's
  stack via ``sys._current_frames()`` and folds it into a bounded
  ``stack -> count`` table (flamegraph collapsed format on read);
- between samples it checks the loop heartbeat the runtime's on-loop
  task writes: a beat older than ``slow-callback-ms`` means the loop is
  pinned inside one callback, so the watchdog captures that callback's
  live stack *while it runs* and, once the beat resumes, records the
  episode (duration + folded stack) into a bounded ring, emits a
  structured JSON log line, and bumps ``profile_slow_callbacks_total``
  — the existing loop-lag telemetry gets names, not just lag numbers.

Sampling happens entirely off-loop; the hot path never sees it. The GIL
grants the sampler a slice every switch interval (~5 ms), so stalls of
watchdog magnitude cannot hide from it.
"""

from __future__ import annotations

import logging
import sys
import threading
import time
from collections import deque

from .. import events

log = logging.getLogger("chanamq.profile")

# folded-stack table cap: beyond this, new unique stacks fold into the
# overflow bucket instead of growing memory without bound
_MAX_STACKS = 4096
_OVERFLOW_KEY = "<stack-table-full>"


def fold_stack(frame, max_depth: int = 64) -> str:
    """Collapse a frame chain into ``root;...;leaf`` with
    ``name (file:line)`` entries — flamegraph.pl's collapsed format."""
    parts: list[str] = []
    depth = 0
    while frame is not None and depth < max_depth:
        code = frame.f_code
        fname = code.co_filename.rsplit("/", 1)[-1]
        parts.append(f"{code.co_name} ({fname}:{frame.f_lineno})")
        frame = frame.f_back
        depth += 1
    parts.reverse()
    return ";".join(parts) if parts else "<no-frames>"


class Sampler(threading.Thread):
    def __init__(self, runtime) -> None:
        super().__init__(name="chanamq-profile-sampler", daemon=True)
        self.runtime = runtime
        hz = runtime.sample_hz
        slow_ms = runtime.slow_callback_ms
        if hz > 0:
            self.interval = 1.0 / hz
        else:
            # watchdog-only cadence: check at a quarter of the threshold
            self.interval = max(slow_ms / 4000.0, 0.01)
        self.stacks: dict[str, int] = {}
        self.samples = 0
        self.ring: deque = deque(maxlen=runtime.ring_size)
        self.slow_count = 0
        self._stop = threading.Event()
        # in-flight stall episode: (first-seen beat, captured stack, max lag)
        self._stall_beat = 0
        self._stall_stack = ""
        self._stall_max_ns = 0

    def shutdown(self) -> None:
        self._stop.set()

    def run(self) -> None:
        rt = self.runtime
        sample = rt.sample_hz > 0
        slow_ns = rt.slow_callback_ms * 1_000_000
        while not self._stop.wait(self.interval):
            frames = sys._current_frames()
            loop_frame = frames.get(rt.loop_thread_id)
            if sample and loop_frame is not None:
                self.samples += 1
                if rt.metrics is not None:
                    rt.metrics.profile_samples_total += 1
                key = fold_stack(loop_frame)
                if key in self.stacks or len(self.stacks) < _MAX_STACKS:
                    self.stacks[key] = self.stacks.get(key, 0) + 1
                else:
                    self.stacks[_OVERFLOW_KEY] = (
                        self.stacks.get(_OVERFLOW_KEY, 0) + 1)
            beat = rt.beat_ns
            if not slow_ns or not beat:
                continue
            lag_ns = time.monotonic_ns() - beat
            if lag_ns > slow_ns + self.interval * 2e9:
                # loop pinned: capture the offending callback's stack the
                # first time we see this episode, track the worst lag
                if self._stall_beat != beat:
                    self._stall_beat = beat
                    self._stall_stack = (
                        fold_stack(loop_frame) if loop_frame is not None
                        else "<no-frames>")
                    self._stall_max_ns = lag_ns
                elif lag_ns > self._stall_max_ns:
                    self._stall_max_ns = lag_ns
            elif self._stall_beat:
                self._finish_stall()

    def _finish_stall(self) -> None:
        rt = self.runtime
        duration_ms = round(self._stall_max_ns / 1e6, 1)
        entry = {
            "ts": round(time.time(), 3),
            "duration_ms": duration_ms,
            "stack": self._stall_stack,
        }
        self._stall_beat = 0
        self._stall_max_ns = 0
        self.ring.append(entry)
        self.slow_count += 1
        if rt.metrics is not None:
            rt.metrics.profile_slow_callbacks_total += 1
        node = rt.node
        broker = rt.broker
        if broker is not None:
            node = getattr(broker, "trace_node", None) or node
        # structured line: logjson merges the `data` dict into the JSON
        # object, so the stack is machine-joinable against /admin/profile
        log.warning(
            "slow event-loop callback: %.1f ms", duration_ms,
            extra={"data": {"node": node, "duration_ms": duration_ms,
                            "stack": self._stall_stack}})
        bus = events.ACTIVE
        if bus is not None:
            # sampler thread -> loop thread: the bus publishes AMQP
            # messages, which only the owning loop may do
            bus.emit_threadsafe("profile.slow-callback", {
                "duration_ms": duration_ms, "stack": entry["stack"],
            })

    def collapsed(self) -> str:
        rows = sorted(self.stacks.items(), key=lambda kv: (-kv[1], kv[0]))
        return "\n".join(f"{stack} {count}" for stack, count in rows)
