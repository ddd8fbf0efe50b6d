"""The MemoryAccountant: component cost gauges -> degradation ladder.

Design notes:

- Components are plain integers mutated by their owners. The two hot
  ones (`bodies` = resident message-body bytes, `held` = parked publish
  bytes) are pushed synchronously from Broker.account_memory /
  account_held so the ladder reacts within the publish that crosses a
  watermark — the same latency the old binary gate had. The cold ones
  (WAL memtable, data-plane buffers, connection out-buffers, stream
  sealed cache, chaos inflation) are POLLED once per broker sweep tick:
  hooking their hot-path mutations would tax every WAL append and every
  socket write for a signal that only needs sweep-tick freshness.

- The ladder has one enter threshold per stage and a matching exit
  threshold scaled by low/high, so every stage transition has the same
  hysteresis the old gate had and the broker cannot flap on a single
  oscillating publish/ack pair. Escalation is evaluated on every
  reevaluate() (a burst can jump several stages in one publish);
  de-escalation cascades the same way on a drain.

- Stage 2 (`throttle`) is wired to the broker's legacy memory gate:
  `broker.blocked` is exactly `stage >= STAGE_THROTTLE` (composed with
  the store-growth gate), so all the existing park/hold/resume and
  Connection.Blocked machinery keeps its contract unchanged.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Callable, Optional

log = logging.getLogger("chanamq.flow")

STAGE_NORMAL = 0
STAGE_PAGE = 1
STAGE_THROTTLE = 2
STAGE_CLUSTER = 3
STAGE_REFUSE = 4

STAGE_NAMES = ("normal", "page", "throttle", "cluster", "refuse")

# accounted cost sources; "bodies" and "held" are pushed synchronously,
# the rest sampled each sweep tick (see Broker._flow_tick)
COMPONENTS = (
    "bodies",           # resident message-body bytes (Broker.resident_bytes)
    "held",             # publish bodies parked at the gate (held_bytes)
    "out_buffers",      # rendered-but-unsent delivery frames per connection
    "wal_memtable",     # WAL bytes appended but not yet committed/settled
    "cluster_inflight", # data-plane push/settle bytes buffered per peer
    "stream_cache",     # sealed stream segment blobs resident in RAM
    "chaos",            # deterministic inflation from a memory-pressure rule
)


class MemoryAccountant:
    """Tracks accounted resident bytes and drives the 4-stage ladder."""

    def __init__(
        self,
        *,
        high_watermark: int,
        low_watermark: Optional[int] = None,
        page_watermark: Optional[int] = None,
        cluster_watermark: Optional[int] = None,
        hard_limit: Optional[int] = None,
        refuse_watermark: Optional[int] = None,
    ) -> None:
        hw = int(high_watermark)
        if hw <= 0:
            raise ValueError("flow high watermark must be positive")
        lw = int(low_watermark) if low_watermark is not None else int(hw * 0.8)
        if not 0 < lw < hw:
            log.warning(
                "flow low watermark %d outside (0, high=%d); "
                "clamping to 80%% of high", lw, hw)
            lw = int(hw * 0.8)
        hard = int(hard_limit) if hard_limit else 2 * hw
        hard = max(hard, hw + 1)
        refuse = int(refuse_watermark) if refuse_watermark else int(hard * 0.9)
        # enter thresholds must be strictly increasing page < hw < cluster
        # < refuse <= hard or a stage becomes unreachable / inverted
        refuse = min(max(refuse, hw + 1), hard)
        page = int(page_watermark) if page_watermark else int(hw * 0.6)
        page = min(max(page, 1), hw - 1) if hw > 1 else 1
        cluster = (int(cluster_watermark) if cluster_watermark
                   else (hw + refuse) // 2)
        cluster = min(max(cluster, hw + 1), refuse)
        self.high_watermark = hw
        self.low_watermark = lw
        self.hard_limit = hard
        # enter[s]: escalate to stage s while total > enter[s];
        # exit[s]: de-escalate below stage s while total <= exit[s].
        # exit scales each enter by low/high so stage 2 keeps the exact
        # legacy gate contract (block above high, unblock at/below low).
        self.enter = (0, page, hw, cluster, refuse)
        self.exit = tuple(e * lw // hw for e in self.enter)
        self.components: dict[str, int] = {name: 0 for name in COMPONENTS}
        self.stage = STAGE_NORMAL
        # minimum stage pinned by the predictive control plane
        # (chanamq_tpu/control/): a pre-arm decision raises the floor so
        # throttling engages BEFORE the watermark, through the exact same
        # listener/actuation chain as a reactive crossing; clearing it
        # lets the ladder settle back to the accounted total
        self.floor = STAGE_NORMAL
        self.total = 0
        self.peak_total = 0
        # fired as fn(old_stage, new_stage) on every transition
        self.listeners: list[Callable[[int, int], Any]] = []
        # cluster push handlers park on this below-stage-3 event so a
        # pressured owner delays push_many replies (the origin's stream
        # window fills and its publisher slows) instead of buffering
        self._below_cluster = asyncio.Event()
        self._below_cluster.set()

    @property
    def label(self) -> str:
        return STAGE_NAMES[self.stage]

    def add(self, component: str, delta: int) -> None:
        self.components[component] += delta
        self.reevaluate()

    def reevaluate(self) -> None:
        """Recompute the total and walk the ladder; fires listeners once
        per transition (never flaps: enter/exit gaps are the hysteresis).

        Ladder decisions deliberately EXCLUDE the ``held`` component:
        parked publishes can only drain once the gate reopens, so a gate
        that counted them could never reopen (the bytes it waits on are
        the bytes it parked). They are still reported/peaked as accounted
        cost — they are real memory — but as a bounded buffer (park cap
        per connection), not a gate input, exactly like the legacy gate."""
        total = 0
        for v in self.components.values():
            total += v
        self.total = total
        if total > self.peak_total:
            self.peak_total = total
        gate_total = total - self.components["held"]
        stage = self.stage
        while stage < STAGE_REFUSE and gate_total > self.enter[stage + 1]:
            stage += 1
        if stage == self.stage:
            while stage > STAGE_NORMAL and gate_total <= self.exit[stage]:
                stage -= 1
        if stage < self.floor:
            stage = self.floor
        if stage == self.stage:
            return
        old, self.stage = self.stage, stage
        if stage >= STAGE_CLUSTER:
            self._below_cluster.clear()
        else:
            self._below_cluster.set()
        log.warning(
            "flow stage %s -> %s (accounted=%d high=%d hard=%d)",
            STAGE_NAMES[old], STAGE_NAMES[stage], total,
            self.high_watermark, self.hard_limit)
        for listener in list(self.listeners):
            try:
                listener(old, stage)
            except Exception:
                log.exception("flow stage listener failed")

    async def cluster_stall(self, timeout: float = 0.25) -> None:
        """One bounded wait for pressure to drop below the cluster stage.
        Callers loop (or simply proceed after the timeout): a bounded
        stall per batch is pushback, an unbounded one is a deadlock."""
        if self._below_cluster.is_set():
            return
        try:
            await asyncio.wait_for(self._below_cluster.wait(), timeout)
        except asyncio.TimeoutError:
            pass

    def snapshot(self) -> dict:
        return {
            "stage": self.stage,
            "stage_label": self.label,
            "floor": self.floor,
            "total_bytes": self.total,
            "peak_bytes": self.peak_total,
            "high_watermark": self.high_watermark,
            "low_watermark": self.low_watermark,
            "hard_limit": self.hard_limit,
            "enter": list(self.enter),
            "exit": list(self.exit),
            "components": dict(self.components),
        }
