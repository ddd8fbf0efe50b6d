"""Node lifecycle: graceful drain / decommission coordination.

The proactive half of the cluster's elasticity contract (the reactive
half — death promotion — lives in replicate/log.py). A drain walks the
gossiped per-node state machine

    joining -> active -> draining -> left

(states defined in membership.py, versioned independently of liveness so
they converge through the same heartbeat piggyback). Entering DRAINING:

- flips ``broker.draining`` so readiness (/admin/health) reports the node
  as leaving and load balancers stop sending new clients,
- removes the node from every peer's placement ring (placement_members),
  so no NEW holdership hashes onto it while it keeps serving what it
  still holds,
- then evacuates every held queue, smallest name first, through the
  existing ``handoff_queue`` machinery with bounded retry/backoff. Each
  evacuation passes a per-queue CONFIRM BARRIER first: outstanding
  deliveries settle, coalesced store buffers land, the group commit
  flushes (releasing publisher confirms and stream-cursor commits), and
  the replication sync gate drains — only then does holdership move, so
  nothing a client saw confirmed can be lost mid-move.

When the last queue is gone the node gossips LEFT. Queues that cannot
move (stream queues pin their segment log to the node's private store;
queues with locally-attached AMQP consumers) are reported as ``pinned``
and keep the node in DRAINING — the ``drain-stuck`` alert fires once the
evacuation budget is exceeded.

Every evacuation lands in a canonical log (sorted keys, no wall-clock
fields) so two same-seed chaos runs compare byte-for-byte — the same
replayability contract as the control plane's decision log.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import TYPE_CHECKING, Optional

from .. import chaos, events
from .membership import DRAINING, LEFT

if TYPE_CHECKING:  # pragma: no cover
    from .node import ClusterNode

log = logging.getLogger("chanamq.lifecycle")


class LifecycleCoordinator:
    """Owns one node's drain state machine and evacuation loop."""

    def __init__(
        self,
        node: "ClusterNode",
        *,
        retry_limit: int = 5,
        backoff_ms: int = 100,
        backoff_cap_ms: int = 2000,
        budget_s: float = 30.0,
        settle_timeout_s: float = 5.0,
    ) -> None:
        self.node = node
        self.retry_limit = max(1, int(retry_limit))
        self.backoff_s = max(0.001, backoff_ms / 1000.0)
        self.backoff_cap_s = max(self.backoff_s, backoff_cap_ms / 1000.0)
        self.budget_s = float(budget_s)
        self.settle_timeout_s = float(settle_timeout_s)
        # idle -> draining -> drained | stuck
        self.state = "idle"
        self.queues_total = 0
        self.queues_moved = 0
        self.retries = 0
        self.failed: list[str] = []
        self.pinned: list[str] = []
        self.current: Optional[str] = None
        self.log_entries: list[dict] = []
        self._started_mono: Optional[float] = None
        self._task: Optional[asyncio.Task] = None
        self._done = asyncio.Event()

    def _set_state(self, state: str) -> None:
        """Transition the drain state machine, announcing the move on the
        event bus (``lifecycle.<state>``) when one is installed."""
        self.state = state
        bus = events.ACTIVE
        if bus is not None:
            bus.emit(f"lifecycle.{state}", {
                "node": self.node.name, "state": state,
                "queues_total": self.queues_total,
                "queues_moved": self.queues_moved,
                "retries": self.retries,
            })

    # ------------------------------------------------------------------
    # public surface (admin + soak)
    # ------------------------------------------------------------------

    def drain(self) -> dict:
        """Start (or observe — idempotent) the drain. Returns progress;
        the evacuation itself runs as a background task."""
        if self._task is None:
            self.node.broker.metrics.lifecycle_drains_started += 1
            self._set_state("draining")
            self._started_mono = time.monotonic()
            self._done.clear()
            self._task = asyncio.get_event_loop().create_task(self._run())
        return self.progress()

    async def wait(self, timeout_s: Optional[float] = None) -> dict:
        """Block until the drain loop finishes (tests / soak)."""
        if self._task is not None:
            await asyncio.wait_for(self._done.wait(), timeout_s)
        return self.progress()

    def progress(self) -> dict:
        me = None
        if self.node.membership is not None:
            me = self.node.membership.members.get(self.node.name)
        elapsed = (time.monotonic() - self._started_mono
                   if self._started_mono is not None else 0.0)
        return {
            "state": self.state,
            "lifecycle": me.lifecycle if me is not None else "unknown",
            "queues_total": self.queues_total,
            "queues_moved": self.queues_moved,
            "retries": self.retries,
            "failed": list(self.failed),
            "pinned": list(self.pinned),
            "current": self.current,
            "elapsed_s": round(elapsed, 3),
            "budget_s": self.budget_s,
            "overdue": bool(self.drain_overdue()),
        }

    def drain_overdue(self) -> float:
        """1.0 while a drain has blown its evacuation budget without
        finishing — the telemetry probe behind the drain-stuck alert."""
        if self.state == "stuck":
            return 1.0
        if self.state != "draining" or self._started_mono is None:
            return 0.0
        return 1.0 if (time.monotonic() - self._started_mono
                       > self.budget_s) else 0.0

    def evacuation_log_bytes(self) -> bytes:
        """Canonical serialization of the evacuation log — the form the
        elasticity soak byte-compares across same-seed runs."""
        return "\n".join(
            json.dumps(entry, sort_keys=True, separators=(",", ":"))
            for entry in self.log_entries
        ).encode()

    # ------------------------------------------------------------------
    # evacuation loop
    # ------------------------------------------------------------------

    def _held_queues(self) -> list[tuple[str, str]]:
        """Queues this node currently holds AND has materialized, in a
        deterministic order."""
        node = self.node
        held = []
        for (vhost, name), meta in node.queue_metas.items():
            if meta.get("holder") != node.name:
                continue
            vh = node.broker.vhosts.get(vhost)
            queue = vh.queues.get(name) if vh is not None else None
            if queue is None or queue.deleted:
                continue
            if queue.exclusive_owner is not None:
                continue  # dies with its connection, never clustered
            held.append((vhost, name))
        return sorted(held)

    def _targets_for(self, vhost: str, name: str) -> list[str]:
        """Evacuation targets, best first: replica followers already
        holding a synced copy, then the ring's preference order, then any
        remaining placement-eligible member. Draining/left peers are
        never targets."""
        node = self.node
        membership = node.membership
        assert membership is not None
        eligible = [m for m in membership.placement_members()
                    if m != node.name]
        ordered: list[str] = []
        if node.replication is not None:
            repl = node.replication._logs.get((vhost, name))
            if repl is not None:
                followers = sorted(repl.followers.items(),
                                   key=lambda kv: (-kv[1], kv[0]))
                ordered.extend(n for n, _acked in followers
                               if n in eligible)
        for pref in node.ring.preference_entity(
                "q", vhost, name, len(eligible) + 1):
            if pref in eligible and pref not in ordered:
                ordered.append(pref)
        for member in eligible:
            if member not in ordered:
                ordered.append(member)
        return ordered

    async def _confirm_barrier(self, queue) -> bool:
        """Release everything a client could have been promised before
        the move: outstanding deliveries settle (bounded), coalesced
        store buffers land, the group commit flushes (publisher confirms
        + stream-cursor commits ride it), and live replication followers
        ack the log head."""
        node = self.node
        deadline = time.monotonic() + self.settle_timeout_s
        while queue.outstanding and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        if queue.outstanding:
            return False  # unsettled deliveries: not movable this pass
        queue.flush_store_buffers()
        await node.broker.store.flush(None)
        if node.replication is not None:
            await node.replication.sync_barrier()
        return True

    async def _evacuate_one(self, vhost: str, name: str) -> str:
        """Move one queue off this node: 'moved' | 'pinned' | 'failed'."""
        node = self.node
        vh = node.broker.vhosts.get(vhost)
        queue = vh.queues.get(name) if vh is not None else None
        if queue is None or queue.deleted \
                or node.queue_metas.get((vhost, name), {}).get("holder") \
                != node.name:
            return "moved"  # already gone (raced with a rebalance)
        if queue.is_stream:
            return "pinned"  # the segment log lives in this node's store
        from .node import RemoteConsumer

        if any(not isinstance(c, RemoteConsumer) for c in queue.consumers):
            return "pinned"  # local AMQP consumers cannot follow the queue
        if not await self._confirm_barrier(queue):
            return "failed"  # outstanding deliveries never settled
        targets = self._targets_for(vhost, name)
        if not targets:
            return "failed"
        delay = self.backoff_s
        for attempt in range(self.retry_limit):
            if chaos.ACTIVE is not None:
                # the kill-during-drain seam: a crash rule here takes the
                # node down with the evacuation half done
                await chaos.ACTIVE.fire("drain.tick", peer=node.name)
            target = targets[attempt % len(targets)]
            if await node.handoff_queue(vhost, name, target,
                                        decision=f"drain:{vhost}/{name}"):
                node.broker.metrics.lifecycle_queues_evacuated += 1
                self.log_entries.append({
                    "event": "evacuate", "vhost": vhost, "queue": name,
                    "target": target, "attempt": attempt + 1, "ok": True,
                })
                return "moved"
            self.retries += 1
            await asyncio.sleep(min(delay, self.backoff_cap_s))
            delay *= 2
        self.log_entries.append({
            "event": "evacuate", "vhost": vhost, "queue": name,
            "target": targets[0], "attempt": self.retry_limit, "ok": False,
        })
        return "failed"

    async def _run(self) -> None:
        node = self.node
        broker = node.broker
        try:
            broker.draining = True
            if node.membership is not None:
                node.membership.set_lifecycle(DRAINING)
            log.info("%s: drain started", node.name)
            deadline = time.monotonic() + self.budget_s
            first_pass = True
            while True:
                held = self._held_queues()
                if first_pass:
                    self.queues_total = len(held)
                    first_pass = False
                self.failed = []
                self.pinned = []
                progressed = False
                for vhost, name in held:
                    self.current = f"{vhost}/{name}"
                    outcome = await self._evacuate_one(vhost, name)
                    if outcome == "moved":
                        self.queues_moved += 1
                        progressed = True
                    elif outcome == "pinned":
                        self.pinned.append(f"{vhost}/{name}")
                    else:
                        self.failed.append(f"{vhost}/{name}")
                self.current = None
                if not self.failed:
                    break
                if not progressed and time.monotonic() >= deadline:
                    break
                await asyncio.sleep(min(self.backoff_s,
                                        self.backoff_cap_s))
            if not self.failed and not self.pinned:
                if node.membership is not None:
                    node.membership.set_lifecycle(LEFT)
                self._set_state("drained")
                log.info("%s: drain complete (%d queues evacuated)",
                         node.name, self.queues_moved)
            else:
                self._set_state("stuck")
                log.warning(
                    "%s: drain stuck (%d moved, failed=%s, pinned=%s)",
                    node.name, self.queues_moved, self.failed, self.pinned)
        except asyncio.CancelledError:
            self._set_state("stuck")
            raise
        except Exception:
            self._set_state("stuck")
            log.exception("%s: drain loop crashed", node.name)
        finally:
            self._done.set()
