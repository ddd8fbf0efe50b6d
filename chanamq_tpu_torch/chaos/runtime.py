"""Chaos runtime: the live object behind the module-level hook.

The broker's I/O seams gate every injection on ``chaos.ACTIVE is not None``
— one module-attribute load and an identity check when chaos is disabled,
so the production hot path stays branch-predictable and allocation-free.
When a plan is installed, ``ACTIVE`` points at a ``ChaosRuntime`` which
owns the plan, bumps ``chaos_*`` metrics per fired kind, and dispatches
``crash`` faults to harness-registered handlers.

``fire(site, ...)`` is the convenience most seams use: it consults the
plan, applies ``latency`` in place (asyncio sleep), raises for ``error``
and ``partition`` via the caller's exception factory, and hands every
other kind back so the seam can do the transport-specific thing (drop a
frame, close a writer, desync a stream).
"""

from __future__ import annotations

import asyncio
import logging
import random
from typing import Callable, Optional

from .. import events, trace
from .plan import Fault, FaultPlan

log = logging.getLogger("chanamq.chaos")

# metrics counter per fault kind (all registered in utils/metrics.py)
_KIND_COUNTERS = {
    "latency": "chaos_latency",
    "error": "chaos_errors",
    "drop": "chaos_drops",
    "disconnect": "chaos_disconnects",
    "corrupt": "chaos_corrupt_frames",
    "crash": "chaos_crashes",
    "partition": "chaos_partition_drops",
    "pressure": "chaos_pressure",
}


class ChaosRuntime:
    """One installed plan plus the machinery around it."""

    def __init__(self, plan: FaultPlan, metrics=None) -> None:
        self.plan = plan
        self.metrics = metrics
        # dedicated stream for consumers that want seeded-deterministic
        # randomness while chaos is active (e.g. ReconnectBackoff jitter)
        self._aux_rng = random.Random(plan.seed ^ 0x5EED_CA05)
        self._crash_handlers: dict[str, Callable[[], None]] = {}

    # -- seam API ----------------------------------------------------------

    def decide(self, site: str, peer: str = "") -> Optional[Fault]:
        """Consult the plan; account for the fault but leave acting on it
        to the caller. Crash faults are dispatched here (the handler is a
        harness callback, not a transport behavior) and swallowed."""
        fault = self.plan.decide(site, peer)
        if fault is None:
            return None
        self._account(fault, site)
        if fault.kind == "crash":
            self._dispatch_crash(fault)
            return None
        return fault

    async def fire(self, site: str, peer: str = "",
                   on_error: Optional[Callable[[Fault], BaseException]] = None,
                   ) -> Optional[Fault]:
        """decide() plus the kind-independent behaviors: sleep latency,
        raise error/partition. Returns the fault for kinds the seam must
        handle itself (drop / disconnect / corrupt), else None."""
        fault = self.decide(site, peer)
        if fault is None:
            return None
        if fault.kind == "latency":
            if fault.delay_s > 0:
                await asyncio.sleep(fault.delay_s)
            return None
        if fault.kind in ("error", "partition"):
            if on_error is not None:
                raise on_error(fault)
            raise OSError(f"chaos[{fault.rule}]: {fault.message}")
        return fault

    def aux_rng(self) -> random.Random:
        return self._aux_rng

    # -- crash dispatch ----------------------------------------------------

    def on_crash(self, node: str, handler: Callable[[], None]) -> None:
        """Register the harness callback that 'crashes' ``node`` when a
        crash rule naming it fires."""
        self._crash_handlers[node] = handler

    def _dispatch_crash(self, fault: Fault) -> None:
        rule = next(r for r in self.plan.rules if r.name == fault.rule)
        targets = rule.nodes or list(self._crash_handlers)
        for node in targets:
            handler = self._crash_handlers.pop(node, None)
            if handler is None:
                log.warning("chaos crash rule %r: no handler for node %r",
                            fault.rule, node)
                continue
            log.info("chaos: crashing node %r (rule %r)", node, fault.rule)
            try:
                handler()
            except Exception:
                log.exception("chaos crash handler for %r failed", node)

    # -- accounting --------------------------------------------------------

    def _account(self, fault: Fault, site: str) -> None:
        m = self.metrics
        if m is not None:
            m.chaos_fires += 1
            counter = _KIND_COUNTERS.get(fault.kind)
            if counter is not None:
                setattr(m, counter, getattr(m, counter) + 1)
        if trace.ACTIVE is not None:
            # fault -> latency causality: tag the in-flight trace (if any)
            # and remember the fire so traces whose window covers it get
            # tagged at finish (chanamq_tpu/trace/)
            trace.ACTIVE.note_chaos_fire(fault.rule)
        bus = events.ACTIVE
        if bus is not None:
            bus.emit(f"chaos.fired.{fault.rule}", {
                "rule": fault.rule, "kind": fault.kind, "site": site,
            })
        log.debug("chaos fire: rule=%s kind=%s site=%s",
                  fault.rule, fault.kind, site)

    # -- introspection (the /admin/chaos body) -----------------------------

    def status(self) -> dict:
        return {
            "seed": self.plan.seed,
            "fingerprint": self.plan.fingerprint(),
            "total_fires": self.plan.total_fires,
            "rules": self.plan.counters(),
            "fire_log_tail": [
                {"n": n, "rule": rule, "site": site}
                for n, rule, site in self.plan.fire_log[-50:]
            ],
        }
