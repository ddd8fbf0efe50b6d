"""Deterministic fault injection (see plan.py for the fault model).

The broker's seams import this module once and gate on ``chaos.ACTIVE``:

    from .. import chaos
    ...
    if chaos.ACTIVE is not None:
        await chaos.ACTIVE.fire("rpc.call", peer=self._peer)

With chaos disabled (the default) ``ACTIVE`` stays ``None`` and every
seam costs a module-attribute load plus an is-None check — no allocation,
no call, no awaits. ``install``/``clear`` swap the hook at runtime (the
/admin/chaos endpoint uses them); ``enable_from_config`` is the boot-time
wiring that also swaps the broker's store for the injecting wrapper.
"""

from __future__ import annotations

import json
import logging
from typing import Optional

from .plan import Fault, FaultPlan, FaultRule
from .runtime import ChaosRuntime
from .store import ChaosStore

__all__ = [
    "ACTIVE", "Fault", "FaultPlan", "FaultRule", "ChaosRuntime",
    "ChaosStore", "install", "clear", "backoff_rng", "enable_from_config",
]

log = logging.getLogger("chanamq.chaos")

# THE hook. None = chaos off = seams are no-ops.
ACTIVE: Optional[ChaosRuntime] = None


def install(plan: FaultPlan, metrics=None) -> ChaosRuntime:
    """Activate ``plan``; returns the runtime (also visible as ACTIVE)."""
    global ACTIVE
    ACTIVE = ChaosRuntime(plan, metrics=metrics)
    log.info("chaos plan installed: seed=%d rules=%s fingerprint=%s",
             plan.seed, [r.name for r in plan.rules],
             plan.fingerprint()[:16])
    return ACTIVE


def clear() -> None:
    global ACTIVE
    if ACTIVE is not None:
        log.info("chaos plan cleared after %d fires", ACTIVE.plan.total_fires)
    ACTIVE = None


def backoff_rng():
    """Seeded RNG for reconnect jitter while chaos is active, else None
    (callers fall back to the module-level ``random``)."""
    runtime = ACTIVE
    return runtime.aux_rng() if runtime is not None else None


def enable_from_config(config, broker) -> bool:
    """Boot-time wiring, called from ``run_node`` before traffic starts.

    When ``chana.mq.chaos.enabled`` is set: mark the broker chaos-capable
    (gates /admin/chaos/install), wrap its store so store sites inject,
    and — if ``chana.mq.chaos.plan`` names a JSON plan file — install that
    plan seeded by ``chana.mq.chaos.seed`` (plan file seed wins if both).
    Returns True when chaos was enabled.
    """
    if not config.bool("chana.mq.chaos.enabled"):
        return False
    broker.chaos_enabled = True
    plan_path = config.get("chana.mq.chaos.plan")
    if plan_path:
        with open(plan_path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
        data.setdefault("seed", config.int("chana.mq.chaos.seed"))
        install(FaultPlan.from_dict(data), metrics=broker.metrics)
    # wrap through the lazy shim (not ACTIVE directly) so the store keeps
    # injecting across admin-driven install()/clear() cycles
    broker.store = ChaosStore(broker.store, _LazyRuntime())
    return True


class _LazyRuntime:
    """Delegates to whatever runtime is ACTIVE at call time, so a
    ChaosStore built at boot keeps working across install()/clear()."""

    def decide(self, site: str, peer: str = ""):
        runtime = ACTIVE
        return None if runtime is None else runtime.decide(site, peer)

    async def fire(self, site: str, peer: str = "", on_error=None):
        runtime = ACTIVE
        if runtime is None:
            return None
        return await runtime.fire(site, peer, on_error)
