"""SLO engine: rolling error budgets + multi-window multi-burn-rate alerts.

The Google SRE alerting shape over the broker's own telemetry: each
declarative :class:`SLOSpec` names a service-level indicator (a good/bad
event stream the telemetry tick derives from counters it already samples),
an objective (e.g. 0.999 → a 0.1% error budget), and two window *pairs* —
a fast pair (5 m / 1 h at 1 s ticks) that catches budget-torching
incidents in minutes, and a slow pair (6 h / 3 d) that catches slow leaks.
A pair alerts only when BOTH its windows burn above the pair's threshold:
the long window proves the burn is sustained, the short window proves it
is still happening (so the alert also clears promptly).

burn_rate(window) = (bad/total over the window) / (1 - objective) —
1.0 means the budget is being consumed exactly at the rate that exhausts
it at the window's end; 14.4 (the classic fast threshold) exhausts a
30-day budget in 2 days.

Determinism (the AlertEngine/ControlEngine contract): ``evaluate(tick,
samples)`` is a pure function of the per-tick good/bad samples — no wall
clock, no randomness — so the seeded soaks assert firings exactly and the
burn-rate math is testable against a hand-computed oracle.

Memory: windows are tracked as cumulative (good, bad) totals in two fixed
rings — per-tick for the last ``FINE`` ticks (exact for the fast pair) and
one sample every ``COARSE`` ticks for the long horizon (a 3-day window at
1 s ticks costs 2 float64 rings of 8192, not a 259200-slot buffer; the
window edge quantizes to the coarse stride, deterministically).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

FINE = 4096          # exact per-tick cumulative history
COARSE = 64          # stride of the coarse cumulative ring
COARSE_SLOTS = 8192  # * COARSE ticks = 524288-tick horizon (~6 d at 1 s)

#: SLI kinds the telemetry tick knows how to sample (slo/__init__.py).
SLI_KINDS = (
    "publish-success",    # good=accepted publishes, bad=refused+returned
    "delivery-success",   # good=deliveries, bad=dead-lettered+expired
    "readiness",          # one sample per tick: /admin/health ready?
    "delivery-latency",   # one sample per tick: delta p99 <= threshold?
    "federation-lag",     # one sample per tick: link lag <= record budget?
)


@dataclass(frozen=True)
class SLOSpec:
    """One declarative objective over an SLI stream.

    Window fields are in ticks; ``from_config``/``specs_from_json`` scale
    from wall durations by the telemetry interval. ``threshold_ms`` only
    applies to latency SLIs (a tick is bad when its delta p99 exceeds it).
    """

    name: str
    sli: str
    objective: float = 0.999
    threshold_ms: float = 250.0
    fast_windows: tuple = (300, 3600)      # (short, long) ticks
    slow_windows: tuple = (21600, 259200)
    fast_burn: float = 14.4
    slow_burn: float = 6.0
    budget_window: int = 259200
    severity: str = "critical"
    #: tenant-scoped objective (chanamq_tpu_torch/tenancy/): the spec evaluates
    #: the tenant's OWN good/bad stream (sample key "<sli>@<tenant>") with
    #: an independent error budget; None = node-wide stream, as before
    tenant: Optional[str] = None

    def sample_key(self) -> str:
        """The key this spec reads from the per-tick samples dict."""
        return self.sli if self.tenant is None else f"{self.sli}@{self.tenant}"

    def as_dict(self) -> dict:
        return {
            "name": self.name, "sli": self.sli,
            "objective": self.objective, "threshold_ms": self.threshold_ms,
            "fast_windows": list(self.fast_windows),
            "slow_windows": list(self.slow_windows),
            "fast_burn": self.fast_burn, "slow_burn": self.slow_burn,
            "budget_window": self.budget_window, "severity": self.severity,
            "tenant": self.tenant,
        }


def default_slos(interval_s: float = 1.0, *, objective: float = 0.999,
                 latency_ms: float = 250.0, fast_burn: float = 14.4,
                 slow_burn: float = 6.0) -> list[SLOSpec]:
    """The built-in objectives, window durations scaled to ticks."""
    def ticks(seconds: float) -> int:
        return max(1, int(round(seconds / max(interval_s, 1e-9))))

    fast = (ticks(300), ticks(3600))
    slow = (ticks(21600), ticks(259200))
    budget = ticks(259200)
    common = dict(fast_windows=fast, slow_windows=slow,
                  budget_window=budget, fast_burn=fast_burn,
                  slow_burn=slow_burn)
    return [
        SLOSpec("publish-availability", "publish-success",
                objective=objective, **common),
        SLOSpec("delivery-success", "delivery-success",
                objective=objective, **common),
        SLOSpec("readiness", "readiness", objective=objective, **common),
        SLOSpec("delivery-latency-p99", "delivery-latency",
                objective=max(0.99, objective - 0.009),
                threshold_ms=latency_ms, **common),
    ]


def specs_from_json(raw: list, interval_s: float = 1.0) -> list[SLOSpec]:
    """Build specs from POST /admin/slo/configure (or config-file) dicts.
    Window fields may be given in seconds (``*_windows_s``) or ticks."""
    def ticks(seconds: float) -> int:
        return max(1, int(round(float(seconds) / max(interval_s, 1e-9))))

    specs = []
    for item in raw:
        if not isinstance(item, dict) or not item.get("name"):
            raise ValueError("each spec needs at least a name")
        sli = item.get("sli", "publish-success")
        if sli not in SLI_KINDS:
            raise ValueError(f"unknown sli {sli!r} (have {SLI_KINDS})")
        tenant = item.get("tenant")
        if tenant is not None and (not isinstance(tenant, str) or not tenant):
            raise ValueError(
                f"spec {item['name']!r}: tenant must be a non-empty string")
        kw = dict(
            name=str(item["name"]), sli=sli,
            objective=float(item.get("objective", 0.999)),
            threshold_ms=float(item.get("threshold_ms", 250.0)),
            fast_burn=float(item.get("fast_burn", 14.4)),
            slow_burn=float(item.get("slow_burn", 6.0)),
            severity=str(item.get("severity", "critical")),
            tenant=tenant,
        )
        if "fast_windows_s" in item:
            kw["fast_windows"] = tuple(ticks(s) for s in item["fast_windows_s"])
        elif "fast_windows" in item:
            kw["fast_windows"] = tuple(int(t) for t in item["fast_windows"])
        if "slow_windows_s" in item:
            kw["slow_windows"] = tuple(ticks(s) for s in item["slow_windows_s"])
        elif "slow_windows" in item:
            kw["slow_windows"] = tuple(int(t) for t in item["slow_windows"])
        if "budget_window_s" in item:
            kw["budget_window"] = ticks(item["budget_window_s"])
        elif "budget_window" in item:
            kw["budget_window"] = int(item["budget_window"])
        spec = SLOSpec(**kw)
        for pair in (spec.fast_windows, spec.slow_windows):
            if len(pair) != 2 or pair[0] > pair[1]:
                raise ValueError(
                    f"spec {spec.name!r}: window pair must be "
                    f"(short, long) with short <= long, got {pair}")
        if not 0.0 < spec.objective < 1.0:
            raise ValueError(
                f"spec {spec.name!r}: objective must be in (0, 1)")
        specs.append(spec)
    return specs


class _Track:
    """Cumulative good/bad rings for one spec (see module docstring)."""

    __slots__ = ("cum_good", "cum_bad", "fine", "coarse", "start_tick")

    def __init__(self) -> None:
        self.cum_good = 0.0
        self.cum_bad = 0.0
        # column 0 = cumulative good, column 1 = cumulative bad
        self.fine = np.zeros((FINE, 2), dtype=np.float64)
        self.coarse = np.zeros((COARSE_SLOTS, 2), dtype=np.float64)
        self.start_tick: Optional[int] = None

    def push(self, tick: int, good: float, bad: float) -> None:
        if self.start_tick is None:
            self.start_tick = tick
        self.cum_good += good
        self.cum_bad += bad
        self.fine[tick % FINE, 0] = self.cum_good
        self.fine[tick % FINE, 1] = self.cum_bad
        if tick % COARSE == 0:
            self.coarse[(tick // COARSE) % COARSE_SLOTS, 0] = self.cum_good
            self.coarse[(tick // COARSE) % COARSE_SLOTS, 1] = self.cum_bad

    def _cum_at(self, tick: int, target: int) -> tuple[float, float]:
        """Cumulative totals as of tick ``target`` (quantized to the
        coarse stride beyond the fine horizon; (0, 0) before start)."""
        if self.start_tick is None or target < self.start_tick:
            return (0.0, 0.0)
        if tick - target < FINE:
            row = self.fine[target % FINE]
            return (float(row[0]), float(row[1]))
        ctarget = (target // COARSE) * COARSE
        if ctarget < self.start_tick or tick - ctarget >= COARSE * COARSE_SLOTS:
            return (0.0, 0.0)
        row = self.coarse[(ctarget // COARSE) % COARSE_SLOTS]
        return (float(row[0]), float(row[1]))

    def window(self, tick: int, window: int) -> tuple[float, float]:
        """(good, bad) deltas over the trailing ``window`` ticks."""
        g0, b0 = self._cum_at(tick, tick - window)
        return (self.cum_good - g0, self.cum_bad - b0)


class SLOEngine:
    """Tick-driven burn-rate evaluator over declarative SLO specs."""

    HISTORY = 256  # retained burn/clear events for /admin/slo

    def __init__(self, specs: list[SLOSpec]) -> None:
        if not specs:
            raise ValueError("SLOEngine needs at least one spec")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.specs = list(specs)
        self._tracks = {s.name: _Track() for s in self.specs}
        # (spec name, pair name) -> info dict while the pair is burning
        self.firing: dict[tuple, dict] = {}
        self.history: deque = deque(maxlen=self.HISTORY)
        self.fired_total = 0
        self.cleared_total = 0
        self.violations: dict[str, int] = {s.name: 0 for s in self.specs}
        self.tick = 0

    # -- evaluation --------------------------------------------------------

    @staticmethod
    def burn_rate(good: float, bad: float, objective: float) -> float:
        total = good + bad
        if total <= 0.0:
            return 0.0
        return (bad / total) / max(1.0 - objective, 1e-12)

    def budget_remaining(self, spec: SLOSpec) -> float:
        """Fraction of the error budget left over the budget window:
        1.0 = untouched, 0.0 = exhausted, negative = overspent."""
        track = self._tracks[spec.name]
        good, bad = track.window(self.tick, spec.budget_window)
        total = good + bad
        if total <= 0.0:
            return 1.0
        allowed = (1.0 - spec.objective) * total
        return 1.0 - bad / max(allowed, 1e-12)

    def evaluate(self, tick: int,
                 samples: dict[str, tuple[float, float]]) -> list[dict]:
        """One tick. ``samples`` maps SLI kind -> (good, bad) deltas for
        this tick. Returns burn/clear transition events in deterministic
        spec order. Pure: same tick series in, same events out."""
        self.tick = tick
        events: list[dict] = []
        for spec in self.specs:
            track = self._tracks[spec.name]
            good, bad = samples.get(spec.sample_key(), (0.0, 0.0))
            track.push(tick, float(good), float(bad))
            for pair_name, windows, threshold in (
                ("fast", spec.fast_windows, spec.fast_burn),
                ("slow", spec.slow_windows, spec.slow_burn),
            ):
                b_short = self.burn_rate(
                    *track.window(tick, windows[0]), spec.objective)
                b_long = self.burn_rate(
                    *track.window(tick, windows[1]), spec.objective)
                fkey = (spec.name, pair_name)
                burning = b_short > threshold and b_long > threshold
                if burning and fkey not in self.firing:
                    info = {
                        "slo": spec.name, "pair": pair_name,
                        "sli": spec.sli, "severity": spec.severity,
                        "tenant": spec.tenant,
                        "burn_short": round(b_short, 4),
                        "burn_long": round(b_long, 4),
                        "threshold": threshold,
                        "windows": list(windows),
                        "budget_remaining": round(
                            self.budget_remaining(spec), 6),
                        "since_tick": tick,
                    }
                    self.firing[fkey] = info
                    self.fired_total += 1
                    self.violations[spec.name] += 1
                    events.append({"event": "burn", **info})
                elif fkey in self.firing:
                    if b_short <= threshold:
                        # the short window recovered: the burn stopped
                        info = self.firing.pop(fkey)
                        self.cleared_total += 1
                        events.append({
                            "event": "clear", **info,
                            "burn_short": round(b_short, 4),
                            "burn_long": round(b_long, 4),
                            "cleared_tick": tick,
                            "ticks": tick - info["since_tick"],
                        })
                    else:
                        self.firing[fkey]["burn_short"] = round(b_short, 4)
                        self.firing[fkey]["burn_long"] = round(b_long, 4)
        self.history.extend(events)
        return events

    # -- snapshots ---------------------------------------------------------

    def slo_status(self, spec: SLOSpec) -> dict:
        track = self._tracks[spec.name]
        tick = self.tick
        burns = {}
        for pair_name, windows in (("fast", spec.fast_windows),
                                   ("slow", spec.slow_windows)):
            for label, w in zip(("short", "long"), windows):
                good, bad = track.window(tick, w)
                burns[f"{pair_name}_{label}"] = {
                    "window_ticks": w,
                    "good": good, "bad": bad,
                    "burn_rate": round(
                        self.burn_rate(good, bad, spec.objective), 4),
                }
        return {
            **spec.as_dict(),
            "budget_remaining": round(self.budget_remaining(spec), 6),
            "burn": burns,
            "burning": sorted(
                pair for (name, pair) in self.firing if name == spec.name),
            "violations_total": self.violations[spec.name],
            "totals": {"good": track.cum_good, "bad": track.cum_bad},
        }

    def snapshot(self) -> dict:
        return {
            "tick": self.tick,
            "slos": [self.slo_status(s) for s in self.specs],
            "firing": sorted(
                self.firing.values(),
                key=lambda i: (i["slo"], i["pair"])),
            "fired_total": self.fired_total,
            "cleared_total": self.cleared_total,
            "recent": list(self.history),
        }

    def readiness_stamp(self) -> dict:
        """The compact block stamped onto the /admin/health payload."""
        return {
            "burning": sorted(
                f"{name}:{pair}" for (name, pair) in self.firing),
            "budget_remaining": {
                s.name: round(self.budget_remaining(s), 6)
                for s in self.specs
            },
        }
