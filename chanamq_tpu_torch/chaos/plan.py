"""Seeded deterministic fault plans.

A ``FaultPlan`` is a list of named ``FaultRule``s plus one RNG seed. Every
injection site the broker threads (store read/write/delete/flush, rpc
call/connect/read-loop, data-plane send/read, replication shipping) calls
``decide(site, ...)`` once per operation; the plan answers with a ``Fault``
to inject or ``None``.

Determinism contract: whether a rule fires on its Nth *matching* invocation
is a pure function of ``(seed, rule name, N)`` — each rule draws from its
own ``random.Random`` keyed by the seed and a stable CRC of the rule name,
one draw per eligible invocation. Two runs with the same seed therefore
carry the identical fault schedule: the same invocation indices fire, in
the same order, regardless of wall-clock timing. ``schedule_preview``
materializes that schedule up front so harnesses can fingerprint it.

Triggers compose per rule:

- ``probability`` — chance a matching invocation fires (drawn from the
  rule's seeded RNG; 1.0 = always);
- ``count``      — max total fires (None = unlimited);
- ``after`` / ``until`` — the matching-invocation window [after, until)
  inside which the rule is armed (both in invocation index, not time, so
  the window is deterministic too).

Fault kinds and what the seams do with them:

``latency``     sleep ``delay_ms`` then proceed
``error``       raise at the seam (store: OSError; rpc/data: RpcError)
``drop``        lose the unit silently (a frame, an event, a ship batch)
``disconnect``  close the transport so the reconnect path runs
``corrupt``     desync the byte stream (read loops raise FrameTooLarge)
``crash``       invoke the harness-registered crash handler for ``nodes``
``partition``   like ``error`` but only when the ctx peer is in ``nodes``
                (A<->B partition = traffic toward the named nodes fails)
``pressure``    inflate the flow accountant's ``chaos`` component by
                ``inflate_bytes`` for this sweep tick (site ``flow.tick``)
                so memory-overload behavior is injectable deterministically
"""

from __future__ import annotations

import hashlib
import json
import random
import zlib
from dataclasses import dataclass, field
from fnmatch import fnmatchcase
from typing import Any, Optional

FAULT_KINDS = (
    "latency", "error", "drop", "disconnect", "corrupt", "crash", "partition",
    "pressure",
)

# fire-log ring bound: enough to replay a soak, small enough to forget
_FIRE_LOG_MAX = 4096


@dataclass(slots=True)
class Fault:
    """One injected fault, handed to the seam that asked."""

    kind: str
    rule: str
    delay_s: float = 0.0
    code: str = "chaos"
    message: str = ""
    inflate_bytes: int = 0


@dataclass
class FaultRule:
    """One named fault source. See module docstring for field semantics."""

    name: str
    kind: str
    sites: list[str] = field(default_factory=lambda: ["*"])
    probability: float = 1.0
    count: Optional[int] = None
    after: int = 0
    until: Optional[int] = None
    peer: Optional[str] = None          # glob on the ctx peer ("host:port")
    delay_ms: float = 0.0
    code: str = "chaos"
    message: str = ""
    nodes: list[str] = field(default_factory=list)  # crash / partition targets
    inflate_bytes: int = 0              # pressure: accounted-cost inflation

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if not self.name:
            raise ValueError("fault rule needs a name")
        self.probability = min(1.0, max(0.0, float(self.probability)))

    def matches_site(self, site: str) -> bool:
        return any(fnmatchcase(site, pattern) for pattern in self.sites)

    def matches_ctx(self, peer: str) -> bool:
        if self.kind == "partition":
            # partition semantics: only traffic TOWARD the named nodes fails
            return peer in self.nodes
        if self.peer is not None:
            return fnmatchcase(peer, self.peer)
        return True

    def to_dict(self) -> dict:
        return {
            "name": self.name, "kind": self.kind, "sites": list(self.sites),
            "probability": self.probability, "count": self.count,
            "after": self.after, "until": self.until, "peer": self.peer,
            "delay_ms": self.delay_ms, "code": self.code,
            "message": self.message, "nodes": list(self.nodes),
            "inflate_bytes": self.inflate_bytes,
        }

    @classmethod
    def from_dict(cls, data: dict) -> "FaultRule":
        known = {
            "name", "kind", "sites", "probability", "count", "after",
            "until", "peer", "delay_ms", "code", "message", "nodes",
            "inflate_bytes",
        }
        return cls(**{k: v for k, v in data.items() if k in known})


class _RuleState:
    """Mutable per-rule run state: the seeded RNG plus the counters the
    admin endpoint dumps."""

    __slots__ = ("rule", "rng", "invocations", "fires")

    def __init__(self, rule: FaultRule, seed: int) -> None:
        self.rule = rule
        self.rng = random.Random(_rule_seed(seed, rule.name))
        self.invocations = 0
        self.fires = 0


def _rule_seed(seed: int, name: str) -> int:
    # zlib.crc32, not hash(): str hashing is salted per process and would
    # break the cross-run determinism contract
    return (int(seed) * 1_000_003) ^ zlib.crc32(name.encode("utf-8"))


class FaultPlan:
    """A seeded set of fault rules with per-rule fire accounting."""

    def __init__(self, seed: int, rules: list[FaultRule]) -> None:
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names in plan: {names}")
        self.seed = int(seed)
        self.rules = list(rules)
        self._states = [_RuleState(r, self.seed) for r in self.rules]
        # realized fire sequence: (global fire index, rule, site), bounded
        self.fire_log: list[tuple[int, str, str]] = []
        self.total_fires = 0

    # -- the decision ------------------------------------------------------

    def decide(self, site: str, peer: str = "") -> Optional[Fault]:
        """One injection-point consultation. First armed rule that matches
        and draws a fire wins (rules are ordered; put rare ones first)."""
        for state in self._states:
            rule = state.rule
            if not rule.matches_site(site) or not rule.matches_ctx(peer):
                continue
            state.invocations += 1
            if not self._eligible(state):
                continue
            if rule.probability < 1.0 and state.rng.random() >= rule.probability:
                continue
            state.fires += 1
            self.total_fires += 1
            if len(self.fire_log) < _FIRE_LOG_MAX:
                self.fire_log.append((self.total_fires, rule.name, site))
            return Fault(
                kind=rule.kind, rule=rule.name,
                delay_s=rule.delay_ms / 1000.0, code=rule.code,
                message=rule.message or f"injected by rule {rule.name!r}",
                inflate_bytes=rule.inflate_bytes)
        return None

    @staticmethod
    def _eligible(state: _RuleState) -> bool:
        rule = state.rule
        n = state.invocations  # 1-based index of THIS invocation
        if n <= rule.after:
            return False
        if rule.until is not None and n > rule.until:
            return False
        if rule.count is not None and state.fires >= rule.count:
            return False
        return True

    # -- introspection -----------------------------------------------------

    def counters(self) -> dict[str, dict]:
        return {
            s.rule.name: {
                "kind": s.rule.kind, "invocations": s.invocations,
                "fires": s.fires,
            }
            for s in self._states
        }

    def schedule_preview(self, horizon: int = 1000) -> dict[str, list[int]]:
        """The deterministic fire schedule: for each rule, the matching-
        invocation indices (1-based) that would fire within ``horizon``
        invocations. Computed from fresh RNGs — never consumes plan state —
        so it is a pure function of (seed, rules) and safe to fingerprint."""
        out: dict[str, list[int]] = {}
        for rule in self.rules:
            rng = random.Random(_rule_seed(self.seed, rule.name))
            fires: list[int] = []
            for n in range(1, horizon + 1):
                if n <= rule.after:
                    continue
                if rule.until is not None and n > rule.until:
                    break
                if rule.count is not None and len(fires) >= rule.count:
                    break
                if rule.probability >= 1.0 or rng.random() < rule.probability:
                    fires.append(n)
            out[rule.name] = fires
        return out

    def fingerprint(self, horizon: int = 1000) -> str:
        """SHA-256 over (seed, rule specs, fire schedule): two plans with
        the same seed and rules — across processes and runs — fingerprint
        identically; any drift in the schedule changes it. Endpoint
        bindings (``nodes``) are excluded: they name this deployment's
        ephemeral host:port strings, not anything that alters the
        per-invocation decision schedule."""
        specs = []
        for rule in self.rules:
            spec = rule.to_dict()
            spec.pop("nodes", None)
            specs.append(spec)
        blob = json.dumps({
            "seed": self.seed,
            "rules": specs,
            "schedule": self.schedule_preview(horizon),
        }, sort_keys=True).encode("utf-8")
        return hashlib.sha256(blob).hexdigest()

    # -- (de)serialization (the /admin/chaos install body) -----------------

    def to_dict(self) -> dict:
        return {"seed": self.seed, "rules": [r.to_dict() for r in self.rules]}

    @classmethod
    def from_dict(cls, data: Any) -> "FaultPlan":
        if not isinstance(data, dict):
            raise ValueError("fault plan must be a JSON object")
        rules = data.get("rules")
        if not isinstance(rules, list) or not rules:
            raise ValueError("fault plan needs a non-empty 'rules' list")
        return cls(
            seed=int(data.get("seed", 0)),
            rules=[FaultRule.from_dict(r) for r in rules])
