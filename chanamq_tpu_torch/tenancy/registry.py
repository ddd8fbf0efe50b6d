"""Tenant registry: named principals owning vhosts, with quotas and ACLs.

A tenant is a named principal that owns one or more vhosts and carries a
:class:`TenantQuota`. Enforcement deliberately reuses machinery that
already exists instead of adding hot-path branches:

- **publish rate** is a per-tenant token bucket (refilled on the broker
  sweep tick, deterministically, at ``publish-rate`` bytes/sec up to
  ``publish-burst``). When the bucket empties the tenant's connections
  flip their ``_throttled`` flag and publishes park at the SAME hold gate
  the memory ladder uses; while parked, ``_spend_tenant_credit`` draws the
  flow layer's per-connection publish-credit grant from whatever tokens the bucket
  has re-accrued, so drain resumes at exactly the quota rate.
- **memory share** is a per-tenant stage floor on the flow ladder: when a
  tenant's resident queue bytes exceed ``memory-share`` x the broker's
  memory high watermark, the tenant is pinned at ``STAGE_THROTTLE`` (its
  publishers hold) until it drains below the exit ratio — the same
  enter/exit hysteresis shape the accountant itself uses.
- **connection/channel/queue/binding caps** are checked at the existing
  declare/open mutation sites (Connection.Open, Channel.Open,
  Broker.declare_queue, Broker.bind_queue); the checks return error text
  and the call sites raise the protocol-appropriate refusal.

Auth: each tenant may declare a ``users`` table (user -> password) and an
``acls`` table (user -> vhost -> subset of configure/write/read,
RabbitMQ's permission triple). The registry merges tenant users into the
server-wide SASL PLAIN table and derives vhost allowlists, so declaring a
tenant at runtime (``POST /admin/tenants``) takes effect on the next
handshake without restarting listeners.

Determinism: every gate transition appends to ``decision_log`` with only
deterministic fields (tenant, reason, token/byte counts — no wall clock),
so two same-seed soak runs produce byte-identical logs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..flow.accountant import STAGE_NORMAL, STAGE_THROTTLE
from ..utils.metrics import Histogram

ACL_PERMS = ("configure", "write", "read")

#: hysteresis: a memory-share floor lifts once the tenant drains to this
#: fraction of its share (mirrors the accountant's exit = 0.8 * enter)
MEMORY_EXIT_RATIO = 0.8

_QUOTA_KEYS = frozenset({
    "max-connections", "max-channels", "max-queues", "max-bindings",
    "memory-share", "publish-rate", "publish-burst",
})


class TenancyError(ValueError):
    """Invalid tenant/quota spec: 400 at the admin surface, ConfigError at
    boot. Deliberately not a BrokerError — the registry must stay
    importable without the broker module."""


def _int_field(raw: dict, key: str) -> int:
    value = raw.get(key, 0)
    if isinstance(value, bool) or not isinstance(value, int) or value < 0:
        raise TenancyError(f"quota {key!r} must be a non-negative integer")
    return value


@dataclass(frozen=True)
class TenantQuota:
    """Per-tenant limits; 0 (or 0.0) disables the corresponding cap."""

    max_connections: int = 0
    max_channels: int = 0
    max_queues: int = 0
    max_bindings: int = 0
    memory_share: float = 0.0   # fraction of the memory high watermark
    publish_rate: int = 0       # token-bucket refill, bytes/sec
    publish_burst: int = 0      # bucket capacity; default 2x publish-rate

    @classmethod
    def from_spec(cls, raw: Optional[dict]) -> "TenantQuota":
        if raw is None:
            return cls()
        if not isinstance(raw, dict):
            raise TenancyError("quota must be a JSON object")
        unknown = sorted(set(raw) - _QUOTA_KEYS)
        if unknown:
            raise TenancyError(
                f"unknown quota keys {unknown} (have {sorted(_QUOTA_KEYS)})")
        share = raw.get("memory-share", 0.0)
        if isinstance(share, bool) or not isinstance(share, (int, float)) \
                or not 0.0 <= float(share) <= 1.0:
            raise TenancyError("quota 'memory-share' must be in [0, 1]")
        rate = _int_field(raw, "publish-rate")
        burst = _int_field(raw, "publish-burst")
        if burst and not rate:
            raise TenancyError(
                "quota 'publish-burst' requires 'publish-rate'")
        return cls(
            max_connections=_int_field(raw, "max-connections"),
            max_channels=_int_field(raw, "max-channels"),
            max_queues=_int_field(raw, "max-queues"),
            max_bindings=_int_field(raw, "max-bindings"),
            memory_share=float(share),
            publish_rate=rate,
            publish_burst=burst or 2 * rate,
        )

    def as_dict(self) -> dict:
        return {
            "max-connections": self.max_connections,
            "max-channels": self.max_channels,
            "max-queues": self.max_queues,
            "max-bindings": self.max_bindings,
            "memory-share": self.memory_share,
            "publish-rate": self.publish_rate,
            "publish-burst": self.publish_burst,
        }


def _parse_acls(raw, vhosts: tuple, users: dict) -> dict:
    """user -> vhost -> frozenset(perms). Validated fail-closed: an ACL
    naming an unknown user or a vhost outside the tenant would be silently
    unenforceable, so both are spec errors."""
    if raw is None:
        return {}
    if not isinstance(raw, dict):
        raise TenancyError("acls must map user names to vhost permission maps")
    acls: dict = {}
    for user, by_vhost in raw.items():
        if not isinstance(user, str) or user not in users:
            raise TenancyError(
                f"acls name unknown user {user!r} (declare it under users)")
        if not isinstance(by_vhost, dict):
            raise TenancyError(
                f"acls[{user!r}] must map vhosts to permission lists")
        acls[user] = {}
        for vhost, perms in by_vhost.items():
            if vhost not in vhosts:
                raise TenancyError(
                    f"acls[{user!r}] names vhost {vhost!r} outside the tenant")
            if not isinstance(perms, list) or not all(
                    p in ACL_PERMS for p in perms):
                raise TenancyError(
                    f"acls[{user!r}][{vhost!r}] must be a subset of "
                    f"{list(ACL_PERMS)}")
            acls[user][vhost] = frozenset(perms)
    return acls


class Tenant:
    """One named principal: owned vhosts, auth tables, quota, live state."""

    def __init__(self, registry: "TenantRegistry", name: str,
                 vhosts: tuple, users: dict, acls: dict,
                 quota: TenantQuota) -> None:
        self.registry = registry
        self.name = name
        self.vhosts = vhosts
        self.users = users
        self.acls = acls
        self.quota = quota
        # live connections (AMQPConnection objects); counters for closed
        # connections fold into the *_folded totals at teardown so the
        # per-tenant series stay monotonic
        self.conns: set = set()
        self.published_folded = 0
        self.delivered_folded = 0
        self.refused = 0       # ACL + quota publish refusals
        self.throttles = 0     # gate-close transitions
        # publish-rate token bucket (floats: refill is rate * dt)
        self.tokens = float(quota.publish_burst)
        self.rate_gated = False
        self.memory_gated = False
        self.resident_bytes = 0  # sampled each registry tick
        # per-tenant publish->deliver histogram, allocated only when a
        # delivery-latency SLO targets this tenant (see attach_latency) —
        # a plain quota tenant pays nothing on the delivery path
        self.latency_hist: Optional[Histogram] = None

    # -- identity / auth ---------------------------------------------------

    def acl_for(self, username: Optional[str],
                vhost: str) -> tuple[bool, bool, bool]:
        """(configure, write, read) for one user on one vhost. ACLs are
        opt-in per user (like the vhost allowlists): a user absent from
        the table is unrestricted; a listed user gets exactly the declared
        perms (missing vhost entry -> none)."""
        if not self.acls or username is None or username not in self.acls:
            return (True, True, True)
        perms = self.acls[username].get(vhost, frozenset())
        return ("configure" in perms, "write" in perms, "read" in perms)

    # -- derived counters --------------------------------------------------

    def published_total(self) -> int:
        return self.published_folded + sum(
            c.published_msgs for c in self.conns)

    def delivered_total(self) -> int:
        return self.delivered_folded + sum(
            c.delivered_msgs for c in self.conns)

    # -- publish-rate token bucket ----------------------------------------

    @property
    def rated(self) -> bool:
        return self.quota.publish_rate > 0

    @property
    def gated(self) -> bool:
        return self.rate_gated or self.memory_gated

    @property
    def floor(self) -> int:
        """The tenant's stage floor on the flow ladder: pinned at
        STAGE_THROTTLE while its memory share is breached (the control plane's floor
        mechanism, scoped to one tenant's connections)."""
        return STAGE_THROTTLE if self.memory_gated else STAGE_NORMAL

    def spend(self, cost: int) -> None:
        """Spend bucket tokens for one executed publish (called from the
        connection publish paths only when ``rated``)."""
        self.tokens -= cost
        if self.tokens <= 0.0 and not self.rate_gated:
            self.rate_gated = True
            self.registry._apply_gate(self, "publish-rate")

    def take_credit(self, cap: int) -> int:
        """Feed the per-connection publish-credit grant from the bucket
        while the tenant gate is closed: a gated connection may draw up to
        the broker's flow grant from whatever tokens have re-accrued."""
        take = min(int(cap or 0), int(self.tokens))
        if take <= 0:
            return 0
        self.tokens -= take
        return take

    def attach_latency(self) -> Histogram:
        if self.latency_hist is None:
            self.latency_hist = Histogram()
        return self.latency_hist

    # -- snapshots ---------------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "name": self.name,
            "vhosts": list(self.vhosts),
            "users": sorted(self.users),
            "acls": {
                user: {vh: sorted(perms) for vh, perms in by_vhost.items()}
                for user, by_vhost in self.acls.items()
            },
            "quota": self.quota.as_dict(),
            "connections": len(self.conns),
            "channels": sum(len(c.channels) for c in self.conns),
            "queues": self.registry.queue_count(self),
            "bindings": self.registry.binding_count(self),
            "resident_bytes": self.resident_bytes,
            "tokens": int(self.tokens),
            "gated": self.gated,
            "floor": self.floor,
            "published": self.published_total(),
            "delivered": self.delivered_total(),
            "refused": self.refused,
            "throttles": self.throttles,
        }


class TenantRegistry:
    """All tenants on one node, plus the vhost/user reverse maps the
    enforcement seams look identities up through."""

    def __init__(self, broker) -> None:
        self.broker = broker
        self.tenants: dict[str, Tenant] = {}
        self.by_vhost: dict[str, Tenant] = {}
        self.by_user: dict[str, Tenant] = {}
        # deterministic gate-transition ledger (see module docstring)
        self.decision_log: list[dict] = []
        self.ticks = 0

    # -- definition --------------------------------------------------------

    def define(self, name: str, spec: dict) -> Tenant:
        """Create or replace one tenant from a spec dict (config file,
        env JSON, or POST /admin/tenants). Raises TenancyError on any
        invalid shape; a replacement keeps the old tenant's live
        connections and counters but adopts the new quota/auth tables."""
        if not isinstance(name, str) or not name:
            raise TenancyError("tenant name must be a non-empty string")
        if not isinstance(spec, dict):
            raise TenancyError(f"tenant {name!r}: spec must be a JSON object")
        unknown = sorted(set(spec) - {"vhosts", "users", "acls", "quota"})
        if unknown:
            raise TenancyError(f"tenant {name!r}: unknown keys {unknown}")
        vhosts_raw = spec.get("vhosts")
        if not isinstance(vhosts_raw, list) or not vhosts_raw or not all(
                isinstance(v, str) and v for v in vhosts_raw):
            raise TenancyError(
                f"tenant {name!r}: vhosts must be a non-empty string list")
        vhosts = tuple(dict.fromkeys(vhosts_raw))
        users_raw = spec.get("users") or {}
        if not isinstance(users_raw, dict) or not all(
                isinstance(k, str) and isinstance(v, str)
                for k, v in users_raw.items()):
            raise TenancyError(
                f"tenant {name!r}: users must map user names to passwords")
        acls = _parse_acls(spec.get("acls"), vhosts, users_raw)
        quota = TenantQuota.from_spec(spec.get("quota"))
        # cross-tenant uniqueness: a vhost or user claimed by two tenants
        # would make identity resolution ambiguous
        for vhost in vhosts:
            other = self.by_vhost.get(vhost)
            if other is not None and other.name != name:
                raise TenancyError(
                    f"vhost {vhost!r} already owned by tenant {other.name!r}")
        for user in users_raw:
            other = self.by_user.get(user)
            if other is not None and other.name != name:
                raise TenancyError(
                    f"user {user!r} already declared by tenant {other.name!r}")
        existing = self.tenants.get(name)
        if existing is not None:
            self._unindex(existing)
            existing.vhosts = vhosts
            existing.users = dict(users_raw)
            existing.acls = acls
            if existing.quota != quota:
                existing.quota = quota
                existing.tokens = min(
                    existing.tokens, float(quota.publish_burst)) \
                    if quota.publish_rate else float(quota.publish_burst)
            tenant = existing
        else:
            tenant = Tenant(self, name, vhosts, dict(users_raw), acls, quota)
            self.tenants[name] = tenant
        self._index(tenant)
        return tenant

    def remove(self, name: str) -> bool:
        tenant = self.tenants.pop(name, None)
        if tenant is None:
            return False
        self._unindex(tenant)
        # lift any closed gate so surviving connections (now tenantless
        # for quota purposes) don't stay parked forever
        if tenant.gated:
            tenant.rate_gated = tenant.memory_gated = False
            for conn in list(tenant.conns):
                conn.set_tenant_gate(False)
        for conn in list(tenant.conns):
            conn.detach_tenant()
        return True

    def _index(self, tenant: Tenant) -> None:
        for vhost in tenant.vhosts:
            self.by_vhost[vhost] = tenant
        for user in tenant.users:
            self.by_user[user] = tenant

    def _unindex(self, tenant: Tenant) -> None:
        for vhost in tenant.vhosts:
            if self.by_vhost.get(vhost) is tenant:
                del self.by_vhost[vhost]
        for user in tenant.users:
            if self.by_user.get(user) is tenant:
                del self.by_user[user]

    # -- identity ----------------------------------------------------------

    def tenant_of_vhost(self, vhost: Optional[str]) -> Optional[str]:
        tenant = self.by_vhost.get(vhost) if vhost else None
        return tenant.name if tenant is not None else None

    # -- auth views (consumed by the SASL / Connection.Open seams) ---------

    def auth_users(self, base: Optional[dict]) -> Optional[dict]:
        """The effective SASL PLAIN table: server-wide users merged with
        every tenant's. None (open access, reference parity) only when
        neither declares any user."""
        merged = dict(base) if base else {}
        for tenant in self.tenants.values():
            merged.update(tenant.users)
        return merged or None

    def auth_permissions(self, base: Optional[dict]) -> Optional[dict]:
        """Effective vhost allowlists: tenant users are confined to their
        tenant's vhosts (on top of any server-wide allowlists)."""
        merged = dict(base) if base else {}
        for tenant in self.tenants.values():
            for user in tenant.users:
                merged[user] = list(tenant.vhosts)
        return merged or None

    # -- quota checks (error text or None; call sites raise) ---------------

    def connection_refusal(self, vhost: str) -> Optional[str]:
        tenant = self.by_vhost.get(vhost)
        if tenant is None:
            return None
        cap = tenant.quota.max_connections
        if cap and len(tenant.conns) >= cap:
            self._count_refusal(tenant)
            return (f"tenant '{tenant.name}': connection quota "
                    f"({cap}) exceeded")
        return None

    def channel_refusal(self, tenant: Tenant) -> Optional[str]:
        cap = tenant.quota.max_channels
        if cap and sum(len(c.channels) for c in tenant.conns) >= cap:
            self._count_refusal(tenant)
            return f"tenant '{tenant.name}': channel quota ({cap}) exceeded"
        return None

    def queue_refusal(self, vhost: str) -> Optional[str]:
        tenant = self.by_vhost.get(vhost)
        if tenant is None:
            return None
        cap = tenant.quota.max_queues
        if cap and self.queue_count(tenant) >= cap:
            self._count_refusal(tenant)
            return f"tenant '{tenant.name}': queue quota ({cap}) exceeded"
        return None

    def binding_refusal(self, vhost: str) -> Optional[str]:
        tenant = self.by_vhost.get(vhost)
        if tenant is None:
            return None
        cap = tenant.quota.max_bindings
        if cap and self.binding_count(tenant) >= cap:
            self._count_refusal(tenant)
            return f"tenant '{tenant.name}': binding quota ({cap}) exceeded"
        return None

    def _count_refusal(self, tenant: Tenant) -> None:
        tenant.refused += 1
        self.broker.metrics.tenancy_quota_refusals_total += 1

    # live counts walk the real structures instead of shadow counters:
    # declares/deletes/vhost drops can't drift a number that is recomputed
    def queue_count(self, tenant: Tenant) -> int:
        vhosts = self.broker.vhosts
        return sum(
            len(vhosts[v].queues) for v in tenant.vhosts if v in vhosts)

    def binding_count(self, tenant: Tenant) -> int:
        total = 0
        vhosts = self.broker.vhosts
        for v in tenant.vhosts:
            vhost = vhosts.get(v)
            if vhost is None:
                continue
            for exchange in vhost.exchanges.values():
                total += len(exchange.matcher.bindings())
                if exchange.ex_matcher is not None:
                    total += len(exchange.ex_matcher.bindings())
        return total

    def tenant_resident_bytes(self, tenant: Tenant) -> int:
        vhosts = self.broker.vhosts
        return sum(
            q.ready_bytes
            for v in tenant.vhosts if v in vhosts
            for q in vhosts[v].queues.values())

    # -- gate machinery ----------------------------------------------------

    def _apply_gate(self, tenant: Tenant, reason: str) -> None:
        """A tenant gate closed (bucket empty or memory share breached):
        flip the tenant's connections onto the hold path and ledger it."""
        tenant.throttles += 1
        self.broker.metrics.tenancy_throttles_total += 1
        for conn in list(tenant.conns):
            conn.set_tenant_gate(True)
        self._log("throttle", tenant, reason)

    def _lift_gate(self, tenant: Tenant, reason: str) -> None:
        self.broker.metrics.tenancy_resumes_total += 1
        for conn in list(tenant.conns):
            conn.set_tenant_gate(False)
        self._log("resume", tenant, reason)

    def _log(self, decision: str, tenant: Tenant, reason: str) -> None:
        entry = {
            "decision": decision, "tenant": tenant.name, "reason": reason,
            "tick": self.ticks, "tokens": int(tenant.tokens),
            "resident": tenant.resident_bytes, "floor": tenant.floor,
            "published": tenant.published_total(),
        }
        self.decision_log.append(entry)
        from .. import events

        bus = events.ACTIVE
        if bus is not None:
            bus.emit(f"tenant.{decision}.{tenant.name}",
                     {"tenant": tenant.name, **entry})

    def tick(self, dt: float) -> None:
        """One deterministic registry tick (driven by the broker sweep, or
        by a soak harness): refill token buckets, sample per-tenant
        resident bytes, move the memory-share floors with hysteresis, and
        lift rate gates whose buckets re-accrued."""
        self.ticks += 1
        high = self.broker.memory_high_watermark
        for name in sorted(self.tenants):
            tenant = self.tenants[name]
            quota = tenant.quota
            tenant.resident_bytes = self.tenant_resident_bytes(tenant)
            was_gated = tenant.gated
            if quota.publish_rate:
                tenant.tokens = min(
                    float(quota.publish_burst),
                    tenant.tokens + quota.publish_rate * dt)
                if tenant.rate_gated and tenant.tokens > 0.0:
                    tenant.rate_gated = False
            if quota.memory_share and high:
                limit = int(quota.memory_share * high)
                if (not tenant.memory_gated
                        and tenant.resident_bytes > limit):
                    tenant.memory_gated = True
                elif (tenant.memory_gated
                      and tenant.resident_bytes
                      <= int(limit * MEMORY_EXIT_RATIO)):
                    tenant.memory_gated = False
            if tenant.gated and not was_gated:
                tenant.throttles += 1
                self.broker.metrics.tenancy_throttles_total += 1
                for conn in list(tenant.conns):
                    conn.set_tenant_gate(True)
                self._log("throttle", tenant, "memory-share")
            elif was_gated and not tenant.gated:
                self._lift_gate(
                    tenant, "refill" if quota.publish_rate else "drain")

    # -- snapshots ---------------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "tenants": [
                self.tenants[name].snapshot()
                for name in sorted(self.tenants)
            ],
            "count": len(self.tenants),
            "ticks": self.ticks,
            "decisions": len(self.decision_log),
        }
