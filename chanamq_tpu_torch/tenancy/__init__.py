"""Multi-tenancy: per-tenant quotas, auth/ACLs, and tenant-scoped SLOs.

Gating discipline is identical to chaos/trace/profile/events: the
module-level ``ACTIVE`` registry is ``None`` unless tenancy is enabled,
and every enforcement seam in the broker/connection hot paths costs one
attribute load plus an identity check when off. The steady-state cost
with tenancy ON is likewise kept off the per-frame path: rate limiting
rides the existing publish-hold machinery (connections only consult the
bucket when their tenant declares a ``publish-rate``), and memory shares
ride the flow ladder's stage-floor mechanism.

Tenants are declared at boot via ``chana.mq.tenant.enabled`` +
``chana.mq.tenant.tenants`` (a JSON object of name -> spec, a dict leaf
like ``chana.mq.auth.users``), or at runtime via ``POST /admin/tenants``.
See :mod:`chanamq_tpu_torch.tenancy.registry` for spec shape and enforcement
mechanics.
"""

from __future__ import annotations

from typing import Optional

from .registry import (  # noqa: F401
    ACL_PERMS,
    TenancyError,
    Tenant,
    TenantQuota,
    TenantRegistry,
)

ACTIVE: Optional[TenantRegistry] = None


def install(registry: Optional[TenantRegistry]) -> None:
    global ACTIVE
    ACTIVE = registry


def clear() -> None:
    install(None)


def enable_from_config(config, broker) -> Optional[TenantRegistry]:
    """Boot-time wiring: build the registry from ``chana.mq.tenant.*``,
    hang it off the broker, install the module gate. Validated fail-closed
    (like the auth knobs): a malformed tenant map, or tenants declared
    while tenancy is disabled, is a boot error — never a silently
    unenforced quota."""
    from ..config import ConfigError

    enabled = config.bool("chana.mq.tenant.enabled")
    tenants = config.get("chana.mq.tenant.tenants")
    if not enabled:
        if tenants:
            raise ConfigError(
                "chana.mq.tenant.tenants is set but chana.mq.tenant.enabled "
                "is false; enable tenancy or drop the tenant map")
        return None
    registry = TenantRegistry(broker)
    if tenants is not None:
        if not isinstance(tenants, dict):
            raise ConfigError(
                "chana.mq.tenant.tenants must map tenant names to specs")
        for name in sorted(tenants):
            try:
                registry.define(name, tenants[name])
            except TenancyError as exc:
                raise ConfigError(
                    f"chana.mq.tenant.tenants[{name!r}]: {exc}") from exc
    broker.tenancy = registry
    install(registry)
    return registry
