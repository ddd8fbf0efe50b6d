"""Exchange-to-exchange binding graph guards.

The runtime publish walk (VHost.route) is cycle-SAFE — its visited set
terminates any loop — but a cyclic topology is still almost certainly a
client bug, and it blocks the TensorRouter from flattening the graph
closure into its compiled tables (a DAG closure is finite; a cyclic one
is not). So with semantics enabled, Exchange.Bind REFUSES a binding
that would close a directed cycle with 406 PRECONDITION_FAILED — the
same fail-at-declare posture RabbitMQ takes for argument conflicts —
and the visited-set walk stays on as defense in depth (pre-existing
durable topologies recovered from the store are not re-validated).

Edges considered are e2e bindings only. Alternate-exchange fallbacks
can also chain, but they fire only for UNROUTED messages, so an
alternate loop self-terminates at the first exchange that routes; the
runtime visited set covers the rest.
"""

from __future__ import annotations

from typing import Iterable


def e2e_destinations(vhost, name: str) -> Iterable[str]:
    """Destination exchange names reachable in ONE e2e hop from `name`."""
    ex = vhost.exchanges.get(name)
    if ex is None or ex.ex_matcher is None:
        return ()
    return {dest for _key, dest, _args in ex.ex_matcher.bindings()}


def would_create_cycle(vhost, source: str, destination: str) -> bool:
    """Whether binding source -> destination closes a directed cycle:
    true iff source is already reachable FROM destination (or the bind
    is a self-loop). Depth-first over the e2e edge set — bind-time cost,
    never on the publish path."""
    if source == destination:
        return True
    seen: set[str] = set()
    stack = [destination]
    while stack:
        name = stack.pop()
        if name == source:
            return True
        if name in seen:
            continue
        seen.add(name)
        stack.extend(e2e_destinations(vhost, name))
    return False
