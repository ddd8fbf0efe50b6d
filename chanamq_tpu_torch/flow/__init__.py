"""Broker-wide memory accounting and overload protection.

One `MemoryAccountant` tracks the real resident costs of the broker
(queue body bytes, parked publishes, connection out-buffers, WAL
memtable, cluster data-plane in-flight, stream sealed-blob cache, plus
deterministic chaos inflation) and actuates a graceful-degradation
ladder, mildest first:

  stage 1 (page)     — aggressively page message bodies to the store
  stage 2 (throttle) — per-connection publish credit, channel.flow,
                       paused socket reads (the memory gate)
  stage 3 (cluster)  — shrink data-plane credit windows / stall
                       push_many replies so remote publishers slow down
  stage 4 (refuse)   — refuse new publishes with PRECONDITION_FAILED
                       while consumers keep draining

The reference broker had none of this (its backpressure was
akka-streams demand + TCP, SURVEY.md §7.3); the shape here follows the
Pulsar paper's position that brokers survive multi-tenant load only
when backpressure and load shedding are first-class.
"""

from .accountant import (
    MemoryAccountant,
    STAGE_CLUSTER,
    STAGE_NAMES,
    STAGE_NORMAL,
    STAGE_PAGE,
    STAGE_REFUSE,
    STAGE_THROTTLE,
)

__all__ = [
    "MemoryAccountant",
    "STAGE_NAMES",
    "STAGE_NORMAL",
    "STAGE_PAGE",
    "STAGE_THROTTLE",
    "STAGE_CLUSTER",
    "STAGE_REFUSE",
]
