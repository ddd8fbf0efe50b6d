"""Queue replication with failover promotion.

Turns the cluster from "sharded" into "sharded + HA": each replicated
queue's owner ships its store mutations (enqueue, settle, purge, delete,
watermark moves) as a sequenced, batched event log to factor-1 follower
nodes, which maintain a warm passive copy in their local store under a
replica namespace. When the owner dies, the highest-synced follower
promotes: it materializes its copy into the real namespace, claims the
queue cluster-wide, and the existing consumer-reconcile path re-attaches
consumers. With chana.mq.replicate.sync=true, publisher confirms gate on
follower acks so no confirmed persistent message can be lost to a single
node failure.
"""

from .applier import ReplicaApplier, ReplicaCopy
from .log import QueueRepLog, ReplicationManager

__all__ = [
    "QueueRepLog",
    "ReplicationManager",
    "ReplicaApplier",
    "ReplicaCopy",
]
