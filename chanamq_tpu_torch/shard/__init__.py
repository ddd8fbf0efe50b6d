"""Multi-process sharded broker node.

One machine, N broker processes ("shards"), each a full cluster member:
the supervisor (:mod:`.supervisor`) spawns one worker per core (knob
``chana.mq.shard.count``; 0 = ``os.cpu_count()``), workers accept AMQP
clients on a shared SO_REUSEPORT listener (or via the fd-handoff
acceptor, :mod:`.handoff`, where SO_REUSEPORT is unavailable), own
queues by the same consistent hash as remote nodes (cluster/hashring),
and reach sibling shards over Unix-domain sockets with the binary data
plane (frame kinds 4/5/6) — a cross-shard hop is one zero-copy push.

The paper's location-transparent sharded entities (PAPER.md §L3) map
onto processes instead of actor shards; everything above the transport
(ownership, replication promotion, chaos seams, trace trailers,
telemetry pull) is the unchanged cluster machinery.
"""

from .topology import ShardTopology, resolve_count  # noqa: F401
