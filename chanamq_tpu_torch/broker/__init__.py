"""L2+L3: connection engine and broker entities.

Rebuilds the capability of the reference's chana-mq-server runtime — the
FrameStage protocol engine (engine/FrameStage.scala:53-1297) and the four
sharded entity actors (entity/{Vhost,Exchange,Queue,Message}Entity.scala) —
as an asyncio host runtime: one reader/writer task pair per connection, a
synchronous event-driven dispatch engine per queue (replacing the reference's
1 microsecond tick poll, ServerBluePrint.scala:31), and write-through
persistence hooks with strict FIFO ordering.
"""

from .broker import Broker
from .server import BrokerServer

__all__ = ["Broker", "BrokerServer"]
