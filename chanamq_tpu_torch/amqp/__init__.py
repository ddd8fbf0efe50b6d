"""L0: AMQP 0-9-1 wire codec and protocol model.

Rebuilds the capability of the reference's chana-mq-base protocol library
(reference: chana-mq-base/src/main/scala/chana/mq/amqp/{model,method,engine})
as a standalone Python codec: frames, field-table values, content-header
properties, the full method-class registry, and the command assembler.
"""

from .constants import FrameType, ErrorCode, PROTOCOL_HEADER
from .frame import Frame, FrameParser, FrameError, HEARTBEAT_FRAME
from .properties import BasicProperties
from .command import AMQCommand, CommandAssembler

__all__ = [
    "FrameType",
    "ErrorCode",
    "PROTOCOL_HEADER",
    "Frame",
    "FrameParser",
    "FrameError",
    "HEARTBEAT_FRAME",
    "BasicProperties",
    "AMQCommand",
    "CommandAssembler",
]
