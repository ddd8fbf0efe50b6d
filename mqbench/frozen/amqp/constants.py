"""AMQP 0-9-1 protocol constants.

Capability parity with the reference's frame/error model
(chana-mq-base .../model/Frame.scala:38-216, .../model/ErrorCodes.scala:3-113),
expressed from the public AMQP 0-9-1 specification rather than by translation.
"""

from __future__ import annotations

import enum

# The 8-byte protocol handshake header: "AMQP" + %d0 + major.minor.revision.
PROTOCOL_HEADER = b"AMQP\x00\x00\x09\x01"

FRAME_END = 0xCE

# Frame header is type(1) + channel(2) + payload-size(4); +1 for the end octet.
FRAME_HEADER_SIZE = 7
FRAME_OVERHEAD = FRAME_HEADER_SIZE + 1

# Spec minimum frame size every peer must accept before tuning.
FRAME_MIN_SIZE = 4096

DEFAULT_PORT = 5672
DEFAULT_TLS_PORT = 5671


class FrameType(enum.IntEnum):
    METHOD = 1
    HEADER = 2
    BODY = 3
    HEARTBEAT = 8


class ClassId(enum.IntEnum):
    CONNECTION = 10
    CHANNEL = 20
    ACCESS = 30
    EXCHANGE = 40
    QUEUE = 50
    BASIC = 60
    CONFIRM = 85
    TX = 90


class ErrorCode(enum.IntEnum):
    """AMQP reply codes. 2xx success, 3xx soft channel errors, 4xx channel
    errors, 5xx connection errors."""

    REPLY_SUCCESS = 200

    CONTENT_TOO_LARGE = 311
    NO_ROUTE = 312
    NO_CONSUMERS = 313
    ACCESS_REFUSED = 403
    NOT_FOUND = 404
    RESOURCE_LOCKED = 405
    PRECONDITION_FAILED = 406

    CONNECTION_FORCED = 320
    INVALID_PATH = 402
    FRAME_ERROR = 501
    SYNTAX_ERROR = 502
    COMMAND_INVALID = 503
    CHANNEL_ERROR = 504
    UNEXPECTED_FRAME = 505
    RESOURCE_ERROR = 506
    NOT_ALLOWED = 530
    NOT_IMPLEMENTED = 540
    INTERNAL_ERROR = 541

    @property
    def is_hard_error(self) -> bool:
        """Connection-level (hard) errors close the whole connection."""
        return self in _HARD_ERRORS


_HARD_ERRORS = frozenset(
    {
        ErrorCode.CONNECTION_FORCED,
        ErrorCode.INVALID_PATH,
        ErrorCode.FRAME_ERROR,
        ErrorCode.SYNTAX_ERROR,
        ErrorCode.COMMAND_INVALID,
        ErrorCode.CHANNEL_ERROR,
        ErrorCode.UNEXPECTED_FRAME,
        ErrorCode.RESOURCE_ERROR,
        ErrorCode.NOT_ALLOWED,
        ErrorCode.NOT_IMPLEMENTED,
        ErrorCode.INTERNAL_ERROR,
    }
)


class ExchangeType(str, enum.Enum):
    DIRECT = "direct"
    FANOUT = "fanout"
    TOPIC = "topic"
    HEADERS = "headers"

    @classmethod
    def of(cls, name: str) -> "ExchangeType":
        try:
            return cls(name.lower())
        except ValueError:
            raise ValueError(f"unknown exchange type: {name!r}") from None
