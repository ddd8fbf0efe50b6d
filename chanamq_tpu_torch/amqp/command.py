"""AMQCommand (method [+ header + body]) rendering and reassembly.

Capability parity with the reference's AMQCommand.render
(chana-mq-base .../model/AMQCommand.scala:29-65) and CommandAssembler state
machine (.../engine/CommandAssembler.scala:44-131): a command is one METHOD
frame, optionally followed by one HEADER frame and zero or more BODY frames;
rendering fragments the body into <= (frame_max - overhead) chunks; assembly
is an incremental state machine fed complete frames.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional

from .constants import FRAME_OVERHEAD, ErrorCode, FrameType
from .frame import Frame, FrameError
from .methods import Method, MethodDecodeError, decode_method
from .properties import BasicProperties


@dataclass(slots=True)
class AMQCommand:
    """A fully-assembled AMQP command on one channel."""

    channel: int
    method: Method
    properties: Optional[BasicProperties] = None
    body: bytes = b""
    # Raw HEADER-frame payload as received off the wire (class-id + weight +
    # body-size + property flags/values). Kept so re-rendering the same
    # content (delivery of a just-published message, mandatory returns,
    # persistence) skips the property re-encode — the bytes are identical.
    header_raw: Optional[bytes] = None

    def render_frames(self, frame_max: int) -> list[Frame]:
        if frame_max and frame_max <= FRAME_OVERHEAD:
            raise ValueError(f"frame_max {frame_max} leaves no room for payload")
        frames = [Frame.method(self.channel, self.method.encode())]
        if self.method.HAS_CONTENT:
            header_payload = self.header_raw
            if header_payload is None:
                props = self.properties or BasicProperties()
                header_payload = props.encode_header(len(self.body))
            frames.append(Frame.header(self.channel, header_payload))
            body = self.body
            max_payload = (frame_max - FRAME_OVERHEAD) if frame_max else max(len(body), 1)
            for off in range(0, len(body), max_payload):
                frames.append(Frame.body(self.channel, body[off : off + max_payload]))
        return frames

    def render(self, frame_max: int) -> bytes:
        return b"".join(f.to_bytes() for f in self.render_frames(frame_max))


class CommandAssembler:
    """Reassembles frames into commands for one connection (all channels).

    Feed it complete frames; it yields `AMQCommand` or `FrameError`.
    Heartbeat frames are not handled here — filter them before feeding.

    max_body_size (0 = unlimited) bounds the declared content size: body
    chunks accumulate here until the declared size arrives, so without a
    cap a peer declaring a huge body could grow broker RAM without limit
    (the reference's FrameParser carried the same guard as its
    message-size limit, FrameParser.scala:67-158). The AGGREGATE declared
    size across all channels is additionally bounded at 4x the per-message
    cap: without it, a connection could park one near-cap partial on every
    channel (channel-max of them) and hold cap x channels of RAM invisible
    to the broker's memory gauge."""

    __slots__ = ("_partial", "max_body_size", "_declared_bytes")

    def __init__(self, max_body_size: int = 0) -> None:
        # channel id -> in-flight (command, expected_body_size, received_size)
        self._partial: dict[int, _Partial] = {}
        self.max_body_size = max_body_size
        # sum of expected_size over in-flight partials (declared-size
        # accounting: chunks can never exceed declared + one frame, so
        # bounding declarations bounds memory at message granularity)
        self._declared_bytes = 0

    def feed_one(self, frame: Frame) -> "AMQCommand | FrameError | None":
        """Feed one frame; returns the completed command, a protocol error,
        or None while content is still pending. The hot-loop shape (plain
        call, no generator per frame): every frame produces at most one
        result by construction."""
        channel = frame.channel
        partial = self._partial.get(channel)
        if frame.type == FrameType.METHOD:
            if partial is not None:
                return FrameError(
                    ErrorCode.UNEXPECTED_FRAME,
                    f"method frame while content pending on channel {channel}",
                )
            try:
                method = decode_method(frame.payload)
            except MethodDecodeError as exc:
                return FrameError(ErrorCode.COMMAND_INVALID, str(exc))
            except Exception as exc:
                return FrameError(ErrorCode.SYNTAX_ERROR, f"bad method arguments: {exc}")
            if method.HAS_CONTENT:
                self._partial[channel] = _Partial(AMQCommand(channel, method))
                return None
            return AMQCommand(channel, method)
        elif frame.type == FrameType.BODY:
            if partial is None or partial.expected_size is None:
                return FrameError(
                    ErrorCode.UNEXPECTED_FRAME,
                    f"unexpected body frame on channel {channel}",
                )
            partial.chunks.append(frame.payload)
            partial.received += len(frame.payload)
            if partial.received > partial.expected_size:
                del self._partial[channel]
                self._declared_bytes -= partial.expected_size
                return FrameError(
                    ErrorCode.FRAME_ERROR,
                    f"body overflows declared size on channel {channel}",
                )
            if partial.received == partial.expected_size:
                partial.command.body = b"".join(partial.chunks)
                del self._partial[channel]
                self._declared_bytes -= partial.expected_size
                return partial.command
            return None
        elif frame.type == FrameType.HEADER:
            if partial is None or partial.expected_size is not None:
                return FrameError(
                    ErrorCode.UNEXPECTED_FRAME,
                    f"unexpected header frame on channel {channel}",
                )
            try:
                _class_id, body_size, props = BasicProperties.decode_header(frame.payload)
            except Exception as exc:
                return FrameError(ErrorCode.SYNTAX_ERROR, f"bad content header: {exc}")
            if self.max_body_size and body_size > self.max_body_size:
                del self._partial[channel]
                return FrameError(
                    ErrorCode.FRAME_ERROR,
                    f"declared body size {body_size} exceeds max message "
                    f"size {self.max_body_size}")
            if self.max_body_size and (self._declared_bytes + body_size
                                       > 4 * self.max_body_size):
                del self._partial[channel]
                return FrameError(
                    ErrorCode.FRAME_ERROR,
                    f"aggregate in-flight content "
                    f"{self._declared_bytes + body_size} exceeds "
                    f"{4 * self.max_body_size}")
            partial.command.properties = props
            partial.command.header_raw = frame.payload
            partial.expected_size = body_size
            if body_size == 0:
                del self._partial[channel]
                return partial.command
            self._declared_bytes += body_size
            return None
        else:
            return FrameError(ErrorCode.UNEXPECTED_FRAME, f"frame type {frame.type}")

    def feed(self, frame: Frame) -> Iterator["AMQCommand | FrameError"]:
        result = self.feed_one(frame)
        if result is not None:
            yield result

    def abort_channel(self, channel: int) -> None:
        """Drop any in-flight content on a channel (e.g. on channel close)."""
        partial = self._partial.pop(channel, None)
        if partial is not None and partial.expected_size:
            self._declared_bytes -= partial.expected_size


@dataclass(slots=True)
class _Partial:
    command: AMQCommand
    expected_size: Optional[int] = None
    received: int = 0
    chunks: list[bytes] = field(default_factory=list)
