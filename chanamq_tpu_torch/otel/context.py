"""W3C trace-context primitives (https://www.w3.org/TR/trace-context/).

Pure functions + one tiny value class, importable from the trace runtime
without cycles (this module imports nothing from the broker). Two rules
shape everything here:

- a malformed ``traceparent`` must never break the publish carrying it
  (the W3C spec says: restart the trace), so every parser returns None
  instead of raising;
- a forced sample must not perturb the seeded sampling sequence, so
  every id the broker mints for a propagated trace is *derived* (SHA-256
  of stable inputs), never drawn from an RNG.
"""

from __future__ import annotations

import hashlib
from typing import Optional

TRACEPARENT_HEADER = "traceparent"
TRACESTATE_HEADER = "tracestate"

_HEX = frozenset("0123456789abcdef")


def _is_hex(text: str) -> bool:
    return bool(text) and all(c in _HEX for c in text)


class W3CContext:
    """The propagated context pinned on one broker-side trace.

    ``trace_id``/``parent_span_id`` come off the client's traceparent;
    ``root_span_id`` is the broker's own span for this hop — every stage
    span parents to it, and it is what rides outgoing headers so the
    next hop (consumer, or a federated mirror) parents to this broker.
    """

    __slots__ = ("trace_id", "parent_span_id", "root_span_id", "flags",
                 "tracestate")

    def __init__(self, trace_id: str, parent_span_id: str,
                 root_span_id: str, flags: int = 1,
                 tracestate: Optional[str] = None) -> None:
        self.trace_id = trace_id
        self.parent_span_id = parent_span_id
        self.root_span_id = root_span_id
        self.flags = flags
        self.tracestate = tracestate

    @property
    def outgoing(self) -> str:
        """The traceparent this broker stamps on everything it emits.

        Always sampled (01): a context only reaches here by forcing a
        sample, and downstream hops must keep the trace joined."""
        return f"00-{self.trace_id}-{self.root_span_id}-01"

    def to_dict(self) -> dict:
        out = {
            "trace_id": self.trace_id,
            "parent_span_id": self.parent_span_id,
            "root_span_id": self.root_span_id,
            "flags": self.flags,
        }
        if self.tracestate:
            out["tracestate"] = self.tracestate
        return out


def parse_traceparent(value) -> "Optional[tuple[str, str, int]]":
    """``(trace_id, parent_span_id, flags)``, or None if malformed.

    Accepts str or bytes (AMQP tables carry either). Rejection cases per
    the spec: version ``ff``, short/overlong or non-hex ids, the all-zero
    trace or parent id, and a version-00 header with trailing fields
    (future versions may append fields, 00 may not)."""
    if isinstance(value, (bytes, bytearray, memoryview)):
        try:
            value = bytes(value).decode("ascii")
        except UnicodeDecodeError:
            return None
    if not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) < 4:
        return None
    ver, tid, pid, flags = parts[0], parts[1], parts[2], parts[3]
    if len(ver) != 2 or not _is_hex(ver) or ver == "ff":
        return None
    if ver == "00" and len(parts) != 4:
        return None
    if len(tid) != 32 or not _is_hex(tid) or tid == "0" * 32:
        return None
    if len(pid) != 16 or not _is_hex(pid) or pid == "0" * 16:
        return None
    if len(flags) != 2 or not _is_hex(flags):
        return None
    return tid, pid, int(flags, 16)


def extract(headers) -> "Optional[tuple[str, str, int, Optional[str]]]":
    """Lift ``(trace_id, parent_span_id, flags, tracestate)`` off an AMQP
    header table; None when absent or malformed (the publish proceeds on
    the normal seeded-sampling path either way)."""
    if not headers:
        return None
    raw = headers.get(TRACEPARENT_HEADER)
    if raw is None:
        return None
    parsed = parse_traceparent(raw)
    if parsed is None:
        return None
    state = headers.get(TRACESTATE_HEADER)
    if isinstance(state, (bytes, bytearray, memoryview)):
        try:
            state = bytes(state).decode("ascii")
        except UnicodeDecodeError:
            state = None
    if not isinstance(state, str) or not state:
        state = None
    return parsed[0], parsed[1], parsed[2], state


def format_traceparent(trace_id: str, span_id: str, flags: int = 1) -> str:
    return f"00-{trace_id}-{span_id}-{flags & 0xFF:02x}"


def derive_span_id(*parts: str) -> str:
    """Deterministic 8-byte span id (16 hex chars) from stable inputs.

    Derivation instead of randomness keeps two invariants: forced
    samples never consume the seeded sampling RNG, and re-rendering the
    same trace (push export then pull fallback) yields identical ids."""
    digest = hashlib.sha256(":".join(parts).encode()).digest()[:8]
    if digest == b"\x00" * 8:  # the all-zero span id is invalid
        digest = b"\x01" + digest[1:]
    return digest.hex()


def derive_trace_id(internal_id: str) -> str:
    """32-hex OTLP trace id for a seeded (headerless) sample, derived
    from the internal ``node#seq`` id so exports are stable per trace."""
    digest = hashlib.sha256(internal_id.encode()).digest()[:16]
    if digest == b"\x00" * 16:
        digest = b"\x01" + digest[1:]
    return digest.hex()


def stamp_headers(properties, ctx: W3CContext):
    """Copy-on-write rewrite of a BasicProperties with the outgoing
    context. Returns ``(properties, changed)``; when changed, callers
    must drop any cached header_raw so the next render re-encodes.

    COPY, never mutate: the connection layer's header cache shares
    BasicProperties objects across publishes with identical header
    bytes, so an in-place header write would poison unrelated messages.
    The rewrite is idempotent (same outgoing value -> unchanged), which
    keeps the remote-apply re-stamp on clustered pushes a no-op."""
    outgoing = ctx.outgoing
    headers = properties.headers
    if headers is not None and headers.get(TRACEPARENT_HEADER) == outgoing:
        return properties, False
    new_headers = dict(headers or {})
    new_headers[TRACEPARENT_HEADER] = outgoing
    if ctx.tracestate:
        new_headers[TRACESTATE_HEADER] = ctx.tracestate
    props = properties.copy()
    props.headers = new_headers
    return props, True
