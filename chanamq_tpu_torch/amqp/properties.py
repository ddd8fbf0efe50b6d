"""Content-header frame and BasicProperties presence-flag codec.

Capability parity with the reference's content-header model
(chana-mq-base .../model/BasicProperties.scala:42-153,
 .../model/AMQContentHeader.scala:10-61): a HEADER frame payload is
class-id(2) weight(2)=0 body-size(8) property-flags then property values;
property flags are 15-bit words whose low bit signals a continuation word.
BasicProperties has 14 optional fields (content-type .. cluster-id).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, fields as dc_fields
from io import BytesIO
from typing import Any, BinaryIO, Optional

from . import value_codec as vc
from .constants import ClassId

# (field-name, flag-bit, domain); order is the wire order.
_PROPERTY_SPEC: tuple[tuple[str, int, str], ...] = (
    ("content_type", 15, "shortstr"),
    ("content_encoding", 14, "shortstr"),
    ("headers", 13, "table"),
    ("delivery_mode", 12, "octet"),
    ("priority", 11, "octet"),
    ("correlation_id", 10, "shortstr"),
    ("reply_to", 9, "shortstr"),
    ("expiration", 8, "shortstr"),
    ("message_id", 7, "shortstr"),
    ("timestamp", 6, "longlong"),
    ("type", 5, "shortstr"),
    ("user_id", 4, "shortstr"),
    ("app_id", 3, "shortstr"),
    ("cluster_id", 2, "shortstr"),
)

DELIVERY_MODE_TRANSIENT = 1
DELIVERY_MODE_PERSISTENT = 2


@dataclass(slots=True)
class BasicProperties:
    content_type: Optional[str] = None
    content_encoding: Optional[str] = None
    headers: Optional[dict[str, Any]] = None
    delivery_mode: Optional[int] = None
    priority: Optional[int] = None
    correlation_id: Optional[str] = None
    reply_to: Optional[str] = None
    expiration: Optional[str] = None
    message_id: Optional[str] = None
    timestamp: Optional[int] = None
    type: Optional[str] = None
    user_id: Optional[str] = None
    app_id: Optional[str] = None
    cluster_id: Optional[str] = None

    @property
    def is_persistent(self) -> bool:
        return self.delivery_mode == DELIVERY_MODE_PERSISTENT

    def expiration_ms(self) -> Optional[int]:
        """Per-message TTL: the expiration property is a shortstr of millis."""
        if not self.expiration:
            return None
        try:
            return int(self.expiration)
        except ValueError:
            return None

    # -- codec ------------------------------------------------------------

    def write_properties(self, out: BinaryIO) -> None:
        flags = 0
        for name, bit, _ in _PROPERTY_SPEC:
            if getattr(self, name) is not None:
                flags |= 1 << bit
        # Single flag word suffices: 14 properties fit in one 15-bit word, so
        # the continuation bit (bit 0) is never set for basic-class content.
        vc.write_short(out, flags)
        for name, bit, domain in _PROPERTY_SPEC:
            value = getattr(self, name)
            if value is None:
                continue
            if domain == "shortstr":
                vc.write_shortstr(out, value)
            elif domain == "octet":
                vc.write_octet(out, value)
            elif domain == "longlong":
                vc.write_longlong(out, value)
            elif domain == "table":
                vc.write_table(out, value)

    @classmethod
    def read_properties(cls, stream: BinaryIO) -> "BasicProperties":
        # Collect flag words, honoring the continuation bit.
        flag_words = [vc.read_short(stream)]
        while flag_words[-1] & 0x0001:
            flag_words.append(vc.read_short(stream))
        props = cls()
        for name, bit, domain in _PROPERTY_SPEC:
            if not flag_words[0] & (1 << bit):
                continue
            if domain == "shortstr":
                setattr(props, name, vc.read_shortstr(stream))
            elif domain == "octet":
                setattr(props, name, vc.read_octet(stream))
            elif domain == "longlong":
                setattr(props, name, vc.read_longlong(stream))
            elif domain == "table":
                setattr(props, name, vc.read_table(stream))
        return props

    # -- header frame payload ---------------------------------------------

    def encode_header(self, body_size: int) -> bytes:
        out = BytesIO()
        out.write(struct.pack(">HHQ", ClassId.BASIC, 0, body_size))
        self.write_properties(out)
        return out.getvalue()

    @staticmethod
    def decode_header(payload: bytes) -> tuple[int, int, "BasicProperties"]:
        """Decode a HEADER-frame payload -> (class_id, body_size, properties).

        Hot loop: the two overwhelmingly common property shapes — no
        properties, and delivery-mode only — decode without the generic
        flag-walk."""
        if len(payload) < 14:
            raise ValueError("content header shorter than 14 bytes")
        class_id = (payload[0] << 8) | payload[1]
        body_size = int.from_bytes(payload[4:12], "big")
        flags = (payload[12] << 8) | payload[13]
        if flags == 0 and len(payload) == 14:
            return class_id, body_size, BasicProperties()
        if flags == 0x1000 and len(payload) == 15:  # delivery-mode only
            return class_id, body_size, BasicProperties(delivery_mode=payload[14])
        stream = BytesIO(payload)
        stream.seek(12)
        props = BasicProperties.read_properties(stream)
        return class_id, body_size, props

    def copy(self) -> "BasicProperties":
        values = {f.name: getattr(self, f.name) for f in dc_fields(self)}
        if values.get("headers") is not None:
            values["headers"] = dict(values["headers"])
        return BasicProperties(**values)
