"""Compiled binding tables as device tensors.

``compile.py`` builds each kernel table as numpy arrays (the ``wild`` dict
of a topic snapshot, the ``headers`` dict of a headers snapshot). This
module moves one such table to a ``torch.device`` in the layout the match
kernels take: int32 token and pair-id matrices, int32 lengths, bool flags,
and the queue bitmask rows as int32 bit patterns, checked once and with
their transposed copies beside them (``kernels/router_match.py``'s
``TopicTable`` and ``HeadersTable``). A snapshot uploads its table once.

Why int32 masks: torch's uint32 lacks CPU shift kernels ("rshift_cpu" is
not implemented for 'UInt32'), and the kernels only move and OR the bits.
``np_masks.view(np.int32)`` keeps every bit; the router views the kernel's
output back to ``np.uint32`` on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import router_match

_TOPIC_KEYS = ("pre", "suf", "plen", "slen", "has_hash")
_HEADERS_KEYS = ("req", "rcount", "is_all")


def tables_from_numpy(table: dict, device: "torch.device | str"):
    """Upload one compiled ``wild`` (topic) or ``headers`` table to
    ``device``: a ``TopicTable`` or ``HeadersTable`` of the kernel's
    inputs."""
    if "pre" in table:
        keys, make = _TOPIC_KEYS, router_match.topic_table
    elif "req" in table:
        keys, make = _HEADERS_KEYS, router_match.headers_table
    else:
        raise ValueError("not a compiled topic or headers table")
    out = {k: torch.from_numpy(np.ascontiguousarray(table[k])).to(device)
           for k in keys}
    masks = np.ascontiguousarray(table["masks"], dtype=np.uint32)
    out["masks"] = torch.from_numpy(masks.view(np.int32)).to(device)
    return make(**out)
