"""Consistent-hash entity ownership.

The placement analogue of the reference's cluster sharding
(shard id = hash(entityId) % 100 spread over nodes, QueueEntity.scala:43-51):
entities map onto a consistent-hash ring of virtual nodes, so membership
changes move only ~1/N of the keyspace (the reference's shard rebalancing,
without a central coordinator).
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Iterable, Optional


def _hash(key: str) -> int:
    return int.from_bytes(hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")


class HashRing:
    def __init__(self, nodes: Iterable[str] = (), virtual_nodes: int = 64) -> None:
        self.virtual_nodes = virtual_nodes
        self._nodes: set[str] = set()
        self._ring: list[tuple[int, str]] = []
        for node in nodes:
            self._nodes.add(node)
        self._rebuild()

    def _rebuild(self) -> None:
        ring = []
        for node in self._nodes:
            for i in range(self.virtual_nodes):
                ring.append((_hash(f"{node}#{i}"), node))
        ring.sort()
        self._ring = ring
        self._points = [p for p, _ in ring]

    def set_nodes(self, nodes: Iterable[str]) -> None:
        new = set(nodes)
        if new != self._nodes:
            self._nodes = new
            self._rebuild()

    def add(self, node: str) -> None:
        if node not in self._nodes:
            self._nodes.add(node)
            self._rebuild()

    def remove(self, node: str) -> None:
        if node in self._nodes:
            self._nodes.discard(node)
            self._rebuild()

    @property
    def nodes(self) -> frozenset[str]:
        return frozenset(self._nodes)

    def owner(self, key: str) -> Optional[str]:
        """The node owning a key, or None when the ring is empty."""
        if not self._ring:
            return None
        idx = bisect.bisect_right(self._points, _hash(key)) % len(self._ring)
        return self._ring[idx][1]

    def owner_entity(self, kind: str, vhost: str, name: str) -> Optional[str]:
        # '\x00' can't appear in AMQP short strings, so the key is unambiguous
        return self.owner(f"{kind}\x00{vhost}\x00{name}")

    def preference(self, key: str, count: int) -> list[str]:
        """The first `count` DISTINCT nodes clockwise from the key's point
        (Dynamo-style preference list): [owner, 1st successor, ...]. Used by
        replication to pick follower nodes — successors keep the replica
        placement stable under membership churn (only ~1/N of keys move)."""
        if not self._ring or count <= 0:
            return []
        start = bisect.bisect_right(self._points, _hash(key)) % len(self._ring)
        out: list[str] = []
        for i in range(len(self._ring)):
            node = self._ring[(start + i) % len(self._ring)][1]
            if node not in out:
                out.append(node)
                if len(out) >= count:
                    break
        return out

    def preference_entity(
        self, kind: str, vhost: str, name: str, count: int
    ) -> list[str]:
        return self.preference(f"{kind}\x00{vhost}\x00{name}", count)
