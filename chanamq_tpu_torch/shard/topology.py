"""Deterministic shard topology: names, ports, and socket paths.

Both sides compute the same layout from the same inputs — the
supervisor from the merged config (then forwards the resolved pieces to
workers via ``CHANAMQ_SHARD_*`` environment variables), each worker
from those variables plus its per-process cluster port:

* shard ``i``'s cluster endpoint is ``host:(base_port + i)`` — member
  names stay ``host:port`` strings, so the hash ring, membership gossip
  and holder metadata need no new name syntax;
* shard ``i``'s RPC/data Unix socket is ``<dir>/shard-i.sock``;
* the fd-handoff feed (reuse-port fallback) is ``<dir>/handoff-i.sock``.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Iterable, Mapping, Optional


def resolve_count(config) -> int:
    """``chana.mq.shard.count``: 1 = off, 0 = one shard per core."""
    raw = config.int("chana.mq.shard.count")
    if raw <= 0:
        return os.cpu_count() or 1
    return raw


def resolve_dir(config) -> str:
    """The Unix-socket directory; created on demand. An explicit
    ``chana.mq.shard.dir`` wins; otherwise a fresh temp dir (socket
    paths must stay under the ~100-byte sun_path limit, so the store
    directory — often deep — is deliberately not the default)."""
    configured = str(config.get("chana.mq.shard.dir") or "")
    if configured:
        os.makedirs(configured, exist_ok=True)
        return configured
    return tempfile.mkdtemp(prefix="chanamq-shards-")


@dataclass(frozen=True)
class ShardTopology:
    count: int
    host: str
    base_port: int
    dir: str

    @classmethod
    def from_config(cls, config) -> "ShardTopology":
        """Supervisor-side construction from the merged config."""
        return cls(
            count=resolve_count(config),
            host=config.str("chana.mq.cluster.host"),
            base_port=config.int("chana.mq.cluster.port"),
            dir=resolve_dir(config),
        )

    @classmethod
    def from_env(
        cls, config, index: int,
        environ: Optional[Mapping[str, str]] = None,
    ) -> "ShardTopology":
        """Worker-side construction: the supervisor already overrode
        this process's ``chana.mq.cluster.port`` to ``base + index``,
        so the base is recovered by subtraction."""
        env = os.environ if environ is None else environ
        count = int(env.get("CHANAMQ_SHARD_COUNT") or 0) \
            or max(1, config.int("chana.mq.shard.count"))
        sdir = env.get("CHANAMQ_SHARD_DIR") \
            or str(config.get("chana.mq.shard.dir") or "")
        return cls(
            count=count,
            host=config.str("chana.mq.cluster.host"),
            base_port=config.int("chana.mq.cluster.port") - index,
            dir=sdir,
        )

    # -- layout ------------------------------------------------------------

    def name(self, index: int) -> str:
        return f"{self.host}:{self.base_port + index}"

    def names(self) -> list[str]:
        return [self.name(i) for i in range(self.count)]

    def uds_path(self, index: int) -> str:
        return os.path.join(self.dir, f"shard-{index}.sock")

    def handoff_path(self, index: int) -> str:
        return os.path.join(self.dir, f"handoff-{index}.sock")

    def uds_map_for(self, index: int) -> dict[str, str]:
        """Sibling member name -> Unix-socket path (self excluded)."""
        return {
            self.name(i): self.uds_path(i)
            for i in range(self.count) if i != index
        }

    def seeds_for(self, index: int, external: Iterable[str] = ()) -> list[str]:
        """Every sibling plus any cross-machine seeds from the config."""
        seeds = [self.name(i) for i in range(self.count) if i != index]
        for seed in external:
            if seed and seed not in seeds:
                seeds.append(seed)
        return seeds
