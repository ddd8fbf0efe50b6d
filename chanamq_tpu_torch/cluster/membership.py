"""Heartbeat membership with gossip piggyback.

The analogue of the reference's Akka cluster membership + phi-accrual failure
detection (chana-mq-base reference.conf:26-48): every node heartbeats every
alive peer on an interval; a peer silent past the failure timeout is marked
DOWN and leaves the ownership ring; heartbeats piggyback the sender's member
list (with incarnation counters) so views converge without a coordinator.
A downed node that comes back re-joins with a higher incarnation.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from .rpc import RpcClient, RpcError, RpcServer, UdsTransport

log = logging.getLogger("chanamq.membership")

ALIVE = "alive"
DOWN = "down"

# lifecycle states (gossiped independently of liveness): a node is born
# JOINING, turns ACTIVE once it has exchanged a heartbeat with the cluster,
# enters DRAINING when an operator starts an evacuation, and ends LEFT when
# every held queue has moved off. DRAINING/LEFT nodes stay out of the
# placement ring so no new holdership lands on them.
JOINING = "joining"
ACTIVE = "active"
DRAINING = "draining"
LEFT = "left"


@dataclass
class Member:
    name: str  # "host:port" of the node's RPC endpoint
    incarnation: int = 0
    status: str = ALIVE
    last_seen: float = field(default_factory=time.monotonic)
    # lifecycle travels on its own monotonic version so it converges even
    # when the incarnation counter (liveness suspicion) never moves
    lifecycle: str = ACTIVE
    lifecycle_version: int = 0

    @property
    def host(self) -> str:
        return self.name.rsplit(":", 1)[0]

    @property
    def port(self) -> int:
        return int(self.name.rsplit(":", 1)[1])


MembershipListener = Callable[[str, Member], None]  # (event, member)


class Membership:
    """Tracks the member set for one node."""

    def __init__(
        self,
        self_name: str,
        seeds: list[str],
        rpc_server: RpcServer,
        *,
        heartbeat_interval_s: float = 1.0,
        failure_timeout_s: float = 5.0,
        uds_map: Optional[dict[str, str]] = None,
    ) -> None:
        self.self_name = self_name
        self.seeds = [s for s in seeds if s != self_name]
        # member name -> Unix-socket path for sibling shards on this
        # machine: heartbeats and control RPC to them skip the TCP stack
        self.uds_map = dict(uds_map or {})
        self.heartbeat_interval_s = heartbeat_interval_s
        self.failure_timeout_s = failure_timeout_s
        self.incarnation = int(time.time() * 1000)
        lifecycle = JOINING if self.seeds else ACTIVE
        self.members: dict[str, Member] = {
            self_name: Member(self_name, self.incarnation,
                              lifecycle=lifecycle)
        }
        self.listeners: list[MembershipListener] = []
        # snowflake worker ids: this node's rides every view it sends, and
        # each peer's is kept as last gossiped. A peer holding ours with a
        # lower name calls on_worker_id_clash (set by the cluster node),
        # which moves this node to a free id. Views without the key (the
        # reference's nodes) change nothing.
        self.worker_id: Optional[int] = None
        self.peer_worker_ids: dict[str, int] = {}
        self.on_worker_id_clash: Optional[Callable[[], None]] = None
        self._clients: dict[str, RpcClient] = {}
        self._task: Optional[asyncio.Task] = None
        rpc_server.register("cluster.ping", self._on_ping)

    # -- view --------------------------------------------------------------

    def alive_members(self) -> list[str]:
        return sorted(
            name for name, m in self.members.items() if m.status == ALIVE
        )

    def is_alive(self, name: str) -> bool:
        member = self.members.get(name)
        return member is not None and member.status == ALIVE

    def lifecycle_of(self, name: str) -> str:
        member = self.members.get(name)
        return member.lifecycle if member is not None else ACTIVE

    def placement_members(self) -> list[str]:
        """Alive members eligible for NEW holdership: draining and left
        nodes keep serving what they still hold but take nothing new."""
        return [
            name for name in self.alive_members()
            if self.members[name].lifecycle not in (DRAINING, LEFT)
        ]

    def set_lifecycle(self, state: str) -> None:
        """Advance this node's own lifecycle state (version bump makes the
        transition win every gossip merge)."""
        me = self.members[self.self_name]
        if me.lifecycle == state:
            return
        me.lifecycle = state
        me.lifecycle_version += 1
        self._emit("lifecycle", me)

    def leader(self) -> str:
        """Deterministic leader: lowest alive name (the reference's
        cluster-singleton placement on the oldest node, approximated)."""
        alive = self.alive_members()
        return alive[0] if alive else self.self_name

    def client(self, name: str) -> RpcClient:
        client = self._clients.get(name)
        if client is None or client.closed:
            uds_path = self.uds_map.get(name)
            if uds_path is not None:
                client = RpcClient(UdsTransport(uds_path, peer=name))
            else:
                member = self.members.get(name)
                host, port = (member.host, member.port) if member else (
                    name.rsplit(":", 1)[0], int(name.rsplit(":", 1)[1]))
                client = RpcClient(host, port)
            self._clients[name] = client
        return client

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        for seed in self.seeds:
            self.members.setdefault(seed, Member(seed, 0))
        self._task = asyncio.get_event_loop().create_task(self._heartbeat_loop())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            self._task = None
        for client in self._clients.values():
            await client.close()
        self._clients.clear()

    # -- gossip ------------------------------------------------------------

    def _view(self) -> dict:
        view = {
            "from": self.self_name,
            "members": {
                name: {"incarnation": m.incarnation, "status": m.status,
                       "lc": m.lifecycle, "lv": m.lifecycle_version}
                for name, m in self.members.items()
            },
        }
        if self.worker_id is not None:
            view["worker_id"] = self.worker_id
        return view

    def _note_worker_id(self, view: dict) -> None:
        sender = str(view.get("from", ""))
        worker_id = view.get("worker_id")
        if not sender or sender == self.self_name or worker_id is None:
            return
        self.peer_worker_ids[sender] = int(worker_id)
        if (int(worker_id) == self.worker_id and sender < self.self_name
                and self.on_worker_id_clash is not None):
            self.on_worker_id_clash()

    def _merge_lifecycle(self, member: Member, info: dict) -> None:
        lv = int(info.get("lv", 0))
        if lv > member.lifecycle_version:
            member.lifecycle_version = lv
            state = str(info.get("lc", ACTIVE))
            if state != member.lifecycle:
                member.lifecycle = state
                self._emit("lifecycle", member)

    def _merge(self, view: dict) -> None:
        for name, info in (view.get("members") or {}).items():
            incarnation = int(info.get("incarnation", 0))
            status = str(info.get("status", ALIVE))
            if name == self.self_name:
                # a peer gossiping a higher-versioned lifecycle for US is
                # stale third-party state (e.g. a drain from a previous
                # identity): refute it with a yet-higher version
                me = self.members[name]
                lv = int(info.get("lv", 0))
                if lv > me.lifecycle_version:
                    if str(info.get("lc", ACTIVE)) == me.lifecycle:
                        me.lifecycle_version = lv
                    else:
                        me.lifecycle_version = lv + 1
                        self._emit("lifecycle", me)
                continue
            member = self.members.get(name)
            if member is None:
                member = Member(name, incarnation, status)
                member.last_seen = time.monotonic() if status == ALIVE else 0.0
                self.members[name] = member
                self._merge_lifecycle(member, info)
                if status == ALIVE:
                    self._emit("up", member)
                continue
            self._merge_lifecycle(member, info)
            if incarnation > member.incarnation:
                member.incarnation = incarnation
                if status == ALIVE and member.status != ALIVE:
                    member.status = ALIVE
                    member.last_seen = time.monotonic()
                    self._emit("up", member)
                elif status == DOWN and member.status != DOWN:
                    member.status = DOWN
                    self._emit("down", member)

    async def _on_ping(self, payload: dict) -> dict:
        sender = str(payload.get("from", ""))
        if sender and sender != self.self_name:
            member = self.members.get(sender)
            if member is None:
                member = Member(sender)
                self.members[sender] = member
                self._emit("up", member)
            elif member.status != ALIVE:
                member.status = ALIVE
                member.incarnation = max(
                    member.incarnation,
                    int((payload.get("members") or {})
                        .get(sender, {}).get("incarnation", 0)))
                self._emit("up", member)
            member.last_seen = time.monotonic()
        self._merge(payload)
        self._note_worker_id(payload)
        return self._view()

    async def _ping_peer(self, name: str) -> None:
        member = self.members[name]
        try:
            reply = await self.client(name).call(
                "cluster.ping", self._view(),
                timeout_s=self.failure_timeout_s / 2)
            member.last_seen = time.monotonic()
            if member.status != ALIVE:
                member.status = ALIVE
                self._emit("up", member)
            self._merge(reply)
            self._note_worker_id(reply)
            me = self.members[self.self_name]
            if me.lifecycle == JOINING:
                # first confirmed contact with the cluster: we're in
                self.set_lifecycle(ACTIVE)
        except (RpcError, OSError, asyncio.TimeoutError):
            if (member.status == ALIVE
                    and time.monotonic() - member.last_seen > self.failure_timeout_s):
                member.status = DOWN
                member.incarnation += 1
                log.warning("%s: marking %s DOWN", self.self_name, name)
                self._emit("down", member)

    async def _heartbeat_loop(self) -> None:
        try:
            while True:
                await asyncio.sleep(self.heartbeat_interval_s)
                peers = [n for n in self.members if n != self.self_name]
                # concurrent pings: a dead peer's timeout must not delay
                # detection (or gossip) for the others
                if peers:
                    await asyncio.gather(
                        *(self._ping_peer(name) for name in peers),
                        return_exceptions=True)
        except asyncio.CancelledError:
            pass

    def _emit(self, event: str, member: Member) -> None:
        log.info("%s: member %s %s", self.self_name, member.name, event)
        for listener in self.listeners:
            try:
                listener(event, member)
            except Exception:
                log.exception("membership listener failed")
