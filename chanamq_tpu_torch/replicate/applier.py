"""Follower-side replication: apply shipped event batches to a warm copy.

A ReplicaCopy mirrors one queue's durable state — the ready-row list, the
unack map, the watermark, and the queue meta — both in memory (for instant
promotion election and materialization) and in the local store under the
replica namespace (so a follower restart doesn't silently forget copies it
acked; see store.api.replica_vhost).

Message blobs are shared with the node's regular store rows by id. The
applier refcounts each blob (one ref per ready row + one per unack entry
naming it) and only deletes a blob at refcount zero if the applier itself
inserted it (`_owned_blobs`): in shared-store deployments the owner's own
blob row is already present and must never be collected from under it.

Gap handling: the owner keeps no shipped-event history, so a follower that
receives a batch whose base is beyond applied+1 buffers it and resyncs
wholesale from the owner's store. All replica store ops are upsert/delete
style, so events at or below the resync snapshot's seq re-apply
idempotently afterwards.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import TYPE_CHECKING

from ..store.api import StoredMessage, StoredQueue, replica_vhost

if TYPE_CHECKING:  # pragma: no cover
    from .log import ReplicationManager

log = logging.getLogger("chanamq.replicate")

_FETCH_CHUNK = 128  # blob ids per repl.fetch round-trip


class ReplicaCopy:
    """One queue's passive copy on a follower node."""

    __slots__ = ("vhost", "name", "owner", "applied_seq", "resyncing",
                 "buffered", "rows", "unacks", "wm", "ttl_ms", "arguments",
                 "meta_written", "peer_acks")

    def __init__(self, vhost: str, name: str, owner: str) -> None:
        self.vhost = vhost
        self.name = name
        self.owner = owner
        self.applied_seq = 0
        self.resyncing = False
        self.buffered: list[dict] = []      # batches parked during resync/gap
        # offset -> (msg_id, body_size, expire_at_ms): the ready rows
        self.rows: dict[int, tuple[int, int, object]] = {}
        # msg_id -> (offset, body_size, expire_at_ms): in-flight deliveries
        self.unacks: dict[int, tuple[int, int, object]] = {}
        self.wm = 0
        self.ttl_ms = None
        self.arguments: dict = {}
        self.meta_written = False
        self.peer_acks: dict[str, int] = {}  # owner's last shipped ack map


class ReplicaApplier:
    def __init__(self, manager: "ReplicationManager") -> None:
        self.manager = manager
        self.copies: dict[tuple[str, str], ReplicaCopy] = {}
        self._blob_refs: dict[int, int] = {}
        self._owned_blobs: set[int] = set()

    @property
    def _store(self):
        return self.manager.broker.store

    def _bg(self, aw) -> None:
        self.manager.broker.store_bg(aw)

    # ------------------------------------------------------------------
    # RPC entry point
    # ------------------------------------------------------------------

    async def h_probe(self, payload: dict) -> dict:
        """Sync probe for the graceful-handoff gate: report how far this
        node's copy of a queue has applied (−1: no copy for that owner)."""
        copy = self.copies.get((str(payload["vhost"]),
                                str(payload["queue"])))
        if copy is None or copy.owner != str(payload.get("owner") or ""):
            return {"applied": -1}
        return {"applied": copy.applied_seq, "resyncing": copy.resyncing}

    async def h_retire(self, payload: dict) -> dict:
        """The owner dropped this node from a queue's follower set (ring
        reshuffle on join/leave): discard the copy. It would never see
        another ship, so keeping it is not redundancy — it is a stale
        ack map waiting to split a future failover election."""
        key = (str(payload["vhost"]), str(payload["queue"]))
        copy = self.copies.get(key)
        if copy is None or copy.owner != str(payload.get("owner") or ""):
            return {"retired": False}
        self._discard(copy)
        return {"retired": True}

    async def h_append(self, payload: dict) -> dict:
        vhost = str(payload["vhost"])
        name = str(payload["queue"])
        owner = str(payload["owner"])
        key = (vhost, name)
        epoch = int(payload.get("epoch") or 0)
        node = self.manager.node
        known = node.queue_epoch(vhost, name)
        if epoch and known > epoch:
            # fenced: the shipper lost holdership (drain/handoff bumped the
            # epoch) but doesn't know yet — a partitioned ex-owner must not
            # graft its stale history onto the copy of the queue's new life
            node.broker.metrics.lifecycle_stale_epoch_refused += 1
            log.warning("%s: refused stale-epoch ship of %s/%s from %s "
                        "(epoch %d < %d)", node.name, vhost, name, owner,
                        epoch, known)
            return {"applied": 0, "refused": True}
        copy = self.copies.get(key)
        if copy is not None and copy.owner != owner:
            # the queue moved (promotion elsewhere, or a delete+redeclare
            # landing on a new owner): the old copy's history is dead
            self._discard(copy)
            copy = None
        if copy is None:
            copy = ReplicaCopy(vhost, name, owner)
            self.copies[key] = copy
        copy.peer_acks = dict(payload.get("acks") or {})
        if copy.resyncing:
            copy.buffered.append(payload)
            return {"applied": copy.applied_seq}
        base = int(payload["base"])
        if base > copy.applied_seq + 1:
            copy.buffered.append(payload)
            self._start_resync(copy)
            return {"applied": copy.applied_seq}
        await self._apply_events(copy, payload["events"])
        return {"applied": copy.applied_seq}

    # ------------------------------------------------------------------
    # event application
    # ------------------------------------------------------------------

    async def _apply_events(self, copy: ReplicaCopy, events: list) -> None:
        key = (copy.vhost, copy.name)
        for event in events:
            if self.copies.get(key) is not copy:
                return  # a delete event discarded the copy mid-batch
            seq = int(event["s"])
            if seq <= copy.applied_seq:
                continue  # idempotent replay past a resync snapshot
            ok = await self._apply(copy, str(event["op"]), event)
            if ok is False:
                self._start_resync(copy)
                return
            copy.applied_seq = seq
            self.manager.metrics.repl_events_applied += 1

    async def _apply(self, copy: ReplicaCopy, op: str, ev: dict):
        rv = replica_vhost(copy.vhost)
        store = self._store
        if op == "enqueue":
            if ev.get("body") is None:
                # a fanout sibling passivated the shared body before we got
                # the event: the blob lives only in the owner's store now
                return False
            self._write_meta_if_new(copy)
            mid = int(ev["m"])
            await self._ensure_blob(
                mid, ev.get("props"), ev["body"], str(ev.get("ex") or ""),
                str(ev.get("rk") or ""), ev.get("ttl"))
            off = int(ev["o"])
            copy.rows[off] = (mid, int(ev["z"]), ev.get("e"))
            self._ref(mid)
            self._bg(store.insert_queue_msg(
                rv, copy.name, off, mid, int(ev["z"]), ev.get("e")))
        elif op == "row_add":
            # requeue re-insert: the blob is already resident (its unack
            # entry holds a ref; the owner ships row_add before unack_del)
            mid = int(ev["m"])
            if mid not in self._blob_refs:
                return False
            self._write_meta_if_new(copy)
            off = int(ev["o"])
            copy.rows[off] = (mid, int(ev["z"]), ev.get("e"))
            self._ref(mid)
            self._bg(store.insert_queue_msg(
                rv, copy.name, off, mid, int(ev["z"]), ev.get("e")))
        elif op == "unacks":
            self._write_meta_if_new(copy)
            batch = []
            for mid, off, z, e in ev.get("rows") or []:
                mid = int(mid)
                if mid not in self._blob_refs:
                    return False  # delivery of a row we never saw
                copy.unacks[mid] = (int(off), int(z), e)
                self._ref(mid)
                batch.append((mid, int(off), int(z), e))
            if batch:
                self._bg(store.insert_queue_unacks(rv, copy.name, batch))
        elif op == "unack_del":
            ids = [int(i) for i in ev.get("ids") or []]
            dropped = [i for i in ids if copy.unacks.pop(i, None) is not None]
            if dropped:
                self._bg(store.delete_queue_unacks(rv, copy.name, dropped))
                for mid in dropped:
                    self._unref(mid)
        elif op == "row_del":
            offs = [int(o) for o in ev.get("offs") or []]
            gone = [copy.rows.pop(o) for o in offs if o in copy.rows]
            if gone:
                self._bg(store.delete_queue_msgs_offsets(rv, copy.name, offs))
                for mid, _z, _e in gone:
                    self._unref(mid)
        elif op == "watermark":
            # moves both ways: dispatch advances it, a requeue rewinds it
            # (store semantics make rewind a pure meta update — the delete
            # of rows <= wm just covers fewer rows)
            wm = int(ev["wm"])
            if wm > copy.wm:
                stale = [o for o in copy.rows if o <= wm]
                for off in stale:
                    mid, _z, _e = copy.rows.pop(off)
                    self._unref(mid)
            copy.wm = wm
            self._write_meta_if_new(copy)
            self._bg(store.update_queue_last_consumed(rv, copy.name, wm))
        elif op == "purge":
            for mid, _z, _e in copy.rows.values():
                self._unref(mid)
            copy.rows.clear()
            self._bg(store.purge_queue_msgs(rv, copy.name))
        elif op == "meta":
            copy.ttl_ms = ev.get("ttl")
            try:
                copy.arguments = json.loads(ev.get("args") or "{}")
            except ValueError:
                copy.arguments = {}
            if int(ev.get("backlog") or 0) > 0 and not copy.rows \
                    and not copy.unacks:
                # the queue predates this log binding (or predates us as a
                # follower): the event stream alone can't rebuild it
                return False
            if int(ev.get("wm") or 0) > copy.wm:
                copy.wm = int(ev["wm"])
            self._write_meta(copy)
        elif op == "delete":
            self._discard(copy)
        else:
            log.warning("unknown replication op %r for %s/%s",
                        op, copy.vhost, copy.name)
        return True

    # ------------------------------------------------------------------
    # blob refcounting
    # ------------------------------------------------------------------

    async def _ensure_blob(self, mid, props, body, exchange, routing_key,
                           ttl_ms) -> None:
        if mid in self._blob_refs:
            return
        existing = await self._store.select_message_metas([mid])
        if mid in existing:
            # shared-store deployment: the owner's row is already visible
            # here — reference it, never own (and never delete) it
            self._blob_refs.setdefault(mid, 0)
            return
        self._bg(self._store.insert_message(StoredMessage(
            id=mid, properties_raw=props or b"", body=body,
            exchange=exchange, routing_key=routing_key,
            refer_count=1, ttl_ms=ttl_ms)))
        self._owned_blobs.add(mid)
        self._blob_refs.setdefault(mid, 0)

    def _ref(self, mid: int) -> None:
        self._blob_refs[mid] = self._blob_refs.get(mid, 0) + 1

    def _unref(self, mid: int) -> None:
        n = self._blob_refs.get(mid, 0) - 1
        if n > 0:
            self._blob_refs[mid] = n
            return
        self._blob_refs.pop(mid, None)
        if mid in self._owned_blobs:
            self._owned_blobs.discard(mid)
            self._bg(self._store.delete_message(mid))

    def _release_blob(self, mid: int) -> None:
        """Drop tracking without deleting: promotion moved the blob's
        ownership to the live queue."""
        self._blob_refs.pop(mid, None)
        self._owned_blobs.discard(mid)

    # ------------------------------------------------------------------
    # replica-namespace meta
    # ------------------------------------------------------------------

    def _write_meta_if_new(self, copy: ReplicaCopy) -> None:
        if not copy.meta_written:
            self._write_meta(copy)

    def _write_meta(self, copy: ReplicaCopy) -> None:
        # MemoryStore row writes silently no-op without a meta row, so this
        # must land (same FIFO) before the first row write
        self._bg(self._store.insert_queue_meta(StoredQueue(
            vhost=replica_vhost(copy.vhost), name=copy.name, durable=True,
            ttl_ms=copy.ttl_ms, last_consumed=copy.wm,
            arguments=dict(copy.arguments))))
        copy.meta_written = True

    # ------------------------------------------------------------------
    # teardown / promotion handoff
    # ------------------------------------------------------------------

    def _discard(self, copy: ReplicaCopy) -> None:
        """Queue deleted (or copy superseded): unreference everything,
        collecting owned blobs, and drop the replica-namespace rows."""
        for mid, _z, _e in copy.rows.values():
            self._unref(mid)
        for mid in copy.unacks:
            self._unref(mid)
        copy.rows.clear()
        copy.unacks.clear()
        copy.buffered.clear()
        self._bg(self._store.delete_queue(replica_vhost(copy.vhost),
                                          copy.name))
        self.copies.pop((copy.vhost, copy.name), None)

    def release_copy(self, key: tuple[str, str]) -> None:
        """Promotion handoff: stop tracking the copy WITHOUT deleting its
        blobs — they now back the live queue's rows."""
        copy = self.copies.pop(key, None)
        if copy is None:
            return
        for mid, _z, _e in copy.rows.values():
            self._release_blob(mid)
        for mid in copy.unacks:
            self._release_blob(mid)
        self._bg(self._store.delete_queue(replica_vhost(copy.vhost),
                                          copy.name))

    # ------------------------------------------------------------------
    # resync
    # ------------------------------------------------------------------

    def _start_resync(self, copy: ReplicaCopy) -> None:
        if copy.resyncing:
            return
        copy.resyncing = True
        asyncio.get_event_loop().create_task(self._resync(copy))

    async def _resync(self, copy: ReplicaCopy) -> None:
        from ..cluster.rpc import RpcError, RpcTimeout

        key = (copy.vhost, copy.name)
        mgr = self.manager
        self.manager.metrics.repl_resyncs += 1
        try:
            client = mgr.client_for(copy.owner)
            snap = await client.call(
                "repl.resync", {"vhost": copy.vhost, "queue": copy.name},
                timeout_s=max(5.0, mgr.ack_timeout_s))
            rows = [tuple(r) for r in snap.get("rows") or []]
            while snap.get("more"):
                after = rows[-1][0] if rows else 0
                snap_more = await client.call(
                    "repl.rows",
                    {"vhost": copy.vhost, "queue": copy.name, "after": after},
                    timeout_s=max(5.0, mgr.ack_timeout_s))
                page = [tuple(r) for r in snap_more.get("rows") or []]
                if not page:
                    break
                rows.extend(page)
                snap["more"] = snap_more.get("more")
            unacks = {int(m): (int(o), int(z), e)
                      for m, o, z, e in snap.get("unacks") or []}
            need = {int(r[1]) for r in rows} | set(unacks)
            missing = sorted(
                mid for mid in need if mid not in self._blob_refs)
            if missing:
                local = await self._store.select_message_metas(missing)
                missing = [m for m in missing if m not in local]
                for m in need:
                    if m in local:
                        self._blob_refs.setdefault(m, 0)  # shared store
            for i in range(0, len(missing), _FETCH_CHUNK):
                chunk = missing[i:i + _FETCH_CHUNK]
                got = await client.call(
                    "repl.fetch", {"ids": chunk},
                    timeout_s=max(5.0, mgr.ack_timeout_s))
                for mid, props, body, ex, rk, ttl in got.get("msgs") or []:
                    mid = int(mid)
                    self._bg(self._store.insert_message(StoredMessage(
                        id=mid, properties_raw=props or b"", body=body or b"",
                        exchange=str(ex or ""), routing_key=str(rk or ""),
                        refer_count=1, ttl_ms=ttl)))
                    self._owned_blobs.add(mid)
                    self._blob_refs.setdefault(mid, 0)
            if self.copies.get(key) is not copy:
                return  # deleted while we were syncing
            # install: swap the old state's refs for the snapshot's
            for mid, _z, _e in copy.rows.values():
                self._unref(mid)
            for mid in copy.unacks:
                self._unref(mid)
            copy.rows = {int(o): (int(m), int(z), e) for o, m, z, e in rows}
            copy.unacks = unacks
            copy.wm = int(snap.get("wm") or 0)
            copy.ttl_ms = snap.get("ttl")
            try:
                copy.arguments = json.loads(snap.get("args") or "{}")
            except ValueError:
                copy.arguments = {}
            for mid, _z, _e in copy.rows.values():
                self._ref(mid)
            for mid in copy.unacks:
                self._ref(mid)
            copy.applied_seq = int(snap.get("seq") or 0)
            copy.meta_written = False
            self._write_meta(copy)
            rv = replica_vhost(copy.vhost)
            self._bg(self._store.replace_queue_msgs(
                rv, copy.name,
                [(o, m, z, e) for o, (m, z, e) in sorted(copy.rows.items())]))
            self._bg(self._store.replace_queue_unacks(
                rv, copy.name,
                [(m, o, z, e) for m, (o, z, e) in copy.unacks.items()]))
            log.info("resynced replica %s/%s from %s at seq %d "
                     "(%d rows, %d unacks)", copy.vhost, copy.name,
                     copy.owner, copy.applied_seq, len(copy.rows),
                     len(copy.unacks))
        except (RpcError, RpcTimeout, OSError) as exc:
            # drop the parked batches: replaying them against stale state
            # would immediately re-trigger resync in a tight loop; the next
            # live batch gap-detects and retries instead
            copy.buffered.clear()
            log.warning("resync of %s/%s from %s failed: %r",
                        copy.vhost, copy.name, copy.owner, exc)
        except Exception:
            copy.buffered.clear()
            log.exception("resync of %s/%s from %s failed",
                          copy.vhost, copy.name, copy.owner)
        finally:
            copy.resyncing = False
            buffered, copy.buffered = copy.buffered, []
            gapped = False
            for payload in sorted(buffered,
                                  key=lambda p: int(p.get("base") or 0)):
                if self.copies.get(key) is not copy:
                    break
                base = int(payload.get("base") or 0)
                if base > copy.applied_seq + 1:
                    gapped = True
                    copy.buffered.append(payload)
                    continue
                await self._apply_events(copy, payload.get("events") or [])
            if gapped and self.copies.get(key) is copy \
                    and not copy.resyncing:
                self._start_resync(copy)
