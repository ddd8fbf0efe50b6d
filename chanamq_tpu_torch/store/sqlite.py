"""SQLite StoreService — the durable backend, with group commit.

Capability parity with the reference's CassandraOpService
(chana-mq-server .../store/cassandra/CassandraOpService.scala:46-756): same
schema shape — message blobs + refcount, queue log keyed (queue, offset),
queue metas with a lastConsumed watermark, unacks, binds, vhosts, and
*_deleted archival copies on queue delete (pendingDeleteQueue,
CassandraOpService.scala:561-604).

Design difference from the reference, on purpose. The reference's `execute`
blocked its calling thread per operation while pretending to be async
(CassandraOpService.scala:753-755) — SURVEY.md §7.3 flags that as its
weakest scar. Here the store **group-commits**:

- every operation is enqueued synchronously (strict program order) and
  returns an asyncio.Future;
- one dedicated writer thread drains the queue in batches: all ops queued
  while the previous batch was committing run inside ONE transaction with
  ONE commit, each op isolated by a savepoint;
- an op's future resolves only after the COMMIT that covers it, so awaiting
  any write is a durability barrier — and `flush()` gives callers a barrier
  over everything enqueued so far (the broker awaits it before releasing
  publisher confirms).

Reads ride the same FIFO queue, so read-your-writes ordering holds without
blocking the event loop. TTL expiry is a stored expire_at timestamp filtered
on read (the analogue of Cassandra row TTL).
"""

from __future__ import annotations

import asyncio
import json
import logging
import sqlite3
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional, TypeVar

from .api import (
    StoredExchange, StoredMessage, StoredQueue, StoreService,
    is_replica_vhost,
)

log = logging.getLogger("chanamq.store")

T = TypeVar("T")

_SCHEMA = """
CREATE TABLE IF NOT EXISTS msgs (
  id INTEGER PRIMARY KEY, header BLOB, body BLOB,
  exchange TEXT, routing_key TEXT, refer_count INTEGER, ttl_ms INTEGER
);
CREATE TABLE IF NOT EXISTS queue_metas (
  vhost TEXT, name TEXT, durable INTEGER, exclusive_ INTEGER,
  auto_delete INTEGER, ttl_ms INTEGER, last_consumed INTEGER,
  arguments TEXT, PRIMARY KEY (vhost, name)
);
CREATE TABLE IF NOT EXISTS queue_msgs (
  vhost TEXT, queue TEXT, offset INTEGER, msg_id INTEGER,
  body_size INTEGER, expire_at_ms INTEGER,
  PRIMARY KEY (vhost, queue, offset)
);
CREATE TABLE IF NOT EXISTS queue_unacks (
  vhost TEXT, queue TEXT, msg_id INTEGER, offset INTEGER,
  body_size INTEGER, expire_at_ms INTEGER,
  PRIMARY KEY (vhost, queue, msg_id)
);
CREATE TABLE IF NOT EXISTS exchanges (
  vhost TEXT, name TEXT, type TEXT, durable INTEGER,
  auto_delete INTEGER, internal INTEGER, arguments TEXT,
  PRIMARY KEY (vhost, name)
);
CREATE TABLE IF NOT EXISTS binds (
  vhost TEXT, exchange TEXT, queue TEXT, routing_key TEXT, arguments TEXT,
  PRIMARY KEY (vhost, exchange, queue, routing_key)
);
CREATE TABLE IF NOT EXISTS exchange_binds (
  vhost TEXT, exchange TEXT, destination TEXT, routing_key TEXT, arguments TEXT,
  PRIMARY KEY (vhost, exchange, destination, routing_key)
);
CREATE TABLE IF NOT EXISTS stream_segments (
  vhost TEXT, queue TEXT, base_offset INTEGER, last_offset INTEGER,
  first_ts_ms INTEGER, last_ts_ms INTEGER, size_bytes INTEGER, blob BLOB,
  PRIMARY KEY (vhost, queue, base_offset)
);
CREATE TABLE IF NOT EXISTS stream_cursors (
  vhost TEXT, queue TEXT, name TEXT, committed_offset INTEGER,
  PRIMARY KEY (vhost, queue, name)
);
CREATE TABLE IF NOT EXISTS vhosts (name TEXT PRIMARY KEY, active INTEGER);
CREATE TABLE IF NOT EXISTS cluster_kv (key TEXT PRIMARY KEY, value INTEGER);
CREATE TABLE IF NOT EXISTS queue_metas_deleted (
  vhost TEXT, name TEXT, meta TEXT, PRIMARY KEY (vhost, name)
);
CREATE TABLE IF NOT EXISTS queue_msgs_deleted (
  vhost TEXT, queue TEXT, offset INTEGER, msg_id INTEGER,
  body_size INTEGER, expire_at_ms INTEGER,
  PRIMARY KEY (vhost, queue, offset)
);
CREATE TABLE IF NOT EXISTS queue_unacks_deleted (
  vhost TEXT, queue TEXT, msg_id INTEGER, offset INTEGER,
  body_size INTEGER, expire_at_ms INTEGER,
  PRIMARY KEY (vhost, queue, msg_id)
);
"""


class SqliteStore(StoreService):
    def __init__(self, path: str = ":memory:",
                 synchronous: str = "NORMAL") -> None:
        self.path = path
        # durability tier (PRAGMA synchronous, config
        # chana.mq.store.synchronous): NORMAL (default) survives process
        # crashes — a COMMIT is in the OS page cache and the WAL replays
        # after SIGKILL — but a POWER loss can roll back recently-committed
        # transactions (confirms included). FULL fsyncs every group commit:
        # power-loss durable, at a large cost to persistent throughput.
        # The reference inherited whatever its Cassandra cluster was
        # configured for; here the knob is explicit.
        if synchronous.upper() not in ("OFF", "NORMAL", "FULL", "EXTRA"):
            raise ValueError(f"bad synchronous level {synchronous!r}")
        self.synchronous = synchronous.upper()
        self._db: Optional[sqlite3.Connection] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # single writer thread => strict FIFO op ordering
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="store")
        # group-commit state (event-loop side)
        self._pending: list[
            tuple[Callable[[sqlite3.Connection], Any], asyncio.Future, bool, int]
        ] = []
        self._flush_scheduled = False
        self._batch_in_flight = False
        # failure attribution: every op gets a sequence number at enqueue;
        # failed ops (op error or commit failure) record their seq so a
        # durability barrier can raise for exactly the ops it covers.
        # Callers that promise durability for a specific window (publisher
        # confirms, cluster push replies) capture mark() around their
        # enqueues and pass those intervals to flush() — so one publisher's
        # failed insert never errors (or silently passes under) another
        # publisher's barrier (the reference's scar this engine was built to
        # beat, CassandraOpService.scala:753-755).
        self._op_seq = 0
        self._failed_seqs: list[int] = []
        self._failed_floor = 0  # seqs <= floor were dropped from the list:
        # any interval reaching below it reports failure conservatively
        self._reported_mark = 0  # consume-once watermark for global flush()

    # -- group-commit engine ----------------------------------------------

    def _enqueue(self, fn, fut, guard: bool) -> None:
        """Append one op entry and schedule a kick — the single place the
        seq-increment / append / coalescing-kick dance lives."""
        self._op_seq += 1
        self._pending.append((fn, fut, guard, self._op_seq))
        if not self._flush_scheduled:
            # coalesce everything submitted this loop tick into one batch
            self._flush_scheduled = True
            loop = self._loop or asyncio.get_running_loop()
            loop.call_soon(self._kick)

    def _submit(
        self, fn: Callable[[sqlite3.Connection], T], guard: bool = True
    ) -> "asyncio.Future[T]":
        """Enqueue one op; returns a future resolved after the commit that
        covers it. Enqueue order == execution order (program order).

        guard=False marks ops whose body is a single SQL statement (or one
        executemany): a lone statement is atomic by itself, so the per-op
        savepoint wrapper is skipped. Multi-statement ops keep the savepoint
        so a mid-op failure can't leave a partial effect in the batch."""
        loop = self._loop or asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._enqueue(fn, fut, guard)
        return fut

    def _submit_nowait(self, fn: Callable[[sqlite3.Connection], Any],
                       guard: bool = False) -> None:
        """Enqueue a fire-and-forget op: same FIFO queue and sequence
        numbering as _submit (so durability-barrier attribution covers it),
        but no future/callback machinery — the per-message hot path
        (message blob + queue-log inserts) pays only a lambda and a list
        append. Failures are logged and recorded for barriers."""
        self._enqueue(fn, None, guard)

    def _submit_row(self, sql: str, params: tuple) -> None:
        """Fire-and-forget single-row statement, enqueued as (sql, params)
        data instead of a callable: the writer thread coalesces rows with
        the same SQL into one executemany per batch (one savepoint per
        group), cutting per-row statement overhead on the per-message hot
        ops.

        ORDERING CONTRACT — weaker than _submit/_submit_nowait: rows with
        the SAME SQL keep their relative order, and all rows execute before
        the next callable op, but rows with DIFFERENT SQL may reorder
        against each other within a batch. Only route a statement through
        here if it commutes with every other _submit_row statement — in
        practice: the statements must target distinct tables (today: msgs
        vs queue_msgs). A same-table insert+delete pair would silently
        swap; keep such ops on _submit/_submit_nowait."""
        self._enqueue((sql, params), None, False)

    def _kick(self) -> None:
        self._flush_scheduled = False
        self._maybe_dispatch_batch()

    def _maybe_dispatch_batch(self) -> None:
        if self._batch_in_flight or not self._pending or self._db is None:
            return
        self._batch_in_flight = True
        batch = self._pending
        self._pending = []
        db = self._db
        loop = self._loop
        assert loop is not None

        def run_batch() -> None:
            results: list[tuple[asyncio.Future, Any, Optional[BaseException], int]] = []
            try:
                # IMMEDIATE: take the write lock up front so multi-process
                # users (nodes sharing a db file) serialize cleanly
                db.execute("BEGIN IMMEDIATE")
            except Exception as exc:  # pragma: no cover - disk/lock failure
                loop.call_soon_threadsafe(
                    self._batch_done, [(f, None, exc, s) for _, f, _, s in batch])
                return
            # _submit_row ops accumulate into per-SQL groups, one
            # executemany + savepoint per group. Rows with different SQL
            # target different tables (or distinct keys) and commute; any
            # opaque callable op is a reorder barrier — groups flush before
            # it runs, so row-vs-callable order is preserved exactly. On a
            # group failure every row in it reports failed — conservative
            # (the rollback undoes all of them) and barrier-correct.
            pending_rows: dict[str, tuple[list, list]] = {}

            def flush_rows() -> None:
                for sql, (rows, seqs) in pending_rows.items():
                    try:
                        db.execute("SAVEPOINT op")
                        db.executemany(sql, rows)
                        db.execute("RELEASE SAVEPOINT op")
                        results.extend((None, None, None, s) for s in seqs)
                    except Exception as exc:
                        try:
                            db.execute("ROLLBACK TO SAVEPOINT op")
                            db.execute("RELEASE SAVEPOINT op")
                        except Exception:  # pragma: no cover
                            pass
                        results.extend((None, None, exc, s) for s in seqs)
                pending_rows.clear()

            for fn, fut, guard, seq in batch:
                if type(fn) is tuple:
                    entry = pending_rows.get(fn[0])
                    if entry is None:
                        entry = pending_rows[fn[0]] = ([], [])
                    entry[0].append(fn[1])
                    entry[1].append(seq)
                    continue
                if pending_rows:
                    flush_rows()
                if guard:
                    try:
                        db.execute("SAVEPOINT op")
                        res = fn(db)
                        db.execute("RELEASE SAVEPOINT op")
                        results.append((fut, res, None, seq))
                    except Exception as exc:
                        try:
                            db.execute("ROLLBACK TO SAVEPOINT op")
                            db.execute("RELEASE SAVEPOINT op")
                        except Exception:  # pragma: no cover
                            pass
                        results.append((fut, None, exc, seq))
                else:
                    try:
                        results.append((fut, fn(db), None, seq))
                    except Exception as exc:
                        results.append((fut, None, exc, seq))
            if pending_rows:
                flush_rows()
            try:
                db.execute("COMMIT")
            except Exception as exc:  # pragma: no cover - disk failure
                try:
                    db.execute("ROLLBACK")
                except Exception:
                    pass
                results = [(f, None, exc, s) for f, _, _, s in results]
            loop.call_soon_threadsafe(self._batch_done, results)

        self._executor.submit(run_batch)

    _FAILED_CAP = 4096

    def _batch_done(
        self, results: list[tuple[asyncio.Future, Any, Optional[BaseException], int]]
    ) -> None:
        self._batch_in_flight = False
        for fut, res, exc, seq in results:
            if exc is not None:
                self._failed_seqs.append(seq)
                if len(self._failed_seqs) > self._FAILED_CAP:
                    # bound the list; barriers reaching below the floor
                    # report failure conservatively
                    self._failed_floor = max(
                        self._failed_floor, self._failed_seqs.pop(0))
            if fut is None:  # _submit_nowait op
                if exc is not None:
                    # count it, don't just log it: error_count feeds the
                    # telemetry store-error window and readiness reasons —
                    # a store silently failing fire-and-forget writes must
                    # flip /admin/health, not only a log line
                    self.error_count = getattr(self, "error_count", 0) + 1
                    log.error("background store write failed: %r", exc)
                continue
            if fut.cancelled():
                continue
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(res)
        # ops accumulated while the batch was committing -> next batch
        self._maybe_dispatch_batch()

    def mark(self) -> int:
        """Sequence number of the last op enqueued. Capture around a group
        of enqueues and pass the (before, after] interval to flush() for
        per-caller failure attribution."""
        return self._op_seq

    def _failures_in(self, intervals: list[tuple[int, int]]) -> bool:
        for s0, s1 in intervals:
            if s0 < self._failed_floor:
                return True
            for s in reversed(self._failed_seqs):
                if s0 < s <= s1:
                    return True
        return False

    def _unreported_failures(self, barrier_mark: int) -> bool:
        had = self._failures_in([(self._reported_mark, barrier_mark)])
        if barrier_mark > self._reported_mark:
            self._reported_mark = barrier_mark
        return had

    def flush(self, intervals: Optional[list[tuple[int, int]]] = None):
        """Durability barrier: awaitable resolving once every op enqueued so
        far has been committed.

        intervals=None (global barrier — shutdown, tests): raises if any
        write failed that no previous global barrier reported — a confirm
        released after this barrier must not paper over a failed persistent
        insert that was enqueued fire-and-forget, including one whose batch
        already completed while the event loop was busy elsewhere (the idle
        fast path checks too).

        intervals=[(mark_before, mark_after), ...] (attributed barrier —
        publisher confirms, cluster push replies): raises iff a failed op's
        seq falls inside one of the caller's own enqueue windows, so
        connection A's barrier can neither consume nor trip over
        connection B's failure. An empty list means the caller enqueued
        nothing it needs committed: resolves immediately, no barrier.

        Cheap when idle (already-resolved future)."""
        loop = self._loop or asyncio.get_running_loop()
        if intervals is not None and not intervals:
            fut: asyncio.Future = loop.create_future()
            fut.set_result(None)
            return fut
        barrier_mark = self._op_seq

        def covered_failure() -> bool:
            if intervals is not None:
                return self._failures_in(intervals)
            return self._unreported_failures(barrier_mark)

        if not self._pending and not self._batch_in_flight:
            fut = loop.create_future()
            if covered_failure():
                fut.set_exception(RuntimeError(
                    "store write failed before this durability barrier"))
            else:
                fut.set_result(None)
            return fut
        barrier = self._submit(lambda db: None, guard=False)

        async def wait() -> None:
            await barrier
            # FIFO resolution: every op enqueued before the barrier has been
            # resolved (and its failure recorded) by the time it resolves
            if covered_failure():
                raise RuntimeError(
                    "store write failed under this durability barrier")

        return wait()

    # -- lifecycle ---------------------------------------------------------

    async def open(self) -> None:
        self._loop = asyncio.get_running_loop()

        def _open() -> sqlite3.Connection:
            # isolation_level=None: WE manage transactions (BEGIN/COMMIT per
            # batch); the stdlib's implicit transactions would fight that.
            db = sqlite3.connect(
                self.path, check_same_thread=False, isolation_level=None)
            db.execute("PRAGMA journal_mode=WAL")
            db.execute(f"PRAGMA synchronous={self.synchronous}")
            db.execute("PRAGMA busy_timeout=10000")
            db.executescript(_SCHEMA)
            return db

        self._db = await self._loop.run_in_executor(self._executor, _open)
        # ops may have queued while opening
        self._maybe_dispatch_batch()

    async def close(self) -> None:
        if self._db is not None:
            try:
                await self.flush()
            except Exception:
                pass
            db = self._db
            self._db = None
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(self._executor, db.close)
        self._executor.shutdown(wait=False)

    async def approx_data_bytes(self) -> Optional[int]:
        """Live data pages × page size. page_count alone would be wrong for
        the gate: DELETEs never shrink the file (pages go to the freelist
        for reuse), so the gauge must subtract freelist pages or a drained
        store would stay 'full' forever and the gate would never reopen."""
        if self._db is None:
            return None

        def q(db: sqlite3.Connection) -> int:
            page_size = db.execute("PRAGMA page_size").fetchone()[0]
            page_count = db.execute("PRAGMA page_count").fetchone()[0]
            freelist = db.execute("PRAGMA freelist_count").fetchone()[0]
            return (page_count - freelist) * page_size

        return await self._submit(q)

    # -- messages ---------------------------------------------------------

    _SQL_INSERT_MSG = "INSERT OR REPLACE INTO msgs VALUES (?,?,?,?,?,?,?)"

    @staticmethod
    def _msg_row(msg: StoredMessage) -> tuple:
        return (msg.id, msg.properties_raw, msg.body, msg.exchange,
                msg.routing_key, msg.refer_count, msg.ttl_ms)

    def insert_message(self, msg: StoredMessage):
        row = self._msg_row(msg)
        return self._submit(
            lambda db: db.execute(self._SQL_INSERT_MSG, row), guard=False)

    def insert_message_nowait(self, msg: StoredMessage) -> None:
        self._submit_row(self._SQL_INSERT_MSG, self._msg_row(msg))

    @staticmethod
    def _row_to_message(row) -> StoredMessage:
        return StoredMessage(
            id=row[0], properties_raw=row[1], body=row[2], exchange=row[3],
            routing_key=row[4], refer_count=row[5], ttl_ms=row[6],
        )

    # stay under SQLITE_MAX_VARIABLE_NUMBER for giant recovery batches
    _IN_CHUNK = 900

    async def select_message(self, msg_id: int) -> Optional[StoredMessage]:
        row = await self._submit(lambda db: db.execute(
            "SELECT * FROM msgs WHERE id=?", (msg_id,)).fetchone(), guard=False)
        return self._row_to_message(row) if row is not None else None

    async def _select_in(self, columns: str, msg_ids: list[int]) -> list:
        rows: list = []
        for start in range(0, len(msg_ids), self._IN_CHUNK):
            chunk = msg_ids[start:start + self._IN_CHUNK]
            qmarks = ",".join("?" * len(chunk))
            rows += await self._submit(lambda db, c=chunk, q=qmarks: db.execute(
                f"SELECT {columns} FROM msgs WHERE id IN ({q})", c).fetchall(),
                guard=False)
        return rows

    async def select_messages(self, msg_ids: list[int]) -> dict[int, StoredMessage]:
        if not msg_ids:
            return {}
        rows = await self._select_in("*", msg_ids)
        return {row[0]: self._row_to_message(row) for row in rows}

    async def select_message_metas(self, msg_ids: list[int]) -> dict[int, StoredMessage]:
        if not msg_ids:
            return {}
        rows = await self._select_in(
            "id, header, NULL, exchange, routing_key, refer_count, ttl_ms",
            msg_ids)
        return {row[0]: self._row_to_message(row) for row in rows}

    def delete_message(self, msg_id: int):
        return self._submit(lambda db: db.execute(
            "DELETE FROM msgs WHERE id=?", (msg_id,)), guard=False)

    def delete_messages(self, msg_ids: list[int]):
        return self._submit(lambda db: db.executemany(
            "DELETE FROM msgs WHERE id=?", [(m,) for m in msg_ids]),
            guard=False)

    def update_message_refer_count(self, msg_id: int, count: int):
        return self._submit(lambda db: db.execute(
            "UPDATE msgs SET refer_count=? WHERE id=?", (count, msg_id)), guard=False)

    # -- queue meta -------------------------------------------------------

    def insert_queue_meta(self, q: StoredQueue):
        return self._submit(lambda db: db.execute(
            "INSERT OR REPLACE INTO queue_metas VALUES (?,?,?,?,?,?,?,?)",
            (q.vhost, q.name, int(q.durable), int(q.exclusive),
             int(q.auto_delete), q.ttl_ms, q.last_consumed,
             json.dumps(q.arguments)),
        ), guard=False)

    async def select_queue(self, vhost: str, name: str) -> Optional[StoredQueue]:
        def q(db: sqlite3.Connection):
            meta = db.execute(
                "SELECT * FROM queue_metas WHERE vhost=? AND name=?",
                (vhost, name)).fetchone()
            if meta is None:
                return None
            msgs = db.execute(
                "SELECT offset, msg_id, body_size, expire_at_ms FROM queue_msgs "
                "WHERE vhost=? AND queue=? AND offset>? ORDER BY offset",
                (vhost, name, meta[6])).fetchall()
            unacks = db.execute(
                "SELECT msg_id, offset, body_size, expire_at_ms FROM queue_unacks "
                "WHERE vhost=? AND queue=?", (vhost, name)).fetchall()
            return meta, msgs, unacks

        out = await self._submit(q)
        if out is None:
            return None
        meta, msgs, unacks = out
        return StoredQueue(
            vhost=meta[0], name=meta[1], durable=bool(meta[2]),
            exclusive=bool(meta[3]), auto_delete=bool(meta[4]), ttl_ms=meta[5],
            last_consumed=meta[6], arguments=json.loads(meta[7] or "{}"),
            msgs=[tuple(m) for m in msgs],
            unacks={u[0]: (u[1], u[2], u[3]) for u in unacks},
        )

    async def all_queues(self, vhost: Optional[str] = None) -> list[StoredQueue]:
        def q(db: sqlite3.Connection):
            if vhost is None:
                return db.execute("SELECT vhost, name FROM queue_metas").fetchall()
            return db.execute(
                "SELECT vhost, name FROM queue_metas WHERE vhost=?", (vhost,)
            ).fetchall()

        names = await self._submit(q)
        out = []
        for vh, name in names:
            if is_replica_vhost(vh):
                continue  # passive replica copies never recover as live
            sq = await self.select_queue(vh, name)
            if sq:
                out.append(sq)
        return out

    # -- queue log --------------------------------------------------------

    _SQL_INSERT_QUEUE_MSG = (
        "INSERT OR REPLACE INTO queue_msgs VALUES (?,?,?,?,?,?)")

    def insert_queue_msg(self, vhost, queue, offset, msg_id, body_size, expire_at_ms):
        row = (vhost, queue, offset, msg_id, body_size, expire_at_ms)
        return self._submit(
            lambda db: db.execute(self._SQL_INSERT_QUEUE_MSG, row), guard=False)

    def insert_queue_msg_nowait(
            self, vhost, queue, offset, msg_id, body_size, expire_at_ms) -> None:
        self._submit_row(
            self._SQL_INSERT_QUEUE_MSG,
            (vhost, queue, offset, msg_id, body_size, expire_at_ms))

    def delete_queue_msg(self, vhost, queue, offset):
        return self._submit(lambda db: db.execute(
            "DELETE FROM queue_msgs WHERE vhost=? AND queue=? AND offset=?",
            (vhost, queue, offset)), guard=False)

    async def iter_queue_msgs(self, vhost, queue, after_offset, limit):
        rows = await self._submit(lambda db: db.execute(
            "SELECT offset, msg_id, body_size, expire_at_ms FROM queue_msgs "
            "WHERE vhost=? AND queue=? AND offset>? ORDER BY offset LIMIT ?",
            (vhost, queue, after_offset, limit)).fetchall())
        return [tuple(r) for r in rows]

    def replace_queue_msgs(self, vhost, queue, msgs):
        def w(db: sqlite3.Connection):
            db.execute(
                "DELETE FROM queue_msgs WHERE vhost=? AND queue=?",
                (vhost, queue))
            db.executemany(
                self._SQL_INSERT_QUEUE_MSG,
                [(vhost, queue, o, m, s, e) for (o, m, s, e) in msgs])

        return self._submit(w)

    def replace_queue_unacks(self, vhost, queue, unacks):
        def w(db: sqlite3.Connection):
            db.execute(
                "DELETE FROM queue_unacks WHERE vhost=? AND queue=?",
                (vhost, queue))
            db.executemany(
                "INSERT OR REPLACE INTO queue_unacks VALUES (?,?,?,?,?,?)",
                [(vhost, queue, m, o, s, e) for (m, o, s, e) in unacks])

        return self._submit(w)

    # -- watermark + unacks ------------------------------------------------

    def update_queue_last_consumed(self, vhost, queue, last_consumed):
        def w(db: sqlite3.Connection):
            db.execute(
                "UPDATE queue_metas SET last_consumed=? WHERE vhost=? AND name=?",
                (last_consumed, vhost, queue))
            db.execute(
                "DELETE FROM queue_msgs WHERE vhost=? AND queue=? AND offset<=?",
                (vhost, queue, last_consumed))

        return self._submit(w)

    @staticmethod
    def _insert_queue_unacks_op(vhost, queue, unacks):
        return lambda db: db.executemany(
            "INSERT OR REPLACE INTO queue_unacks VALUES (?,?,?,?,?,?)",
            [(vhost, queue, m, o, s, e) for (m, o, s, e) in unacks])

    def insert_queue_unacks(self, vhost, queue, unacks):
        return self._submit(
            self._insert_queue_unacks_op(vhost, queue, unacks), guard=False)

    def insert_queue_unacks_nowait(self, vhost, queue, unacks) -> None:
        self._submit_nowait(self._insert_queue_unacks_op(vhost, queue, unacks))

    def delete_queue_msgs_offsets(self, vhost, queue, offsets):
        return self._submit(lambda db: db.executemany(
            "DELETE FROM queue_msgs WHERE vhost=? AND queue=? AND offset=?",
            [(vhost, queue, o) for o in offsets]), guard=False)

    def delete_queue_unacks(self, vhost, queue, msg_ids):
        return self._submit(lambda db: db.executemany(
            "DELETE FROM queue_unacks WHERE vhost=? AND queue=? AND msg_id=?",
            [(vhost, queue, m) for m in msg_ids]), guard=False)

    # -- delete/archive ----------------------------------------------------

    def archive_queue(self, vhost, queue):
        def w(db: sqlite3.Connection):
            meta = db.execute(
                "SELECT * FROM queue_metas WHERE vhost=? AND name=?",
                (vhost, queue)).fetchone()
            if meta:
                db.execute(
                    "INSERT OR REPLACE INTO queue_metas_deleted VALUES (?,?,?)",
                    (vhost, queue, json.dumps(list(meta))))
            db.execute(
                "INSERT OR REPLACE INTO queue_msgs_deleted "
                "SELECT * FROM queue_msgs WHERE vhost=? AND queue=?",
                (vhost, queue))
            db.execute(
                "INSERT OR REPLACE INTO queue_unacks_deleted "
                "SELECT * FROM queue_unacks WHERE vhost=? AND queue=?",
                (vhost, queue))

        return self._submit(w)

    def delete_queue(self, vhost, queue):
        def w(db: sqlite3.Connection):
            db.execute("DELETE FROM queue_metas WHERE vhost=? AND name=?", (vhost, queue))
            db.execute("DELETE FROM queue_msgs WHERE vhost=? AND queue=?", (vhost, queue))
            db.execute("DELETE FROM queue_unacks WHERE vhost=? AND queue=?", (vhost, queue))

        return self._submit(w)

    def purge_queue_msgs(self, vhost, queue):
        return self._submit(lambda db: db.execute(
            "DELETE FROM queue_msgs WHERE vhost=? AND queue=?", (vhost, queue)), guard=False)

    # -- stream segments + cursors -----------------------------------------

    def insert_stream_segment(self, vhost, queue, base_offset, last_offset,
                              first_ts_ms, last_ts_ms, size_bytes, blob):
        row = (vhost, queue, base_offset, last_offset, first_ts_ms,
               last_ts_ms, size_bytes, blob)
        return self._submit(lambda db: db.execute(
            "INSERT OR REPLACE INTO stream_segments VALUES (?,?,?,?,?,?,?,?)",
            row), guard=False)

    async def select_stream_segment(self, vhost, queue, base_offset):
        row = await self._submit(lambda db: db.execute(
            "SELECT blob FROM stream_segments "
            "WHERE vhost=? AND queue=? AND base_offset=?",
            (vhost, queue, base_offset)).fetchone(), guard=False)
        return row[0] if row is not None else None

    async def stream_segment_metas(self, vhost, queue):
        rows = await self._submit(lambda db: db.execute(
            "SELECT base_offset, last_offset, first_ts_ms, last_ts_ms, "
            "size_bytes FROM stream_segments WHERE vhost=? AND queue=? "
            "ORDER BY base_offset", (vhost, queue)).fetchall(), guard=False)
        return [tuple(r) for r in rows]

    def delete_stream_segments(self, vhost, queue, base_offsets):
        return self._submit(lambda db: db.executemany(
            "DELETE FROM stream_segments "
            "WHERE vhost=? AND queue=? AND base_offset=?",
            [(vhost, queue, b) for b in base_offsets]), guard=False)

    def update_stream_cursor(self, vhost, queue, name, committed_offset):
        return self._submit(lambda db: db.execute(
            "INSERT OR REPLACE INTO stream_cursors VALUES (?,?,?,?)",
            (vhost, queue, name, committed_offset)), guard=False)

    async def select_stream_cursors(self, vhost, queue):
        rows = await self._submit(lambda db: db.execute(
            "SELECT name, committed_offset FROM stream_cursors "
            "WHERE vhost=? AND queue=?", (vhost, queue)).fetchall(),
            guard=False)
        return {r[0]: r[1] for r in rows}

    def delete_stream_data(self, vhost, queue):
        def w(db: sqlite3.Connection):
            db.execute("DELETE FROM stream_segments WHERE vhost=? AND queue=?",
                       (vhost, queue))
            db.execute("DELETE FROM stream_cursors WHERE vhost=? AND queue=?",
                       (vhost, queue))

        return self._submit(w)

    # -- exchanges + binds -------------------------------------------------

    def insert_exchange(self, ex: StoredExchange):
        return self._submit(lambda db: db.execute(
            "INSERT OR REPLACE INTO exchanges VALUES (?,?,?,?,?,?,?)",
            (ex.vhost, ex.name, ex.type, int(ex.durable), int(ex.auto_delete),
             int(ex.internal), json.dumps(ex.arguments)),
        ), guard=False)

    async def select_exchange(self, vhost, name) -> Optional[StoredExchange]:
        def q(db: sqlite3.Connection):
            row = db.execute(
                "SELECT * FROM exchanges WHERE vhost=? AND name=?",
                (vhost, name)).fetchone()
            if row is None:
                return None
            binds = db.execute(
                "SELECT routing_key, queue, arguments FROM binds "
                "WHERE vhost=? AND exchange=?", (vhost, name)).fetchall()
            ex_binds = db.execute(
                "SELECT routing_key, destination, arguments FROM exchange_binds "
                "WHERE vhost=? AND exchange=?", (vhost, name)).fetchall()
            return row, binds, ex_binds

        out = await self._submit(q)
        if out is None:
            return None
        row, binds, ex_binds = out
        return StoredExchange(
            vhost=row[0], name=row[1], type=row[2], durable=bool(row[3]),
            auto_delete=bool(row[4]), internal=bool(row[5]),
            arguments=json.loads(row[6] or "{}"),
            binds=[(b[0], b[1], json.loads(b[2]) if b[2] else None) for b in binds],
            ex_binds=[(b[0], b[1], json.loads(b[2]) if b[2] else None)
                      for b in ex_binds],
        )

    async def all_exchanges(self, vhost: Optional[str] = None) -> list[StoredExchange]:
        def q(db: sqlite3.Connection):
            if vhost is None:
                return db.execute("SELECT vhost, name FROM exchanges").fetchall()
            return db.execute(
                "SELECT vhost, name FROM exchanges WHERE vhost=?", (vhost,)
            ).fetchall()

        names = await self._submit(q)
        out = []
        for vh, name in names:
            ex = await self.select_exchange(vh, name)
            if ex:
                out.append(ex)
        return out

    def delete_exchange(self, vhost, name):
        def w(db: sqlite3.Connection):
            db.execute("DELETE FROM exchanges WHERE vhost=? AND name=?", (vhost, name))
            db.execute("DELETE FROM binds WHERE vhost=? AND exchange=?", (vhost, name))
            db.execute("DELETE FROM exchange_binds WHERE vhost=? AND exchange=?",
                       (vhost, name))

        return self._submit(w)

    def insert_exchange_bind(self, vhost, source, destination, routing_key, arguments):
        return self._submit(lambda db: db.execute(
            "INSERT OR REPLACE INTO exchange_binds VALUES (?,?,?,?,?)",
            (vhost, source, destination, routing_key,
             json.dumps(arguments) if arguments else None),
        ), guard=False)

    def delete_exchange_bind(self, vhost, source, destination, routing_key):
        return self._submit(lambda db: db.execute(
            "DELETE FROM exchange_binds "
            "WHERE vhost=? AND exchange=? AND destination=? AND routing_key=?",
            (vhost, source, destination, routing_key)), guard=False)

    def delete_exchange_binds_dest(self, vhost, destination):
        return self._submit(lambda db: db.execute(
            "DELETE FROM exchange_binds WHERE vhost=? AND destination=?",
            (vhost, destination)), guard=False)

    def insert_bind(self, vhost, exchange, queue, routing_key, arguments):
        return self._submit(lambda db: db.execute(
            "INSERT OR REPLACE INTO binds VALUES (?,?,?,?,?)",
            (vhost, exchange, queue, routing_key,
             json.dumps(arguments) if arguments else None),
        ), guard=False)

    def delete_bind(self, vhost, exchange, queue, routing_key):
        return self._submit(lambda db: db.execute(
            "DELETE FROM binds WHERE vhost=? AND exchange=? AND queue=? AND routing_key=?",
            (vhost, exchange, queue, routing_key)), guard=False)

    def delete_queue_binds(self, vhost, queue):
        return self._submit(lambda db: db.execute(
            "DELETE FROM binds WHERE vhost=? AND queue=?", (vhost, queue)), guard=False)

    # -- WAL engine support (chanamq_tpu/wal/) -----------------------------
    # The write-ahead wrapper keeps its checkpoint watermark in cluster_kv,
    # needs a real fsync of the database at checkpoint time, and runs
    # stream-segment maintenance (key compaction + tier offload) through
    # blob-level helpers that the plain store API doesn't expose.

    async def get_kv(self, key: str) -> Optional[int]:
        def q(db: sqlite3.Connection) -> Optional[int]:
            row = db.execute(
                "SELECT value FROM cluster_kv WHERE key=?", (key,)).fetchone()
            return int(row[0]) if row is not None else None

        return await self._submit(q, guard=False)

    def put_kv(self, key: str, value: int):
        return self._submit(lambda db: db.execute(
            "INSERT OR REPLACE INTO cluster_kv VALUES (?,?)",
            (key, value)), guard=False)

    def worker_id_floor(self, n: int):
        """Replay-only: next_worker_id = max(current, n). WAL recovery uses
        it so an id allocated just before a crash is never re-issued."""
        def w(db: sqlite3.Connection) -> None:
            db.execute(
                "INSERT OR IGNORE INTO cluster_kv VALUES ('next_worker_id', 0)")
            db.execute(
                "UPDATE cluster_kv SET value=? "
                "WHERE key='next_worker_id' AND value<?", (n, n))

        return self._submit(w)

    async def checkpoint_sync(self) -> None:
        """fsync the database file. Under synchronous=NORMAL, SQLite only
        fsyncs at WAL checkpoints — the wrapper calls this before
        truncating its own segments, so a power cut can't eat index state
        the WAL no longer covers. A checkpoint cannot run inside a
        transaction, so this rides the writer executor directly (the
        single-threaded executor serializes it between group commits)."""
        db = self._db
        if db is None:
            return
        loop = self._loop or asyncio.get_running_loop()
        await loop.run_in_executor(
            self._executor,
            lambda: db.execute("PRAGMA wal_checkpoint(TRUNCATE)").fetchone())

    async def stream_segment_index(self) -> list:
        """Whole-store segment index for maintenance sweeps:
        (vhost, queue, base_offset, size_bytes, has_blob) rows."""
        rows = await self._submit(lambda db: db.execute(
            "SELECT vhost, queue, base_offset, size_bytes, "
            "blob IS NOT NULL FROM stream_segments "
            "ORDER BY vhost, queue, base_offset").fetchall(), guard=False)
        return [tuple(r) for r in rows]

    def evict_stream_blob(self, vhost, queue, base_offset):
        """Tier offload: drop the blob bytes, keep the index row."""
        return self._submit(lambda db: db.execute(
            "UPDATE stream_segments SET blob=NULL "
            "WHERE vhost=? AND queue=? AND base_offset=?",
            (vhost, queue, base_offset)), guard=False)

    def replace_stream_segment_blob(self, vhost, queue, base_offset,
                                    blob, size_bytes):
        """Key compaction: swap a sealed segment's bytes in place (offsets
        inside the blob are preserved; last_offset stays)."""
        return self._submit(lambda db: db.execute(
            "UPDATE stream_segments SET blob=?, size_bytes=? "
            "WHERE vhost=? AND queue=? AND base_offset=?",
            (blob, size_bytes, vhost, queue, base_offset)), guard=False)

    async def queue_arguments(self, vhost, name) -> Optional[dict]:
        row = await self._submit(lambda db: db.execute(
            "SELECT arguments FROM queue_metas WHERE vhost=? AND name=?",
            (vhost, name)).fetchone(), guard=False)
        if row is None:
            return None
        return json.loads(row[0] or "{}")

    def allocate_worker_id(self):
        # runs inside the batch's BEGIN IMMEDIATE transaction, so the
        # read-modify-write is atomic across processes sharing the file
        def w(db: sqlite3.Connection) -> int:
            db.execute(
                "INSERT OR IGNORE INTO cluster_kv VALUES ('next_worker_id', 0)")
            db.execute(
                "UPDATE cluster_kv SET value = value + 1 "
                "WHERE key = 'next_worker_id'")
            row = db.execute(
                "SELECT value FROM cluster_kv WHERE key = 'next_worker_id'"
            ).fetchone()
            return int(row[0])

        return self._submit(w)

    # -- vhosts ------------------------------------------------------------

    def insert_vhost(self, name: str, active: bool = True):
        return self._submit(lambda db: db.execute(
            "INSERT OR REPLACE INTO vhosts VALUES (?,?)", (name, int(active))), guard=False)

    async def all_vhosts(self) -> list[tuple[str, bool]]:
        rows = await self._submit(
            lambda db: db.execute("SELECT name, active FROM vhosts").fetchall(),
            guard=False)
        return [(r[0], bool(r[1])) for r in rows]

    def delete_vhost(self, name: str):
        return self._submit(lambda db: db.execute(
            "DELETE FROM vhosts WHERE name=?", (name,)), guard=False)
