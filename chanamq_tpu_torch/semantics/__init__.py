"""Advanced delivery semantics (EXCEEDS the reference, which implements
none of these: no Tx class handling beyond stubs, no Exchange.Bind, no
dead-lettering, FIFO-only queues — FrameStage.scala:1023-1027, SURVEY.md).

This package holds the data structures behind that feature set; the
broker/channel wiring lives at the existing call sites so the disabled
path stays a pointer check:

- ``PriorityFan`` (priority.py): the ready-list for x-max-priority
  queues — a per-priority fan of deques replacing the single deque, so
  enqueue and dispatch are O(1) instead of an ordered insert scan.
- ``TimerWheel`` / ``DelayService`` (delay.py): x-delay delayed
  delivery — publishes park in a hashed timer wheel and re-enter the
  normal publish path when their delay elapses.
- ``would_create_cycle`` (graph.py): bind-time cycle refusal for
  exchange-to-exchange binding graphs (406 PRECONDITION_FAILED), so the
  compiled router only ever sees a DAG.

Transactions (Tx.Select/Commit/Rollback) ride the WAL scope primitives
(wal/engine.py tx_begin/tx_seal) from AMQPConnection._tx_commit: every
store mutation a commit stages lands in ONE ``tx_batch`` record, which
is what makes a SIGKILL mid-commit all-or-nothing on replay.

Master switch: ``chana.mq.semantics.enabled`` (CHANAMQ_SEMANTICS_ENABLED).
Off removes the per-publish x-delay probe and the bind-time cycle
refusal (the runtime visited-set walk still terminates cycles); priority
ordering and dead-lettering are queue-argument driven and stay on.
"""

from .delay import DelayService, TimerWheel, parse_delay
from .graph import e2e_destinations, would_create_cycle
from .priority import PriorityFan

__all__ = [
    "DelayService",
    "PriorityFan",
    "TimerWheel",
    "e2e_destinations",
    "parse_delay",
    "would_create_cycle",
]
