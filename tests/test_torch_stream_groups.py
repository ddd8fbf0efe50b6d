"""Shared / key-shared consumer groups on stream queues (streams/groups.py).

Covers the x-group consume contract: one shared committed cursor per
group, record spread across members (round-robin for shared, consistent-
hash + sticky keys for key-shared), per-key ordering through member
disconnects, resume-from-committed across full member churn, and the
consume-time argument validation.

The port's copy of ``tests/test_stream_groups.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU; the
assertions are the reference's.
"""

import asyncio

import pytest

from chanamq_tpu_torch.broker.server import BrokerServer
from chanamq_tpu_torch.client import AMQPClient
from chanamq_tpu_torch.client.client import ChannelClosedError
from chanamq_tpu_torch.streams.groups import GROUP_CURSOR_PREFIX
from chanamq_tpu_torch.broker.broker import Broker

pytestmark = pytest.mark.asyncio

STREAM = {"x-queue-type": "stream"}


async def start_server():
    srv = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                       port=0, heartbeat_s=0)
    await srv.start()
    return srv


def _grp_args(name, mode=None, offset="first"):
    args = {"x-group": name, "x-stream-offset": offset}
    if mode is not None:
        args["x-group-type"] = mode
    return args


async def test_shared_group_partitions_stream():
    """Two members of one shared group split the log: every record is
    delivered exactly once across the group, and the group cursor commits
    to the tail once everything is acked."""
    srv = await start_server()
    try:
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await c.channel()
        await ch.queue_declare("sg1", durable=True, arguments=STREAM)
        await ch.basic_qos(prefetch_count=4)

        got_a, got_b = [], []
        done = asyncio.get_event_loop().create_future()

        def on_msg(bucket):
            def cb(msg):
                bucket.append(int(msg.body))
                ch.basic_ack(msg.delivery_tag)
                if (len(got_a) + len(got_b)) >= 40 and not done.done():
                    done.set_result(None)
            return cb

        await ch.basic_consume("sg1", on_msg(got_a), consumer_tag="m-a",
                               arguments=_grp_args("g"))
        await ch.basic_consume("sg1", on_msg(got_b), consumer_tag="m-b",
                               arguments=_grp_args("g"))
        for i in range(40):
            ch.basic_publish(str(i).encode(), routing_key="sg1")
        await asyncio.wait_for(done, 5)
        await asyncio.sleep(0.05)  # let the trailing acks land
        assert sorted(got_a + got_b) == list(range(40))
        assert got_a and got_b  # round-robin used both members
        sq = srv.broker.vhosts["/"].queues["sg1"]
        # committed floor reaches the last record (offsets are 1-based)
        assert sq.committed[GROUP_CURSOR_PREFIX + "g"] == sq.next_offset - 1
        assert srv.broker.metrics.stream_groups_created == 1
        assert srv.broker.metrics.stream_group_deliveries == 40
        await c.close()
    finally:
        await srv.stop()


async def test_group_resumes_from_committed_after_full_churn():
    srv = await start_server()
    try:
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await c.channel()
        await ch.queue_declare("sg2", durable=True, arguments=STREAM)
        for i in range(10):
            ch.basic_publish(str(i).encode(), routing_key="sg2")
        await asyncio.sleep(0.05)

        async def drain(n):
            got = []
            done = asyncio.get_event_loop().create_future()

            def cb(msg):
                got.append(int(msg.body))
                ch.basic_ack(msg.delivery_tag)
                if len(got) >= n and not done.done():
                    done.set_result(None)

            tag = await ch.basic_consume("sg2", cb,
                                         arguments=_grp_args("g2"))
            await asyncio.wait_for(done, 5)
            await asyncio.sleep(0.05)
            await ch.basic_cancel(tag)
            return got

        assert await drain(10) == list(range(10))
        # group now memberless; its committed offset survives
        for i in range(10, 15):
            ch.basic_publish(str(i).encode(), routing_key="sg2")
        await asyncio.sleep(0.05)
        # the rejoining member asks for "first" but the committed group
        # cursor wins: only the unconsumed suffix arrives
        assert await drain(5) == list(range(10, 15))
        await c.close()
    finally:
        await srv.stop()


async def test_key_shared_keys_stick_to_one_member():
    """Without churn, each routing key lands on exactly one member, and
    each member sees its keys' sequences in publish order."""
    srv = await start_server()
    try:
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await c.channel()
        await ch.queue_declare("sg3", durable=True, arguments=STREAM)
        # fanout exchange so the partition key (routing key) can vary per
        # record while everything still lands in the stream
        await ch.exchange_declare("sg3x", "fanout")
        await ch.queue_bind("sg3", "sg3x", "")
        keys = [f"k{i}" for i in range(8)]
        total = 20 * len(keys)

        seen = {}  # member -> [(key, seq)]
        done = asyncio.get_event_loop().create_future()

        def on_msg(member):
            def cb(msg):
                seen.setdefault(member, []).append(
                    (msg.routing_key, int(msg.body)))
                ch.basic_ack(msg.delivery_tag)
                if sum(len(v) for v in seen.values()) >= total \
                        and not done.done():
                    done.set_result(None)
            return cb

        for member in ("a", "b", "c"):
            await ch.basic_consume(
                "sg3", on_msg(member), consumer_tag=f"m-{member}",
                arguments=_grp_args("g3", "key-shared"))
        for seq in range(20):
            for key in keys:
                ch.basic_publish(str(seq).encode(), exchange="sg3x",
                                 routing_key=key)
        await asyncio.wait_for(done, 5)
        owners = {}
        for member, msgs in seen.items():
            per_key = {}
            for key, seq in msgs:
                owners.setdefault(key, set()).add(member)
                per_key.setdefault(key, []).append(seq)
            for key, seqs in per_key.items():
                assert seqs == sorted(seqs), (member, key, seqs)
        assert all(len(m) == 1 for m in owners.values()), owners
        assert len(seen) > 1  # the ring actually spread the keyspace
        await c.close()
    finally:
        await srv.stop()


async def test_key_shared_disconnect_redelivers_in_key_order():
    """A member dropping mid-flight with unacked deliveries: its records
    redeliver to the survivor BEFORE any later record of the same keys
    (head-of-line + redelivery heap), so per-key ack order stays strictly
    increasing — the chaos-soak invariant, asserted deterministically."""
    srv = await start_server()
    try:
        pub = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        pch = await pub.channel()
        await pch.queue_declare("sg4", durable=True, arguments=STREAM)
        await pch.exchange_declare("sg4x", "fanout")
        await pch.queue_bind("sg4", "sg4x", "")
        keys = [f"k{i}" for i in range(4)]
        total = 10 * len(keys)

        # victim: takes deliveries but never acks, then the connection dies
        victim = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        vch = await victim.channel()
        await vch.basic_qos(prefetch_count=6)
        victim_got = []
        vch_ready = asyncio.get_event_loop().create_future()

        def victim_cb(msg):
            victim_got.append(msg.routing_key)
            if len(victim_got) >= 6 and not vch_ready.done():
                vch_ready.set_result(None)

        await vch.basic_consume("sg4", victim_cb, consumer_tag="victim",
                                arguments=_grp_args("g4", "key-shared"))
        for seq in range(10):
            for key in keys:
                pch.basic_publish(str(seq).encode(), exchange="sg4x",
                                  routing_key=key)
        await asyncio.wait_for(vch_ready, 5)
        assert victim_got  # it really held deliveries hostage

        survivor = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        sch = await survivor.channel()
        acked = []  # (key, seq) in ack order
        done = asyncio.get_event_loop().create_future()

        def survivor_cb(msg):
            acked.append((msg.routing_key, int(msg.body)))
            sch.basic_ack(msg.delivery_tag)
            if len(acked) >= total and not done.done():
                done.set_result(None)

        await sch.basic_consume("sg4", survivor_cb, consumer_tag="survivor",
                                arguments=_grp_args("g4", "key-shared"))
        # every key is stuck to the victim, so the survivor gets nothing
        # until the disconnect unsticks them via requeue
        await asyncio.sleep(0.1)
        assert not acked
        await victim.close()  # release_all requeues its in-flight

        await asyncio.wait_for(done, 5)
        await asyncio.sleep(0.05)
        per_key = {}
        for key, seq in acked:
            per_key.setdefault(key, []).append(seq)
        for key, seqs in per_key.items():
            # strictly increasing: redelivered records arrived (and were
            # acked) before any later record of the same key
            assert seqs == sorted(seqs) == sorted(set(seqs)), (key, seqs)
        assert sorted(n for s in per_key.values() for n in s) \
            == sorted(list(range(10)) * len(keys))
        sq = srv.broker.vhosts["/"].queues["sg4"]
        assert sq.committed[GROUP_CURSOR_PREFIX + "g4"] == sq.next_offset - 1
        await survivor.close()
        await pub.close()
    finally:
        await srv.stop()


async def test_group_argument_validation():
    srv = await start_server()
    try:
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await c.channel()
        await ch.queue_declare("sg5", durable=True, arguments=STREAM)
        await ch.queue_declare("classic-q")
        await ch.basic_consume("sg5", lambda m: None, consumer_tag="ok",
                               arguments=_grp_args("g5", "shared"))
        # mode conflict with the existing group
        with pytest.raises(ChannelClosedError):
            ch2 = await c.channel()
            await ch2.basic_consume(
                "sg5", lambda m: None,
                arguments=_grp_args("g5", "key-shared"))
        # unknown mode
        with pytest.raises(ChannelClosedError):
            ch3 = await c.channel()
            await ch3.basic_consume(
                "sg5", lambda m: None, arguments=_grp_args("x", "bogus"))
        # x-group on a classic queue
        with pytest.raises(ChannelClosedError):
            ch4 = await c.channel()
            await ch4.basic_consume(
                "classic-q", lambda m: None, arguments={"x-group": "g"})
        # x-group-type without x-group
        with pytest.raises(ChannelClosedError):
            ch5 = await c.channel()
            await ch5.basic_consume(
                "sg5", lambda m: None,
                arguments={"x-group-type": "shared"})
        await c.close()
    finally:
        await srv.stop()
