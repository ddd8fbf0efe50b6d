"""Mixed-feature interaction soak: tx batches + e2e exchange graph + DLX +
length caps + manual-ack rejects + binding churn, all on one broker, with a
message-conservation assertion at the end. Catches interactions the
per-feature suites can't (e.g. a tx commit racing a maxlen drop racing a
dead-letter republish).

The port's copy of ``tests/test_soak_features.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU; the assertions
are the reference's.
"""

import asyncio

import pytest

from chanamq_tpu_torch.broker.broker import Broker
from chanamq_tpu_torch.broker.server import BrokerServer
from chanamq_tpu_torch.client import AMQPClient

pytestmark = pytest.mark.asyncio

BATCH = 50
BATCHES = 40  # 2000 publishes, every 5th batch rolled back


async def test_mixed_feature_soak():
    srv = BrokerServer(broker=Broker(router_device="cpu"),
                       host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    setup = await c.channel()
    # topology: topic source --e2e--> fanout mirror; main queue capped with
    # DLX; dead queue collects rejects and overflow victims
    await setup.exchange_declare("soak_src", "topic")
    await setup.exchange_declare("soak_fan", "fanout")
    await setup.exchange_declare("soak_dlx", "fanout")
    await setup.exchange_bind("soak_fan", "soak_src", "job.#")
    await setup.queue_declare("q_dead")
    await setup.queue_bind("q_dead", "soak_dlx", "")
    await setup.queue_declare("q_main", arguments={
        "x-max-length": 500, "x-dead-letter-exchange": "soak_dlx"})
    await setup.queue_bind("q_main", "soak_src", "job.*")
    await setup.queue_declare("q_mirror")
    await setup.queue_bind("q_mirror", "soak_fan", "")

    acked = 0
    rejected = 0
    mirror_seen = 0
    committed = 0
    producer_done = asyncio.Event()

    async def producer():
        nonlocal committed
        pc = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await pc.channel()
        await ch.tx_select()
        for b in range(BATCHES):
            for i in range(BATCH):
                ch.basic_publish(b"payload-%02d-%02d" % (b, i),
                                 exchange="soak_src",
                                 routing_key=f"job.k{i % 5}")
            if b % 5 == 4:
                await ch.tx_rollback()
            else:
                await ch.tx_commit()
                committed += BATCH
            await asyncio.sleep(0)
        await pc.close()
        producer_done.set()

    async def settle(progress, deadline_s=8.0, quiet_ticks=3):
        """Wait for the producer, then until `progress()` stops moving."""
        await producer_done.wait()
        deadline = asyncio.get_event_loop().time() + deadline_s
        last, quiet = progress(), 0
        while (quiet < quiet_ticks
               and asyncio.get_event_loop().time() < deadline):
            await asyncio.sleep(0.15)
            cur = progress()
            quiet = quiet + 1 if cur == last else 0
            last = cur

    async def main_consumer():
        nonlocal acked, rejected
        cc = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await cc.channel()
        await ch.basic_qos(prefetch_count=64)
        n = 0

        def on_msg(msg):
            nonlocal acked, rejected, n
            n += 1
            if n % 7 == 0:
                ch.basic_reject(msg.delivery_tag, requeue=False)  # -> DLX
                rejected += 1
            else:
                ch.basic_ack(msg.delivery_tag)
                acked += 1

        await ch.basic_consume("q_main", on_msg)
        await settle(lambda: n)
        await cc.close()

    async def mirror_consumer():
        nonlocal mirror_seen
        cc = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await cc.channel()

        def on_msg(msg):
            nonlocal mirror_seen
            mirror_seen += 1

        await ch.basic_consume("q_mirror", on_msg, no_ack=True)
        await settle(lambda: mirror_seen)
        await cc.close()

    async def churn():
        ch = await c.channel()
        for _ in range(6):
            await asyncio.sleep(0.2)
            await ch.queue_unbind("q_mirror", "soak_fan", "")
            await asyncio.sleep(0.05)
            await ch.queue_bind("q_mirror", "soak_fan", "")

    await asyncio.gather(producer(), main_consumer(), mirror_consumer(),
                         churn())
    # let in-flight dead-letter republishes and requeues settle
    await asyncio.sleep(0.5)

    # the soak actually moved messages down every path
    assert acked > 0
    assert rejected > 0
    assert mirror_seen > 0  # e2e fanout delivered during the churn windows

    # conservation on the capped DLX'd queue: every committed message either
    # reached the consumer and was acked, was rejected/overflowed into
    # q_dead, or is still sitting ready in one of the two queues
    ok_main = await setup.queue_declare("q_main", passive=True)
    ok_dead = await setup.queue_declare("q_dead", passive=True)
    rejected_or_dropped = ok_dead.message_count
    assert rejected_or_dropped > 0
    assert committed == (acked + rejected_or_dropped + ok_main.message_count), (
        committed, acked, rejected_or_dropped, ok_main.message_count)
    assert committed == BATCH * BATCHES * 4 // 5
    # the broker survived the churn and the graph still routes
    ch = await c.channel()
    ch.basic_publish(b"final", exchange="soak_src", routing_key="job.k0")
    for _ in range(50):
        m = await ch.basic_get("q_mirror", no_ack=True)
        if m is not None and m.body == b"final":
            break
        await asyncio.sleep(0.02)
    else:
        raise AssertionError("post-soak publish did not route through e2e")
    # every dead message carries a coherent x-death header
    sample = await ch.basic_get("q_dead", no_ack=True)
    assert sample is not None
    death = sample.properties.headers["x-death"][0]
    assert death["queue"] == "q_main"
    assert death["reason"] in ("rejected", "maxlen")
    await c.close()
    await srv.stop()
