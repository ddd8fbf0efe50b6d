"""The router cells' client processes: PerfTest-shaped publishers and
consumers over the frozen AMQP client. They import neither torch nor the
program.

    python3 mqbench/clients.py publisher '<json>'
    python3 mqbench/clients.py consumer '<json>'

A publisher makes its stream (``frozen/workload.py``), connects, selects
confirms and prints ``ready``. On ``go <t0> <t1>`` (``time.monotonic``
seconds) from standard input it publishes with at most ``confirm_window``
messages unconfirmed, notes how many were confirmed at ``t0`` and at
``t1``, stops publishing at ``t1``, waits for every confirm and prints its
result as one JSON line. A consumer consumes its queues with manual acks
(``multiple`` every ``multi_ack_every``) at a prefetch of ``prefetch``,
logs each delivery's queue, publisher and sequence number, prints
``ready``, and on ``stop`` waits until no delivery came for half a second,
writes its log to the given file and prints its count as one JSON line.
"""

import asyncio
import json
import os
import struct
import sys
import time
from array import array

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from mqbench.frozen import workload  # noqa: E402
from mqbench.frozen.amqp.properties import BasicProperties  # noqa: E402
from mqbench.frozen.client import AMQPClient  # noqa: E402

IDLE_S = 0.5


async def _stdin() -> asyncio.StreamReader:
    loop = asyncio.get_running_loop()
    reader = asyncio.StreamReader()
    await loop.connect_read_pipe(
        lambda: asyncio.StreamReaderProtocol(reader), sys.stdin)
    return reader


async def publisher(a: dict) -> dict:
    t = a["traffic"]
    topo = workload.Topology(**a["topology"])
    stream = workload.Stream(topo, t, a["seed"], a["p"])
    n = t["messages_per_publisher"]
    msgs = [stream.message(i) for i in range(n)]
    props = [BasicProperties(headers=hs) for hs in topo.header_sets]
    window = t["confirm_window"]
    client = await AMQPClient.connect(a["host"], a["port"], heartbeat=0)
    ch = await client.channel()
    await ch.confirm_select()
    nacked = [0]
    on_confirm = ch._on_confirm
    sent = [0]

    def counting(tag: int, multiple: bool, nack: bool) -> None:
        before = len(ch.unconfirmed)
        on_confirm(tag, multiple, nack)
        if nack:
            nacked[0] += max(1, before - len(ch.unconfirmed))

    ch._on_confirm = counting
    stdin = await _stdin()
    print("ready", flush=True)
    _, t0, t1 = (await stdin.readline()).split()
    t0, t1 = float(t0), float(t1)
    loop = asyncio.get_running_loop()
    snaps: dict = {}

    def snap(name: str) -> None:
        snaps[name] = sent[0] - len(ch.unconfirmed)

    loop.call_later(max(0.0, t0 - time.monotonic()), snap, "c0")
    loop.call_later(max(0.0, t1 - time.monotonic()), snap, "c1")
    i = 0
    while "c1" not in snaps:
        kind, x = msgs[i % n]
        body = stream.body(i)
        if kind == "t":
            ch.basic_publish(body, exchange=workload.TOPIC_EXCHANGE,
                             routing_key=x)
        else:
            ch.basic_publish(body, exchange=workload.HEADERS_EXCHANGE,
                             properties=props[x])
        i += 1
        sent[0] = i
        if len(ch.unconfirmed) >= window:
            await ch.wait_unconfirmed_below(window, timeout=120)
        elif i % 256 == 0:
            await asyncio.sleep(0)
    drain = time.monotonic()
    await ch.wait_unconfirmed_below(1, timeout=120)
    out = {"p": a["p"], "published": i, "c0": snaps["c0"],
           "c1": snaps["c1"], "nacked": nacked[0],
           "drain_s": time.monotonic() - drain}
    await client.close()
    return out


async def consumer(a: dict) -> dict:
    client = await AMQPClient.connect(a["host"], a["port"], heartbeat=0)
    ch = await client.channel()
    await ch.basic_qos(prefetch_count=a["prefetch"])
    every = a["multi_ack_every"]
    qs, ps, ss = array("H"), array("B"), array("I")
    state = {"n": 0, "last": time.monotonic(), "tag": 0}
    unpack = struct.Struct("<II").unpack_from

    def callback(qi: int):
        def cb(msg) -> None:
            p, i = unpack(msg.body)
            qs.append(qi)
            ps.append(p)
            ss.append(i)
            state["n"] += 1
            state["tag"] = msg.delivery_tag
            state["last"] = time.monotonic()
            if state["n"] % every == 0:
                ch.basic_ack(msg.delivery_tag, multiple=True)
        return cb

    for qi in a["queues"]:
        await ch.basic_consume(f"q{qi:04d}", callback(qi),
                               consumer_tag=f"c{qi}")
    stdin = await _stdin()
    print("ready", flush=True)
    await stdin.readline()
    while time.monotonic() - state["last"] < IDLE_S:
        await asyncio.sleep(0.05)
    if state["n"] % every:
        ch.basic_ack(state["tag"], multiple=True)
    with open(a["log"], "wb") as f:
        f.write(struct.pack("<Q", state["n"]))
        f.write(qs.tobytes())
        f.write(ps.tobytes())
        f.write(ss.tobytes())
    await client.close()
    return {"deliveries": state["n"]}


def main() -> int:
    role, arg = sys.argv[1], json.loads(sys.argv[2])
    fn = {"publisher": publisher, "consumer": consumer}[role]
    out = asyncio.run(fn(arg))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
