"""The port's broker (``chanamq_tpu_torch``) against the JAX package's, on
the CPU: one scripted publish/consume run over real sockets through each
package's own server and client, the wire bytes of rendered commands, and a
rehearsal of ``chip_smoke.py``'s main-path phase at a tiny size.

The reference server routes with backend "python"; the port's with backend
"torch" on the CPU, where the router's wrappers run their plain PyTorch
versions. Queue counts, delivered (routing key, body) sequences and wire
bytes must be identical.
"""

import types

import numpy as np
import pytest
import torch
from torch.autograd.profiler_util import Interval

import chip_smoke
from chanamq_tpu.router import compile as ref_compile
from chanamq_tpu.amqp import methods as ref_am
from chanamq_tpu.amqp.command import AMQCommand as RefCommand
from chanamq_tpu.amqp.properties import BasicProperties as RefProps
from chanamq_tpu.broker.broker import Broker as RefBroker
from chanamq_tpu.broker.server import BrokerServer as RefServer
from chanamq_tpu.client import AMQPClient as RefClient
from chanamq_tpu_torch.amqp import methods as port_am
from chanamq_tpu_torch.amqp.command import AMQCommand as PortCommand
from chanamq_tpu_torch.amqp.properties import BasicProperties as PortProps
from chanamq_tpu_torch.broker.broker import Broker as PortBroker
from chanamq_tpu_torch.broker.server import BrokerServer as PortServer
from chanamq_tpu_torch.client import AMQPClient as PortClient
from chanamq_tpu_torch.kernels import router_match as rm
from chanamq_tpu_torch.router import compile as port_compile

QUEUES = [f"q{i}" for i in range(8)]
TOPIC_BINDS = [("q0", "a.*"), ("q1", "a.#"), ("q2", "*.b.*"), ("q3", "#.z"),
               ("q4", "a.b.c"), ("q7", "a.*")]
HEADERS_BINDS = [("q5", {"x-match": "all", "k": "v", "n": 1}),
                 ("q6", {"x-match": "any", "k": "v", "m": "w"}),
                 ("q7", {"x-match": "any", "n": 2})]
TOPIC_KEYS = ["a.b", "a.b.c", "x.b.y", "q.z", "a", "none", "a.x.z", ""]
HEADER_SETS = [{"k": "v", "n": 1}, {"k": "v"}, {"m": "w"}, {"n": 2},
               {"n": 1}, {}, {"k": "v", "n": 2, "m": "w"}]


async def _script(server, client_cls, props_cls) -> tuple:
    """Declare, bind (topic, headers, and an exchange-to-exchange fanout
    root over the topic exchange), publish bursts with confirms, then drain
    every queue with basic.get."""
    c = await client_cls.connect("127.0.0.1", server.bound_port, heartbeat=0)
    ch = await c.channel()
    await ch.exchange_declare("t", "topic")
    await ch.exchange_declare("h", "headers")
    await ch.exchange_declare("root", "fanout")
    await ch.exchange_bind("t", "root", "")
    for q in QUEUES:
        await ch.queue_declare(q)
    for q, key in TOPIC_BINDS:
        await ch.queue_bind(q, "t", key)
    for q, args in HEADERS_BINDS:
        await ch.queue_bind(q, "h", "", arguments=args)
    await ch.confirm_select()
    props = [props_cls(headers=h) for h in HEADER_SETS]
    n = 0
    for rnd in range(3):
        for i in range(40):
            key = TOPIC_KEYS[(i + rnd) % len(TOPIC_KEYS)]
            ch.basic_publish(f"t{n}".encode(), exchange="t", routing_key=key)
            n += 1
        for i in range(40):
            ch.basic_publish(f"h{n}".encode(), exchange="h",
                             properties=props[(i * 3 + rnd) % len(props)])
            n += 1
        for i in range(20):
            key = TOPIC_KEYS[(i * 5 + rnd) % len(TOPIC_KEYS)]
            ch.basic_publish(f"r{n}".encode(), exchange="root",
                             routing_key=key)
            n += 1
        await ch.wait_unconfirmed_below(1)
    counts = {q: server.broker.vhosts["/"].queues[q].message_count
              for q in QUEUES}
    delivered = {}
    for q in QUEUES:
        got = []
        while True:
            msg = await ch.basic_get(q, no_ack=True)
            if msg is None:
                break
            got.append((msg.routing_key, msg.body))
        delivered[q] = got
    await c.close()
    return counts, delivered


def _run(event_loop, server, client_cls, props_cls):
    async def go():
        await server.start()
        try:
            return await _script(server, client_cls, props_cls)
        finally:
            await server.stop()

    return event_loop.run_until_complete(go())


def test_scripted_run_matches_reference(event_loop):
    ref_srv = RefServer(RefBroker(router_backend="python"),
                        host="127.0.0.1", port=0, heartbeat_s=0)
    ref_counts, ref_delivered = _run(event_loop, ref_srv, RefClient, RefProps)
    port_srv = PortServer(PortBroker(router_device="cpu"),
                          host="127.0.0.1", port=0, heartbeat_s=0)
    port_counts, port_delivered = _run(event_loop, port_srv, PortClient,
                                       PortProps)
    assert port_counts == ref_counts
    assert port_delivered == ref_delivered
    assert sum(ref_counts.values()) > 200
    assert all(ref_counts[q] > 0 for q in QUEUES)
    m = port_srv.broker.metrics
    # the torch backend routed kernel batches (plain versions on the CPU)
    assert m.router_batches > 0 and m.router_batch_msgs >= 100
    assert m.router_parity_mismatches == 0
    assert port_srv.broker.router.backend == "torch"


def _commands(am, cmd_cls, props_cls):
    props = props_cls(content_type="application/json", delivery_mode=2,
                      priority=5, correlation_id="c-1", reply_to="rq",
                      expiration="60000", message_id="m-9",
                      timestamp=1_700_000_000, type="t", user_id="guest",
                      app_id="app", headers={"k": "v", "n": 7, "f": 2.5,
                                             "b": True, "l": [1, "x"],
                                             "t": {"in": b"bytes"}})
    return [
        cmd_cls(0, am.Connection.StartOk(
            client_properties={"product": "x", "capabilities": {"a": True}},
            mechanism="PLAIN", response=b"\x00guest\x00guest",
            locale="en_US")),
        cmd_cls(0, am.Connection.Tune(channel_max=2047, frame_max=131072,
                                      heartbeat=30)),
        cmd_cls(1, am.Queue.Declare(queue="q", durable=True, arguments={
            "x-max-priority": 9, "x-message-ttl": 1000})),
        cmd_cls(1, am.Queue.Bind(queue="q", exchange="h", routing_key="",
                                 arguments={"x-match": "any", "k": "v"})),
        cmd_cls(1, am.Exchange.Declare(exchange="t", type="topic")),
        cmd_cls(1, am.Basic.Publish(exchange="t", routing_key="a.b.c"),
                props, b"x" * 300),
        cmd_cls(3, am.Basic.Deliver(consumer_tag="ctag", delivery_tag=42,
                                    redelivered=True, exchange="t",
                                    routing_key="a.b"), props, b"body"),
        cmd_cls(1, am.Basic.Ack(delivery_tag=7, multiple=True)),
        cmd_cls(1, am.Channel.Close(reply_code=404, reply_text="NOT_FOUND",
                                    class_id=50, method_id=10)),
    ]


@pytest.mark.parametrize("frame_max", [0, 4096, 128])
def test_rendered_commands_identical_bytes(frame_max):
    ref = _commands(ref_am, RefCommand, RefProps)
    port = _commands(port_am, PortCommand, PortProps)
    assert len(ref) == len(port)
    for r, p in zip(ref, port):
        assert p.render(frame_max) == r.render(frame_max)


def test_chip_smoke_main_path_rehearsal():
    """chip_smoke's main-path phase end to end on the CPU at a tiny size:
    real sockets, the torch backend with verify on, every queue held to
    the oracle, consumers in publish order; then every kernel call it made
    replayed through the wrapper and the plain version."""
    calls: dict = {}
    res = chip_smoke.phase_main(
        torch.device("cpu"), 0, n_queues=128, n_patterns=32, n_keys=200,
        n_header_sets=32, n_topic=800, n_headers=400, publishers=2,
        consumers=4, window=128, calls=calls)
    assert res["messages"] == 1200
    assert res["router_parity_mismatches"] == 0
    assert res["router_batches"] > 0
    assert res["delivered"] > 0 and res["consumed_queues"] == 4
    assert res["backend"] == "torch" and res["device"] == "cpu"
    assert res["route_pending_s"] >= res["route_batch_s"] > 0
    assert res["trace"] is None  # the device trace is taken on a card only
    assert set(calls) == {"topic_match", "headers_match"}
    assert port_compile.router_match is rm  # the recording seam is undone
    path = chip_smoke.phase_path_kernels(calls)
    for name, row in path.items():
        assert row["calls"] == len(calls[name]) > 0
        assert row["mismatched_words"] == 0
        assert sum(row["shapes"].values()) == row["calls"]
        assert row["shape"] in row["shapes"]
        assert row["ops"] > 0 and row["bound_by"] in ("bytes", "operations")


def test_chip_smoke_durable_rehearsal():
    """chip_smoke's [durable] phase end to end on the CPU at a tiny size: a
    node process from ``from_config`` at the WAL's defaults, confirmed
    persistent publishes, SIGKILL, a second node replaying the WAL, every
    queue consumed and held to the oracle, both processes gone."""
    res = chip_smoke.phase_durable(
        torch.device("cpu"), 0, n_queues=64, n_patterns=16, n_keys=200,
        n_header_sets=32, n_topic=400, n_headers=200, window=128)
    assert res["messages"] == 600
    assert res["deliveries"] == res["expected_deliveries"] > 600
    assert (res["lost"], res["duplicated"], res["reordered_streams"],
            res["altered"], res["stray"]) == (0, 0, 0, 0, 0)
    assert res["first_start_recovered"] == 0 < res["recovered_records"]
    assert res["traced"]["trace"] is None  # the card is traced on a card
    wal = res["traced"]["wal"]
    assert wal["fsyncs"] == wal["commits"] > 0 and wal["commit_errors"] == 0
    assert res["traced"]["router"]["batch_msgs"] > 0


def test_chip_smoke_device_busy_unions_spans():
    """The traced busy time is the union of the device's spans (a copy
    overlapping a kernel counts once); host events are not device time,
    and each router kernel's launches and time are summed by name."""
    cuda, cpu = chip_smoke.DeviceType.CUDA, chip_smoke.DeviceType.CPU

    def ev(name, start, end, device=cuda):
        return types.SimpleNamespace(
            name=name, device_type=device,
            time_range=Interval(start, end))

    trace = types.SimpleNamespace(events=lambda: [
        ev("void (anonymous namespace)::topic_match_kernel(int const*)",
           10.0, 20.0),
        ev("Memcpy HtoD", 15.0, 25.0),
        ev("headers_match_kernel", 30.0, 33.0),
        ev("cudaLaunchKernel", 0.0, 100.0, cpu),
        ev("topic_match_kernel", 40.0, 44.0)])
    got = chip_smoke.device_busy(trace)
    assert got["events"] == 4
    assert got["busy_us"] == 15.0 + 3.0 + 4.0
    assert got["kernels"] == {"topic_match": {"launches": 2, "us": 14.0},
                              "headers_match": {"launches": 1, "us": 3.0}}


def _one_hot_pairs(ref_kernel, args: tuple, masks, real_msgs) -> int:
    """Matched (real message, real row) pairs by brute force: the JAX
    package's numpy kernel body over a mask table in which each real row
    sets only its own bit."""
    n = masks.shape[0]
    onehot = np.zeros((n, (n + 31) // 32), np.uint32)
    for i in np.nonzero(masks.any(axis=1))[0]:
        onehot[i, i >> 5] = np.uint32(1 << (int(i) & 31))
    rows = ref_kernel(np, *args[:-1], onehot, *args[-1])
    return int(sum(bin(int(x)).count("1") for x in rows[real_msgs].ravel()))


def test_chip_smoke_kernel_phase_rehearsal():
    """chip_smoke's kernel phase on the CPU: the tables and messages it
    builds (padding rows, bit-31 words, MISS cells) go through the
    wrappers and the plain versions alike, and its work counters find the
    matched pairs that a brute-force count finds."""
    res = chip_smoke.phase_kernels(torch.device("cpu"), 3, n=64, w=4,
                                   batches=(16, 33))
    for rows in res.values():
        for row in rows.values():
            assert row["mismatched_words"] == 0
            assert row["matched_pairs"] > 0
            assert row["bound_by"] in ("bytes", "operations")
    rng = np.random.default_rng(5)
    tt = chip_smoke.topic_tables(rng, 64, 4)
    msgs = chip_smoke.topic_messages(rng, tt, 48)
    targs = tuple(tt[k] for k in ("pre", "suf", "plen", "slen", "has_hash"))
    _, matched = chip_smoke.topic_work(*targs, tt["masks"], *msgs)
    assert matched == _one_hot_pairs(ref_compile._topic_kernel,
                                     (*targs, msgs), tt["masks"],
                                     msgs[2] > 0) > 0
    ht = chip_smoke.headers_tables(rng, 64, 4)
    pids = chip_smoke.headers_messages(rng, ht, 48)
    hargs = tuple(ht[k] for k in ("req", "rcount", "is_all"))
    _, matched = chip_smoke.headers_work(*hargs, ht["masks"], pids)
    assert matched == _one_hot_pairs(
        ref_compile._headers_kernel, (*hargs, (pids,)), ht["masks"],
        (pids != chip_smoke.MISS).any(axis=1)) > 0


def test_chip_smoke_work_counts_by_hand():
    """The operations behind the bound, counted by hand on tiny inputs:
    only real rows and messages, only literal or required cells, each
    loop stopped where the match is decided, and (hits - 1) * W ORs."""
    pad, star, miss = chip_smoke.PAD, chip_smoke.STAR, chip_smoke.MISS
    a, b, c, x = 0, 1, 2, 3
    # rows "a.*.c", "a.#" and a padding row; keys a.b.c, x.b.c, a.b and a
    # batch-padding message
    pre = np.array([[a, star, c, pad], [a, pad, pad, pad],
                    [pad] * 4], np.int32)
    suf = np.full((3, 2), pad, np.int32)
    plen = np.array([3, 1, 0], np.int32)
    slen = np.zeros(3, np.int32)
    has_hash = np.array([False, True, False])
    masks = np.array([[1, 0], [0, 1 << 31], [0, 0]], np.uint32)
    pre_m = np.array([[a, b, c, miss], [x, b, c, miss],
                      [a, b, miss, miss], [miss] * 4], np.int32)
    suf_m = np.array([[b, c], [b, c], [a, b], [miss, miss]], np.int32)
    mlen = np.array([3, 3, 2, 0], np.int32)
    # "a.*.c": a.b.c 1 + 2, x.b.c 1 + 1, a.b 1 (length fails);
    # "a.#": 1 + 1 for each key; ORs: a.b.c hits both rows, 1 * W
    ops, matched = chip_smoke.topic_work(pre, suf, plen, slen, has_hash,
                                         masks, pre_m, suf_m, mlen)
    assert (ops, matched) == (6 + 6 + 2, 3)

    # rows all{0, 1}, any{2, 3} and a padding row; one message with ids
    # [1, 0] and one batch-padding message
    req = np.array([[0, 1, pad, pad], [2, 3, pad, pad], [pad] * 4],
                   np.int32)
    rcount = np.array([2, 2, 0], np.int32)
    is_all = np.array([True, False, False])
    hmasks = np.array([[1], [2], [0]], np.uint32)
    pids = np.array([[1, 0, miss, miss], [miss] * 4], np.int32)
    # all{0,1}: id 0 found second (2), id 1 first (1), count test (1);
    # any{2,3}: neither found (2 + 2), count test (1)
    ops, matched = chip_smoke.headers_work(req, rcount, is_all, hmasks,
                                           pids)
    assert (ops, matched) == (4 + 5, 1)
