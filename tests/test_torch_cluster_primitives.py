"""Cluster primitive tests: RPC, consistent-hash ring, membership.

The port's copy of ``tests/test_cluster_primitives.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU; the
assertions are the reference's.
"""

import asyncio

import pytest

from chanamq_tpu_torch.cluster.hashring import HashRing
from chanamq_tpu_torch.cluster.membership import Membership
from chanamq_tpu_torch.cluster.rpc import RpcClient, RpcError, RpcServer, RpcTimeout

pytestmark = pytest.mark.asyncio


# ---------------------------------------------------------------------------
# RPC
# ---------------------------------------------------------------------------


@pytest.fixture
async def rpc():
    server = RpcServer("127.0.0.1", 0)

    async def echo(payload):
        return {"echo": payload.get("value"), "n": payload.get("n", 0) + 1}

    async def boom(payload):
        raise RpcError("boom", "deliberate")

    async def slow(payload):
        await asyncio.sleep(5)
        return {}

    server.register("echo", echo)
    server.register("boom", boom)
    server.register("slow", slow)
    await server.start()
    client = RpcClient("127.0.0.1", server.bound_port)
    yield server, client
    await client.close()
    await server.stop()


async def test_rpc_roundtrip(rpc):
    _, client = rpc
    out = await client.call("echo", {"value": "hi", "n": 41})
    assert out == {"echo": "hi", "n": 42}


async def test_rpc_binary_payload(rpc):
    _, client = rpc
    blob = bytes(range(256)) * 10
    out = await client.call("echo", {"value": blob})
    assert out["echo"] == blob


async def test_rpc_nested_payload(rpc):
    _, client = rpc
    nested = {"value": {"a": [1, "two", {"three": 3}], "b": True, "c": None}}
    out = await client.call("echo", nested)
    assert out["echo"] == nested["value"]


async def test_rpc_error_propagates(rpc):
    _, client = rpc
    with pytest.raises(RpcError) as exc_info:
        await client.call("boom")
    assert exc_info.value.code == "boom"


async def test_rpc_unknown_method(rpc):
    _, client = rpc
    with pytest.raises(RpcError) as exc_info:
        await client.call("nope")
    assert exc_info.value.code == "no_such_method"


async def test_rpc_timeout(rpc):
    _, client = rpc
    with pytest.raises(RpcTimeout):
        await client.call("slow", timeout_s=0.2)


async def test_rpc_concurrent_correlation(rpc):
    _, client = rpc
    outs = await asyncio.gather(
        *[client.call("echo", {"n": i}) for i in range(50)])
    assert [o["n"] for o in outs] == [i + 1 for i in range(50)]


async def test_rpc_reconnects_after_server_restart():
    server = RpcServer("127.0.0.1", 0)

    async def ping(payload):
        return {"pong": True}

    server.register("ping", ping)
    await server.start()
    port = server.bound_port
    client = RpcClient("127.0.0.1", port)
    assert (await client.call("ping"))["pong"] is True
    await server.stop()
    with pytest.raises((RpcError, OSError)):
        await client.call("ping", timeout_s=1)
    server2 = RpcServer("127.0.0.1", port)
    server2.register("ping", ping)
    await server2.start()
    assert (await client.call("ping"))["pong"] is True  # lazy reconnect
    await client.close()
    await server2.stop()


# ---------------------------------------------------------------------------
# hash ring
# ---------------------------------------------------------------------------


def test_ring_deterministic_and_complete():
    ring = HashRing(["n1:1", "n2:1", "n3:1"])
    owners = {ring.owner(f"key{i}") for i in range(1000)}
    assert owners == {"n1:1", "n2:1", "n3:1"}
    assert ring.owner("stable") == ring.owner("stable")


def test_ring_minimal_movement_on_removal():
    ring = HashRing(["n1:1", "n2:1", "n3:1"])
    before = {f"key{i}": ring.owner(f"key{i}") for i in range(2000)}
    ring.remove("n2:1")
    moved = 0
    for key, old in before.items():
        new = ring.owner(key)
        if old != "n2:1":
            assert new == old  # survivors keep their keys
        else:
            moved += 1
    assert moved > 0


def test_ring_empty():
    assert HashRing([]).owner("x") is None


def test_ring_entity_key():
    ring = HashRing(["a:1", "b:1"])
    assert ring.owner_entity("q", "/", "foo") in ("a:1", "b:1")
    # distinct kinds may land differently but must be deterministic
    assert ring.owner_entity("q", "/", "foo") == ring.owner_entity("q", "/", "foo")


# ---------------------------------------------------------------------------
# membership
# ---------------------------------------------------------------------------


async def make_node(seeds):
    server = RpcServer("127.0.0.1", 0)
    await server.start()
    name = f"127.0.0.1:{server.bound_port}"
    membership = Membership(
        name, seeds, server,
        heartbeat_interval_s=0.1, failure_timeout_s=0.6)
    await membership.start()
    return server, membership


async def test_membership_three_nodes_converge_and_detect_failure():
    s1, m1 = await make_node([])
    s2, m2 = await make_node([m1.self_name])
    s3, m3 = await make_node([m1.self_name])
    try:
        for _ in range(50):
            if (len(m1.alive_members()) == 3 and len(m2.alive_members()) == 3
                    and len(m3.alive_members()) == 3):
                break
            await asyncio.sleep(0.1)
        assert len(m1.alive_members()) == 3
        assert m1.alive_members() == m2.alive_members() == m3.alive_members()
        assert m1.leader() == m2.leader() == m3.leader()

        # kill node 3
        await m3.stop()
        await s3.stop()
        for _ in range(60):
            if (m3.self_name not in m1.alive_members()
                    and m3.self_name not in m2.alive_members()):
                break
            await asyncio.sleep(0.1)
        assert m3.self_name not in m1.alive_members()
        assert m3.self_name not in m2.alive_members()
        assert len(m1.alive_members()) == 2
    finally:
        for m, s in ((m1, s1), (m2, s2)):
            await m.stop()
            await s.stop()


async def test_membership_rejoin_after_down():
    s1, m1 = await make_node([])
    s2, m2 = await make_node([m1.self_name])
    try:
        for _ in range(50):
            if len(m1.alive_members()) == 2:
                break
            await asyncio.sleep(0.1)
        # stop node2's server, wait for down, then restart on the same port
        port = m2.self_name.rsplit(":", 1)[1]
        await m2.stop()
        await s2.stop()
        for _ in range(60):
            if m2.self_name not in m1.alive_members():
                break
            await asyncio.sleep(0.1)
        assert m2.self_name not in m1.alive_members()

        s2b = RpcServer("127.0.0.1", int(port))
        await s2b.start()
        m2b = Membership(m2.self_name, [m1.self_name], s2b,
                         heartbeat_interval_s=0.1, failure_timeout_s=0.6)
        await m2b.start()
        for _ in range(60):
            if m2.self_name in m1.alive_members():
                break
            await asyncio.sleep(0.1)
        assert m2.self_name in m1.alive_members()
        await m2b.stop()
        await s2b.stop()
    finally:
        await m1.stop()
        await s1.stop()


def test_ring_balance_across_nodes():
    """Consistent-hash distribution: with the default virtual-node count,
    no node owns a pathological share of keys (the reference sharded by
    entityId.hashCode % 100; this ring must spread at least as well)."""
    ring = HashRing(["node-a", "node-b", "node-c"], virtual_nodes=64)
    counts = {"node-a": 0, "node-b": 0, "node-c": 0}
    n = 9000
    for i in range(n):
        counts[ring.owner_entity("q", "/", f"queue-{i}")] += 1
    for node, count in counts.items():
        share = count / n
        assert 0.15 < share < 0.55, (node, share, counts)


def test_ring_minimal_movement_on_join():
    """Adding a node must move only the keys the new node takes over —
    ownership of everything else is pinned (the join-churn guarantee the
    broker's queue routing relies on)."""
    before = HashRing(["node-a", "node-b"], virtual_nodes=64)
    after = HashRing(["node-a", "node-b", "node-c"], virtual_nodes=64)
    moved = stayed = 0
    for i in range(4000):
        o1 = before.owner_entity("q", "/", f"queue-{i}")
        o2 = after.owner_entity("q", "/", f"queue-{i}")
        if o1 == o2:
            stayed += 1
        else:
            moved += 1
            assert o2 == "node-c", (o1, o2)  # keys only move TO the joiner
    # roughly a third moves; anything far beyond that breaks the pin
    assert moved / 4000 < 0.5, moved
