"""Multi-tenancy: /admin/tenants endpoint shapes, SASL handshake edge
cases, ACL denials, quota caps, config fail-closed paths, and the
tenant-labeled observability surface.

Admin conventions under test are the telemetry routes' set: mutations require POST
(405 otherwise), unknown names are 404, invalid specs are 400, and a
subsystem that is not enabled answers 409 — never a silent empty body.

The port's copy of ``tests/test_tenancy.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU; the
assertions are the reference's.
"""

import asyncio
import json
import struct

import pytest

from chanamq_tpu_torch import tenancy as tenancy_mod
from chanamq_tpu_torch.broker.server import BrokerServer
from chanamq_tpu_torch.client import AMQPClient
from chanamq_tpu_torch.client.client import ChannelClosedError, ConnectionClosedError
from chanamq_tpu_torch.config import Config, ConfigError
from chanamq_tpu_torch.rest.admin import AdminServer
from chanamq_tpu_torch.tenancy import TenancyError, TenantRegistry
from chanamq_tpu_torch.broker.broker import Broker

pytestmark = pytest.mark.asyncio

CONN_REFUSED = (ConnectionClosedError, OSError,
                asyncio.IncompleteReadError, asyncio.TimeoutError)


async def http_req(port: int, path: str, method: str = "GET",
                   body: "dict | bytes | None" = None) -> tuple[int, dict]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = (body if isinstance(body, bytes)
               else json.dumps(body).encode() if body is not None else b"")
    writer.write(
        f"{method} {path} HTTP/1.1\r\nHost: localhost\r\n"
        f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(1 << 20), 5)
    writer.close()
    head, _, resp = raw.partition(b"\r\n\r\n")
    status = int(head.split()[1])
    return status, json.loads(resp) if resp else {}


async def http_text(port: int, path: str) -> tuple[int, str]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: localhost\r\n\r\n".encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(1 << 22), 5)
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body.decode()


def _attach_registry(server: BrokerServer) -> TenantRegistry:
    registry = TenantRegistry(server.broker)
    server.broker.tenancy = registry
    tenancy_mod.install(registry)
    return registry


@pytest.fixture
async def stack():
    """Broker + admin with tenancy enabled (empty registry)."""
    server = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                          port=0, heartbeat_s=0)
    await server.start()
    registry = _attach_registry(server)
    admin = AdminServer(server.broker, port=0)
    await admin.start()
    yield server, admin, registry
    tenancy_mod.install(None)
    await admin.stop()
    await server.stop()


# ---------------------------------------------------------------------------
# /admin/tenants endpoint shapes (the telemetry routes' conventions)
# ---------------------------------------------------------------------------


async def test_admin_tenants_crud_shapes(stack):
    server, admin, registry = stack
    port = admin.bound_port

    # empty registry snapshot
    status, body = await http_req(port, "/admin/tenants")
    assert status == 200
    assert body == {"tenants": [], "count": 0, "ticks": 0, "decisions": 0}

    # define at runtime: same spec shape as chana.mq.tenant.tenants + name
    status, body = await http_req(port, "/admin/tenants", "POST", {
        "name": "acme", "vhosts": ["acme-vh"], "users": {"alice": "pw"},
        "acls": {"alice": {"acme-vh": ["configure", "write", "read"]}},
        "quota": {"max-queues": 2, "publish-rate": 4096}})
    assert status == 200 and body["ok"]
    snap = body["tenant"]
    assert snap["name"] == "acme"
    assert snap["vhosts"] == ["acme-vh"]
    assert snap["quota"]["max-queues"] == 2
    assert snap["quota"]["publish-burst"] == 8192  # default 2x rate
    assert "acme" in registry.tenants

    # detail + list
    status, body = await http_req(port, "/admin/tenants/acme")
    assert status == 200 and body["name"] == "acme"
    status, body = await http_req(port, "/admin/tenants")
    assert status == 200 and body["count"] == 1

    # 404: unknown tenant (detail and delete)
    status, body = await http_req(port, "/admin/tenants/nope")
    assert status == 404 and "error" in body
    status, body = await http_req(port, "/admin/tenants/nope/delete", "POST")
    assert status == 404 and "error" in body

    # 405: wrong method on the collection and on the delete mutation
    status, body = await http_req(port, "/admin/tenants", "DELETE")
    assert status == 405
    status, body = await http_req(port, "/admin/tenants/acme/delete")
    assert status == 405

    # delete, then the name is gone (404 on a second delete)
    status, body = await http_req(port, "/admin/tenants/acme/delete", "POST")
    assert status == 200 and body["ok"] and body["tenant"] == "acme"
    assert "acme" not in registry.tenants
    status, body = await http_req(port, "/admin/tenants/acme/delete", "POST")
    assert status == 404


async def test_admin_tenants_400_invalid_specs(stack):
    server, admin, registry = stack
    port = admin.bound_port
    registry.define("held", {"vhosts": ["held-vh"], "users": {"bob": "pw"}})

    bad_bodies = [
        b"{not json",                                        # unparseable
        json.dumps({"vhosts": ["v"]}).encode(),              # no name
        json.dumps({"name": "", "vhosts": ["v"]}).encode(),  # empty name
        json.dumps({"name": "t"}).encode(),                  # no vhosts
        json.dumps({"name": "t", "vhosts": ["v"],
                    "quota": {"max-widgets": 1}}).encode(),  # unknown quota
        json.dumps({"name": "t", "vhosts": ["v"],
                    "quota": {"memory-share": 1.5}}).encode(),
        json.dumps({"name": "t", "vhosts": ["v"],
                    "quota": {"publish-burst": 64}}).encode(),  # burst w/o rate
        json.dumps({"name": "t", "vhosts": ["v"],
                    "acls": {"ghost": {"v": ["read"]}}}).encode(),
        json.dumps({"name": "t", "vhosts": ["held-vh"]}).encode(),  # owned
        json.dumps({"name": "t", "vhosts": ["v"],
                    "users": {"bob": "pw2"}}).encode(),      # user owned
    ]
    for raw in bad_bodies:
        status, body = await http_req(port, "/admin/tenants", "POST", raw)
        assert status == 400 and "error" in body, raw
    # nothing leaked into the registry from the refused defines
    assert set(registry.tenants) == {"held"}


async def test_admin_tenants_409_when_disabled():
    server = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                          port=0, heartbeat_s=0)
    await server.start()
    admin = AdminServer(server.broker, port=0)
    await admin.start()
    try:
        for path, method, body in [
                ("/admin/tenants", "GET", None),
                ("/admin/tenants", "POST",
                 {"name": "t", "vhosts": ["v"]}),
                ("/admin/tenants/t", "GET", None),
                ("/admin/tenants/t/delete", "POST", None)]:
            status, resp = await http_req(
                admin.bound_port, path, method, body)
            assert status == 409, (path, method)
            assert "tenant" in resp["error"]
    finally:
        await admin.stop()
        await server.stop()


# ---------------------------------------------------------------------------
# SASL handshake edge cases
# ---------------------------------------------------------------------------


def _method_frame(channel: int, class_id: int, method_id: int,
                  args: bytes) -> bytes:
    payload = struct.pack(">HH", class_id, method_id) + args
    return (struct.pack(">BHI", 1, channel, len(payload))
            + payload + b"\xce")


def _shortstr(s: str) -> bytes:
    b = s.encode()
    return bytes([len(b)]) + b


def _longstr(b: bytes) -> bytes:
    return struct.pack(">I", len(b)) + b


async def _read_frame(reader) -> tuple[int, int, bytes]:
    header = await asyncio.wait_for(reader.readexactly(7), 10)
    ftype, channel, size = struct.unpack(">BHI", header)
    rest = await asyncio.wait_for(reader.readexactly(size + 1), 10)
    assert rest[-1] == 0xCE
    return ftype, channel, rest[:-1]


async def _start_ok(port: int, mechanism: str,
                    response: bytes) -> tuple[int, int, bytes]:
    """Raw handshake through StartOk (the client object always picks
    PLAIN, so EXTERNAL must be driven on the wire); returns the (class,
    method, args) of the server's reply frame."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(b"AMQP\x00\x00\x09\x01")
        await _read_frame(reader)  # Connection.Start
        writer.write(_method_frame(
            0, 10, 11,
            struct.pack(">I", 0)            # empty client-properties table
            + _shortstr(mechanism) + _longstr(response) + _shortstr("en_US")))
        _, _, payload = await _read_frame(reader)
        class_id, method_id = struct.unpack(">HH", payload[:4])
        return class_id, method_id, payload[4:]
    finally:
        writer.close()


async def test_sasl_plain_wrong_password_closes_403():
    """PLAIN against the merged user table: a wrong password gets a
    Connection.Close with reply-code 403 (access-refused), and the same
    for a user that does not exist (no user-table oracle)."""
    srv = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                       port=0, heartbeat_s=0, users={"ops": "ops-pw"})
    await srv.start()
    registry = _attach_registry(srv)
    registry.define("acme", {"vhosts": ["acme-vh"],
                             "users": {"alice": "secret"}})
    await srv.broker.create_vhost("acme-vh")
    try:
        for response in (b"\x00alice\x00wrong", b"\x00ghost\x00whatever"):
            class_id, method_id, args = await _start_ok(
                srv.bound_port, "PLAIN", response)
            assert (class_id, method_id) == (10, 50)  # connection.close
            assert struct.unpack(">H", args[:2])[0] == 403
        # the happy paths through the same merged table still work
        c = await AMQPClient.connect(
            "127.0.0.1", srv.bound_port, vhost="acme-vh",
            username="alice", password="secret")
        await c.close()
        c = await AMQPClient.connect(
            "127.0.0.1", srv.bound_port, vhost="/",
            username="ops", password="ops-pw")
        await c.close()
        # tenant users are confined to their tenant's vhosts
        with pytest.raises(CONN_REFUSED):
            await AMQPClient.connect(
                "127.0.0.1", srv.bound_port, vhost="/",
                username="alice", password="secret")
    finally:
        tenancy_mod.install(None)
        await srv.stop()


async def test_sasl_external_refused_when_users_configured():
    """EXTERNAL (no in-band credentials) must be refused the moment any
    user table exists — here the only users are tenant-declared, so the
    refusal proves the merged view reaches the SASL seam."""
    srv = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                       port=0, heartbeat_s=0)
    await srv.start()
    registry = _attach_registry(srv)
    registry.define("acme", {"vhosts": ["acme-vh"],
                             "users": {"alice": "secret"}})
    try:
        class_id, method_id, args = await _start_ok(
            srv.bound_port, "EXTERNAL", b"")
        assert (class_id, method_id) == (10, 50)
        assert struct.unpack(">H", args[:2])[0] == 403
    finally:
        tenancy_mod.install(None)
        await srv.stop()


async def test_sasl_open_access_when_no_users_anywhere():
    """Reference-parity compatibility path: tenants without user tables
    keep the server open-access — PLAIN with any credentials and even
    EXTERNAL proceed to Tune."""
    srv = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                       port=0, heartbeat_s=0)
    await srv.start()
    registry = _attach_registry(srv)
    registry.define("quota-only", {"vhosts": ["q-vh"]})
    await srv.broker.create_vhost("q-vh")
    try:
        class_id, method_id, _ = await _start_ok(
            srv.bound_port, "EXTERNAL", b"")
        assert (class_id, method_id) == (10, 30)  # connection.tune
        c = await AMQPClient.connect(
            "127.0.0.1", srv.bound_port, vhost="q-vh",
            username="anyone", password="anything")
        await c.close()
    finally:
        tenancy_mod.install(None)
        await srv.stop()


# ---------------------------------------------------------------------------
# ACL denial -> access-refused (403) on declare / publish / consume
# ---------------------------------------------------------------------------


@pytest.fixture
async def acl_stack():
    srv = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                       port=0, heartbeat_s=0)
    await srv.start()
    registry = _attach_registry(srv)
    registry.define("acme", {
        "vhosts": ["acme-vh"],
        "users": {"full": "pw", "writer": "pw", "reader": "pw"},
        "acls": {
            "full": {"acme-vh": ["configure", "write", "read"]},
            "writer": {"acme-vh": ["write"]},
            "reader": {"acme-vh": ["read"]},
        }})
    await srv.broker.create_vhost("acme-vh")
    # the full user provisions the topology the restricted users hit
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port,
                                 vhost="acme-vh",
                                 username="full", password="pw")
    ch = await c.channel()
    await ch.queue_declare("aclq")
    await c.close()
    yield srv, registry
    tenancy_mod.install(None)
    await srv.stop()


async def _tenant_conn(srv, user: str) -> AMQPClient:
    return await AMQPClient.connect("127.0.0.1", srv.bound_port,
                                    vhost="acme-vh",
                                    username=user, password="pw")


async def test_acl_configure_denied_on_declare(acl_stack):
    srv, registry = acl_stack
    before = srv.broker.metrics.tenancy_acl_denials_total
    c = await _tenant_conn(srv, "writer")
    try:
        ch = await c.channel()
        with pytest.raises(ChannelClosedError) as exc:
            await ch.queue_declare("writerq")
        assert exc.value.reply_code == 403
        assert "configure" in exc.value.reply_text
        ch2 = await c.channel()
        with pytest.raises(ChannelClosedError) as exc:
            await ch2.exchange_declare("writerx", "topic")
        assert exc.value.reply_code == 403
        assert srv.broker.metrics.tenancy_acl_denials_total == before + 2
        assert "writerq" not in srv.broker.vhosts["acme-vh"].queues
    finally:
        await c.close()


async def test_acl_write_denied_on_publish(acl_stack):
    srv, registry = acl_stack
    c = await _tenant_conn(srv, "reader")
    try:
        ch = await c.channel()
        await ch.confirm_select()
        with pytest.raises(ChannelClosedError) as exc:
            await ch.basic_publish_confirmed(b"x", routing_key="aclq")
        assert exc.value.reply_code == 403
        assert "write" in exc.value.reply_text
    finally:
        await c.close()
    # nothing reached the queue, and the refusal was counted
    assert srv.broker.vhosts["acme-vh"].queues["aclq"].message_count == 0
    assert srv.broker.metrics.tenancy_acl_denials_total >= 1


async def test_acl_read_denied_on_consume_and_get(acl_stack):
    srv, registry = acl_stack
    c = await _tenant_conn(srv, "writer")
    try:
        ch = await c.channel()
        with pytest.raises(ChannelClosedError) as exc:
            await ch.basic_consume("aclq", lambda m: None)
        assert exc.value.reply_code == 403
        assert "read" in exc.value.reply_text
        ch2 = await c.channel()
        with pytest.raises(ChannelClosedError) as exc:
            await ch2.basic_get("aclq")
        assert exc.value.reply_code == 403
    finally:
        await c.close()


async def test_acl_full_permissions_unrestricted(acl_stack):
    srv, registry = acl_stack
    c = await _tenant_conn(srv, "full")
    try:
        ch = await c.channel()
        await ch.confirm_select()
        await ch.basic_publish_confirmed(b"payload", routing_key="aclq")
        got = await ch.basic_get("aclq", no_ack=True)
        assert got is not None and got.body == b"payload"
    finally:
        await c.close()


# ---------------------------------------------------------------------------
# quota caps at the existing mutation sites
# ---------------------------------------------------------------------------


async def test_connection_and_channel_quota_530(stack):
    server, admin, registry = stack
    registry.define("capped", {"vhosts": ["cap-vh"],
                               "quota": {"max-connections": 1,
                                         "max-channels": 2}})
    await server.broker.create_vhost("cap-vh")
    c1 = await AMQPClient.connect("127.0.0.1", server.bound_port,
                                  vhost="cap-vh")
    try:
        # second connection into the tenant's vhost: 530 not-allowed
        with pytest.raises(CONN_REFUSED):
            await AMQPClient.connect("127.0.0.1", server.bound_port,
                                     vhost="cap-vh")
        assert len(registry.tenants["capped"].conns) == 1
        # channels 1 and 2 fit the cap; the third is a connection-level
        # refusal (RabbitMQ's channel-limit shape)
        await c1.channel()
        await c1.channel()
        with pytest.raises(CONN_REFUSED + (ChannelClosedError,)) as exc:
            await c1.channel()
        if isinstance(exc.value, ConnectionClosedError):
            assert exc.value.reply_code == 530
        assert server.broker.metrics.tenancy_quota_refusals_total == 2
    finally:
        await c1.close()


async def test_queue_and_binding_quota_406(stack):
    server, admin, registry = stack
    await server.broker.create_vhost("cap-vh")
    base_bindings = 0  # fresh vhost: nothing bound yet
    registry.define("capped", {
        "vhosts": ["cap-vh"],
        "quota": {"max-queues": 1, "max-bindings": base_bindings + 1}})
    c = await AMQPClient.connect("127.0.0.1", server.bound_port,
                                 vhost="cap-vh")
    try:
        ch = await c.channel()
        await ch.queue_declare("q1")
        # re-declare of an existing queue stays free at the cap
        await ch.queue_declare("q1")
        with pytest.raises(ChannelClosedError) as exc:
            await ch.queue_declare("q2")
        assert exc.value.reply_code == 406
        assert "queue quota" in exc.value.reply_text

        ch = await c.channel()
        await ch.queue_bind("q1", "amq.topic", routing_key="a.#")
        with pytest.raises(ChannelClosedError) as exc:
            await ch.queue_bind("q1", "amq.topic", routing_key="b.#")
        assert exc.value.reply_code == 406
        assert "binding quota" in exc.value.reply_text
    finally:
        await c.close()


# ---------------------------------------------------------------------------
# config fail-closed + env wiring
# ---------------------------------------------------------------------------


async def test_tenancy_config_fails_closed():
    class _B:  # minimal broker stand-in: enable only touches .tenancy
        tenancy = None

    # tenants declared while tenancy is disabled: boot error, never a
    # silently unenforced quota
    with pytest.raises(ConfigError):
        tenancy_mod.enable_from_config(Config(overrides={
            "chana.mq.tenant.tenants": {"t": {"vhosts": ["/"]}}},
            env={}), _B())
    # malformed specs are boot errors too, with the tenant named
    with pytest.raises(ConfigError, match="bad-tenant"):
        tenancy_mod.enable_from_config(Config(overrides={
            "chana.mq.tenant.enabled": True,
            "chana.mq.tenant.tenants": {"bad-tenant": {"vhosts": []}}},
            env={}), _B())
    tenancy_mod.install(None)


async def test_tenancy_env_json_round_trip():
    spec = {"acme": {"vhosts": ["acme-vh"],
                     "quota": {"publish-rate": 4096}}}
    cfg = Config(env={"CHANAMQ_TENANT_ENABLED": "true",
                      "CHANAMQ_TENANT_TENANTS": json.dumps(spec)})

    class _B:
        tenancy = None

    broker = _B()
    registry = tenancy_mod.enable_from_config(cfg, broker)
    try:
        assert broker.tenancy is registry
        assert tenancy_mod.ACTIVE is registry
        tenant = registry.tenants["acme"]
        assert tenant.quota.publish_rate == 4096
        assert tenant.quota.publish_burst == 8192
        assert registry.by_vhost["acme-vh"] is tenant
    finally:
        tenancy_mod.install(None)


def test_registry_define_validation_direct():
    class _B:
        tenancy = None

    registry = TenantRegistry(_B())
    with pytest.raises(TenancyError):
        registry.define("", {"vhosts": ["v"]})
    with pytest.raises(TenancyError):
        registry.define("t", {"vhosts": ["v"], "extras": 1})
    with pytest.raises(TenancyError):
        registry.define("t", {"vhosts": ["v"],
                              "quota": {"max-queues": -1}})
    with pytest.raises(TenancyError):
        registry.define("t", {"vhosts": ["v"],
                              "quota": {"max-queues": True}})
    with pytest.raises(TenancyError):
        registry.define("t", {"vhosts": ["v"], "users": {"u": "pw"},
                              "acls": {"u": {"other-vh": ["read"]}}})
    with pytest.raises(TenancyError):
        registry.define("t", {"vhosts": ["v"], "users": {"u": "pw"},
                              "acls": {"u": {"v": ["admin"]}}})
    assert registry.tenants == {}

    # replacement keeps live state but adopts the new tables
    t1 = registry.define("t", {"vhosts": ["v"], "users": {"u": "pw"}})
    t1.published_folded = 7
    t2 = registry.define("t", {"vhosts": ["v", "v2"],
                               "quota": {"publish-rate": 1024}})
    assert t2 is t1
    assert t2.published_folded == 7
    assert t2.vhosts == ("v", "v2")
    assert registry.by_vhost["v2"] is t1
    assert registry.remove("t") and not registry.remove("t")
    assert registry.by_vhost == {} and registry.by_user == {}


# ---------------------------------------------------------------------------
# tenant-labeled observability surface
# ---------------------------------------------------------------------------


async def test_prometheus_tenant_series(stack):
    server, admin, registry = stack
    registry.define("acme", {"vhosts": ["acme-vh"],
                             "quota": {"publish-rate": 4096}})
    await server.broker.create_vhost("acme-vh")
    c = await AMQPClient.connect("127.0.0.1", server.bound_port,
                                 vhost="acme-vh")
    ch = await c.channel()
    await ch.confirm_select()
    await ch.queue_declare("pq")
    await ch.basic_publish_confirmed(b"x" * 64, routing_key="pq")

    status, text = await http_text(admin.bound_port, "/metrics")
    assert status == 200
    lines = text.splitlines()
    metrics = {}
    for line in lines:
        if line.startswith("#") or not line:
            continue
        name, _, value = line.rpartition(" ")
        metrics[name] = float(value)
    assert metrics["chanamq_tenancy_tenants"] == 1
    assert metrics['chanamq_tenant_connections{tenant="acme"}'] == 1
    assert metrics['chanamq_tenant_published{tenant="acme"}'] == 1
    assert metrics['chanamq_tenant_gated{tenant="acme"}'] == 0
    assert metrics['chanamq_tenant_tokens{tenant="acme"}'] <= 8192
    # queue series on a tenant-owned vhost carry the tenant label
    assert metrics[
        'chanamq_queue_messages{vhost="acme-vh",queue="pq",'
        'tenant="acme"}'] == 1
    await c.close()


async def test_timeseries_tenant_rows(stack):
    from chanamq_tpu_torch.telemetry import TelemetryService

    server, admin, registry = stack
    registry.define("acme", {"vhosts": ["acme-vh"]})
    svc = TelemetryService(server.broker, interval_s=3600.0)
    server.broker.telemetry = svc
    try:
        status, body = await http_req(
            admin.bound_port, "/admin/timeseries?scope=local")
        assert status == 200
        rows = body["nodes"][server.broker.trace_node]["tenants"]
        assert [r["name"] for r in rows] == ["acme"]
        assert rows[0]["vhosts"] == ["acme-vh"]
    finally:
        server.broker.telemetry = None
