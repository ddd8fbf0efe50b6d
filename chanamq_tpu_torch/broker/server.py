"""AMQP/AMQPS TCP listener.

Capability parity with the reference's transport extension + process entry
(chana-mq-base Amqp.scala:39-331 startServer/sslTlsStage; chana-mq-server
AMQPServer.scala:39-111): plain AMQP listener (5672), optional TLS listener
(5671), per-connection protocol engine instances, clean shutdown.

The port carries BrokerServer and from_config. The node entry points
(run_node, main) compose the admin REST, shard, cluster, federation,
telemetry, SLO, forecast, control and tenancy layers, which later slices
port; see ROADMAP.md.
"""

from __future__ import annotations

import asyncio
import logging
import ssl
from typing import Optional

from ..store.api import StoreService
from .broker import Broker
from .connection import AMQPConnection

log = logging.getLogger("chanamq.server")


class BrokerServer:
    def __init__(
        self,
        broker: Optional[Broker] = None,
        host: str = "0.0.0.0",
        port: int = 5672,
        *,
        tls_port: Optional[int] = None,
        ssl_context: Optional[ssl.SSLContext] = None,
        heartbeat_s: int = 30,
        frame_max: int = 131072,
        channel_max: int = 2047,
        store: Optional[StoreService] = None,
        max_connections: int = 0,
        backlog: int = 128,
        max_message_size: int = 128 * 1024 * 1024,
        users: "Optional[dict[str, str]]" = None,
        permissions: "Optional[dict[str, list[str]]]" = None,
        reuse_port: bool = False,
    ) -> None:
        self.broker = broker or Broker(store=store)
        self.host = host
        self.port = port
        self.tls_port = tls_port
        self.ssl_context = ssl_context
        self.heartbeat_s = heartbeat_s
        self.frame_max = frame_max
        self.channel_max = channel_max
        # listener resource limits (reference: ServerSettings
        # max-connections / backlog, Settings.scala:141-219); 0 = uncapped
        self.max_connections = max_connections
        self.backlog = backlog
        # optional SASL PLAIN verification: user -> password. None/empty
        # keeps the reference's behavior (parse but never verify,
        # SaslMechanism.scala:49-76); configuring users turns real
        # authentication on (EXCEEDS the reference, README "Status": auth
        # unimplemented there).
        self.users = users or None
        # per-user vhost allowlists (consulted only when users are set):
        # a user listed here may open ONLY those vhosts
        self.permissions = permissions or None
        self.max_message_size = max_message_size
        self.refused_connections = 0
        # sibling workers may share one AMQP port via SO_REUSEPORT
        self.reuse_port = reuse_port
        self._servers: list[asyncio.AbstractServer] = []
        self._connections: set[AMQPConnection] = set()

    async def start(self, *, listen: bool = True) -> None:
        """Start the broker and (by default) open the listeners. Pass
        listen=False to defer the listeners until other layers are live —
        run_node starts the cluster first so no client ever connects to a
        half-clustered node."""
        await self.broker.start()
        if listen:
            await self.start_listeners()

    async def start_listeners(self) -> None:
        kwargs: dict = {}
        if self.reuse_port:
            kwargs["reuse_port"] = True
        server = await asyncio.start_server(
            self._on_client, self.host, self.port, backlog=self.backlog,
            **kwargs)
        self._servers.append(server)
        log.info("AMQP listening on %s:%d%s", self.host, self.port,
                 " (reuse-port)" if self.reuse_port else "")
        if self.tls_port is not None and self.ssl_context is not None:
            tls_server = await asyncio.start_server(
                self._on_client, self.host, self.tls_port,
                ssl=self.ssl_context, backlog=self.backlog)
            self._servers.append(tls_server)
            log.info("AMQPS listening on %s:%d", self.host, self.tls_port)

    @property
    def bound_port(self) -> int:
        return self._servers[0].sockets[0].getsockname()[1]

    async def _on_client(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        if (self.max_connections
                and len(self._connections) >= self.max_connections):
            # refuse at accept: a TCP close before the protocol header is
            # the one refusal every client library understands at this
            # stage (Connection.Close can't be sent pre-Start). Existing
            # connections are untouched.
            self.refused_connections += 1
            self.broker.metrics.connections_refused += 1
            log.warning(
                "refusing connection: %d live >= max-connections %d",
                len(self._connections), self.max_connections)
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass
            return
        connection = AMQPConnection(
            self.broker, reader, writer,
            heartbeat_s=self.heartbeat_s, frame_max=self.frame_max,
            channel_max=self.channel_max,
            max_message_size=self.max_message_size,
            users=self.users,
            permissions=self.permissions,
        )
        self._connections.add(connection)
        try:
            await connection.serve()
        finally:
            self._connections.discard(connection)

    async def stop(self) -> None:
        for server in self._servers:
            server.close()
        # kick live connections first: in py3.12 Server.wait_closed() waits
        # for all connection handlers, which only finish once clients drop
        for connection in list(self._connections):
            connection.closing = True
            try:
                connection.writer.close()
            except Exception:
                pass
        # explicitly await per-connection teardown: a handler parked at the
        # memory gate wakes on its next bounded wait and must finish before
        # the loop goes away (Server.wait_closed alone doesn't guarantee it)
        if self._connections:
            await asyncio.gather(
                *(c.closed for c in list(self._connections)),
                return_exceptions=True)
        for server in self._servers:
            await server.wait_closed()
        self._servers.clear()
        await self.broker.stop()

    async def serve_forever(self) -> None:
        await self.start()
        try:
            await asyncio.Event().wait()
        finally:
            await self.stop()

    @classmethod
    def from_config(cls, config) -> "BrokerServer":
        """Build a server (broker + listeners) from a Config tree."""
        from ..config import Config

        assert isinstance(config, Config)
        store: Optional[StoreService] = None
        store_path = config.get("chana.mq.store.path")
        if store_path:
            if config.bool("chana.mq.wal.enabled"):
                from ..config import ConfigError

                # the WAL engine waits for the persistence slice
                raise ConfigError(
                    "chana.mq.wal.enabled is not ported yet: set it to "
                    "false to use the sqlite store alone")
            from ..store.sqlite import SqliteStore

            store = SqliteStore(
                store_path,
                synchronous=config.str("chana.mq.store.synchronous"))
        ssl_context = None
        tls_port = None
        if config.bool("chana.mq.amqp.amqps.enabled"):
            certfile = config.get("chana.mq.amqp.amqps.certfile")
            keyfile = config.get("chana.mq.amqp.amqps.keyfile")
            if not certfile:
                from ..config import ConfigError

                raise ConfigError(
                    "chana.mq.amqp.amqps.enabled is true but "
                    "chana.mq.amqp.amqps.certfile is not set")
            ssl_context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ssl_context.load_cert_chain(certfile, keyfile)
            tls_port = config.int("chana.mq.amqp.amqps.port")
        users = cls._config_users(config)
        heartbeat = config.duration_s("chana.mq.amqp.connection.heartbeat")
        sweep = config.duration_s("chana.mq.message.sweep-interval")
        low = config.size_bytes("chana.mq.memory.low-watermark")
        ack_timeout = config.duration_s("chana.mq.consumer.timeout")
        broker = Broker(
            store=store,
            message_sweep_interval_s=sweep if sweep is not None else 0.0,
            queue_max_resident=config.int("chana.mq.queue.max-resident"),
            memory_high_watermark=config.size_bytes(
                "chana.mq.memory.high-watermark") or 0,
            memory_low_watermark=low,
            consumer_timeout_ms=(
                int(ack_timeout * 1000) if ack_timeout else 0),
            store_max_bytes=config.size_bytes("chana.mq.store.max-bytes")
            or 0,
            stream_segment_bytes=config.size_bytes(
                "chana.mq.stream.segment-bytes") or (1 << 20),
            stream_segment_age_s=config.duration_s(
                "chana.mq.stream.segment-age") or 0.0,
            stream_cache_segments=config.int(
                "chana.mq.stream.cache-segments"),
            stream_delivery_batch=config.int(
                "chana.mq.stream.delivery-batch") or 128,
            # flow-control ladder (chana.mq.flow.*): thresholds default
            # off the memory watermarks; None keeps the derived defaults
            flow_page_watermark=config.size_bytes(
                "chana.mq.flow.page-watermark"),
            flow_cluster_watermark=config.size_bytes(
                "chana.mq.flow.cluster-watermark"),
            flow_refuse_watermark=config.size_bytes(
                "chana.mq.flow.refuse-watermark"),
            flow_hard_limit=config.size_bytes("chana.mq.flow.hard-limit"),
            flow_publish_credit=config.size_bytes(
                "chana.mq.flow.publish-credit") or 0,
            flow_consumer_buffer=config.size_bytes(
                "chana.mq.flow.consumer-buffer") or 0,
            park_buffer=config.size_bytes("chana.mq.flow.park-buffer"),
            flow_page_resident=config.int("chana.mq.flow.page-resident")
            or 0,
            router_enabled=config.bool("chana.mq.router.enabled"),
            router_backend=config.str("chana.mq.router.backend"),
            router_device=config.str("chana.mq.router.device"),
            router_min_batch=config.int("chana.mq.router.min-batch") or 16,
            router_max_wildcards=config.int(
                "chana.mq.router.max-wildcards") or 512,
            router_max_queues=config.int("chana.mq.router.max-queues")
            or 4096,
            router_verify=config.bool("chana.mq.router.verify"),
            semantics_enabled=config.bool("chana.mq.semantics.enabled"),
            delay_tick_ms=max(1, round((config.duration_s(
                "chana.mq.semantics.delay-tick") or 0.05) * 1000)),
            native_egress=config.bool("chana.mq.native.egress"),
            native_pool_buffers=config.int("chana.mq.native.pool-buffers")
            or 16,
            native_pool_buffer_kb=config.int("chana.mq.native.pool-buffer-kb")
            or 256,
        )
        if store is not None and hasattr(store, "metrics"):
            # the WAL engine's wal_* counters must land in the broker
            # registry (Prometheus / admin metrics), not a placeholder
            store.metrics = broker.metrics
        return cls(
            broker=broker,
            host=config.str("chana.mq.amqp.interface"),
            port=config.int("chana.mq.amqp.port"),
            tls_port=tls_port,
            ssl_context=ssl_context,
            # sub-second configs round up to 1s rather than silently disabling
            heartbeat_s=max(1, round(heartbeat)) if heartbeat else 0,
            frame_max=config.size_bytes("chana.mq.amqp.connection.frame-max"),
            channel_max=config.int("chana.mq.amqp.connection.channel-max"),
            max_connections=config.int("chana.mq.server.max-connections") or 0,
            backlog=config.int("chana.mq.server.backlog") or 128,
            max_message_size=config.size_bytes("chana.mq.message.max-size")
            or 0,
            users=users,
            permissions=cls._config_permissions(config, users),
        )

    @staticmethod
    def _config_users(config) -> Optional[dict]:
        """chana.mq.auth.users, validated fail-closed: a non-mapping value
        (malformed file/env) must error out, never silently disable auth."""
        users = config.get("chana.mq.auth.users")
        if users is None or users == {}:
            return None
        if not isinstance(users, dict) or not all(
            isinstance(k, str) and isinstance(v, str)
            for k, v in users.items()
        ):
            from ..config import ConfigError

            raise ConfigError(
                "chana.mq.auth.users must map user names to passwords")
        return users

    @staticmethod
    def _config_permissions(config, users: Optional[dict]) -> Optional[dict]:
        """chana.mq.auth.permissions, validated fail-closed like users:
        allowlists without a user table (or naming unknown users) would be
        silently unenforced, so both are boot errors."""
        perms = config.get("chana.mq.auth.permissions")
        if perms is None or perms == {}:
            return None
        from ..config import ConfigError

        ok = isinstance(perms, dict) and all(
            isinstance(k, str) and isinstance(v, list)
            and all(isinstance(x, str) for x in v)
            for k, v in perms.items()
        )
        if not ok:
            raise ConfigError(
                "chana.mq.auth.permissions must map user names to vhost lists")
        if users is None:
            raise ConfigError(
                "chana.mq.auth.permissions requires chana.mq.auth.users")
        unknown = sorted(set(perms) - set(users))
        if unknown:
            raise ConfigError(
                f"chana.mq.auth.permissions names unknown users: {unknown}")
        return perms
