"""fd-handoff fallback for platforms without SO_REUSEPORT.

The supervisor runs the one TCP listener (:class:`HandoffAcceptor`) and
ships each accepted client socket to a worker over that worker's
``handoff-<i>.sock`` feed using SCM_RIGHTS (``socket.send_fds``),
round-robin. The worker (:class:`HandoffReceiver`) adopts the
descriptor into its own event loop and hands the resulting stream pair
to the ordinary ``BrokerServer._on_client`` — above the accept, the
two listener modes are indistinguishable.
"""

from __future__ import annotations

import asyncio
import logging
import os
import socket
from typing import Optional

log = logging.getLogger("chanamq.shard.handoff")

_MAX_FDS_PER_MSG = 8


class HandoffReceiver:
    """Worker side: adopt client sockets pushed over the feed socket."""

    def __init__(self, server, path: str) -> None:
        self.server = server  # BrokerServer
        self.path = path
        self._listener: Optional[socket.socket] = None
        self._feeds: list[socket.socket] = []
        self._accept_task: Optional[asyncio.Task] = None
        self.adopted = 0

    async def start(self) -> None:
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass
        listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        listener.bind(self.path)
        listener.listen(4)
        listener.setblocking(False)
        self._listener = listener
        self._accept_task = asyncio.get_event_loop().create_task(
            self._accept_loop())
        log.info("fd-handoff feed listening at %s", self.path)

    async def _accept_loop(self) -> None:
        loop = asyncio.get_event_loop()
        assert self._listener is not None
        try:
            while True:
                feed, _addr = await loop.sock_accept(self._listener)
                feed.setblocking(False)
                self._feeds.append(feed)
                loop.add_reader(feed.fileno(), self._on_feed_readable, feed)
        except (asyncio.CancelledError, OSError):
            pass

    def _on_feed_readable(self, feed: socket.socket) -> None:
        loop = asyncio.get_event_loop()
        try:
            msg, fds, _flags, _addr = socket.recv_fds(
                feed, 64, _MAX_FDS_PER_MSG)
        except BlockingIOError:
            return
        except OSError:
            msg, fds = b"", []
        if not msg and not fds:
            # supervisor went away: drop this feed (a respawned
            # supervisor reconnects)
            try:
                loop.remove_reader(feed.fileno())
            except (OSError, ValueError):
                pass
            if feed in self._feeds:
                self._feeds.remove(feed)
            feed.close()
            return
        for fd in fds:
            self._adopt(fd)

    def _adopt(self, fd: int) -> None:
        loop = asyncio.get_event_loop()
        sock = socket.socket(fileno=fd)
        sock.setblocking(False)
        self.adopted += 1
        reader = asyncio.StreamReader(loop=loop)

        def _connected(r: asyncio.StreamReader,
                       w: asyncio.StreamWriter) -> None:
            loop.create_task(self.server._on_client(r, w))

        protocol = asyncio.StreamReaderProtocol(reader, _connected, loop=loop)

        async def _attach() -> None:
            try:
                await loop.connect_accepted_socket(lambda: protocol, sock)
            except OSError as exc:
                log.warning("adopting handed-off fd failed: %r", exc)
                sock.close()

        loop.create_task(_attach())

    async def stop(self) -> None:
        if self._accept_task is not None:
            self._accept_task.cancel()
            self._accept_task = None
        loop = asyncio.get_event_loop()
        for feed in self._feeds:
            try:
                loop.remove_reader(feed.fileno())
            except (OSError, ValueError):
                pass
            feed.close()
        self._feeds.clear()
        if self._listener is not None:
            self._listener.close()
            self._listener = None
        try:
            os.unlink(self.path)
        except OSError:
            pass


class HandoffAcceptor:
    """Supervisor side: the single TCP accept loop."""

    def __init__(self, host: str, port: int, worker_paths: list[str],
                 *, backlog: int = 128) -> None:
        self.host = host
        self.port = port
        self.worker_paths = list(worker_paths)
        self.backlog = backlog
        self._server: Optional[asyncio.AbstractServer] = None
        self._feeds: dict[str, socket.socket] = {}
        self._next = 0
        self.dispatched = 0
        self.dropped = 0

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_client, self.host, self.port, backlog=self.backlog)
        log.info("handoff acceptor on %s:%d -> %d workers",
                 self.host, self.port, len(self.worker_paths))

    @property
    def bound_port(self) -> int:
        assert self._server is not None
        return self._server.sockets[0].getsockname()[1]

    def _feed(self, path: str) -> socket.socket:
        feed = self._feeds.get(path)
        if feed is None:
            feed = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            feed.connect(path)  # local, small: blocking connect is fine
            self._feeds[path] = feed
        return feed

    async def _on_client(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        sock = writer.get_extra_info("socket")
        if sock is None:
            writer.close()
            return
        fd = sock.fileno()
        # round-robin with failover: a worker mid-restart is skipped
        for attempt in range(len(self.worker_paths)):
            path = self.worker_paths[self._next % len(self.worker_paths)]
            self._next += 1
            try:
                socket.send_fds(self._feed(path), [b"c"], [fd])
            except OSError:
                stale = self._feeds.pop(path, None)
                if stale is not None:
                    stale.close()
                continue
            self.dispatched += 1
            break
        else:
            self.dropped += 1
            log.warning("no worker reachable; dropping client")
        # SCM_RIGHTS duplicated the descriptor into the worker (or the
        # client is being refused): the local copy closes either way
        writer.close()

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        for feed in self._feeds.values():
            feed.close()
        self._feeds.clear()
