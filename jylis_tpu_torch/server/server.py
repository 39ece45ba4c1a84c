"""RESP TCP server: the client API endpoint.

The port of the Python dispatch path of jylis_tpu/server/server.py
(reference analog: server.pony + server_notify.pony): accept clients on
config.port, feed their bytes through the incremental RESP parser, route
complete commands into Database.apply_async, and on protocol errors
reply with an error and drop the connection (server_notify.pony:19-22).

Concurrency model: the asyncio loop replaces the per-connection Pony
actors. Device-bound work runs in a worker thread under a per-repo lock
(models/manager.py), so a slow drain stalls no other connection. Within
one connection commands complete strictly in order (RESP replies must
match request order), which each connection's sequential await
provides.
"""

from __future__ import annotations

import asyncio
import socket

from .resp import Respond, RespError, RespParser


class Server:
    def __init__(self, config, database):
        self._config = config
        self._database = database
        self._log = config.log
        self._server: asyncio.base_events.Server | None = None
        self._conns: set[asyncio.StreamWriter] = set()
        self._closing = False

    async def start(self) -> None:
        try:
            self._server = await asyncio.start_server(
                self._handle_client, host=None, port=int(self._config.port)
            )
        except OSError as e:
            self._log.err() and self._log.e(f"server listen failed: {e}")
            raise
        self._log.info() and self._log.i("server listen ready")

    @property
    def port(self) -> int:
        """The listening port, preferring the IPv4 socket: with port 0
        each address family gets its own ephemeral port, and loopback
        clients dial 127.0.0.1."""
        assert self._server is not None
        for sock in self._server.sockets:
            if sock.family == socket.AF_INET:
                return sock.getsockname()[1]
        return self._server.sockets[0].getsockname()[1]

    async def _handle_client(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        if self._closing:
            # accepted just before dispose: the close loop could not see
            # this writer yet, and wait_closed would wait on it forever
            writer.close()
            return
        parser = RespParser()
        # replies buffer here and flush once per parsed batch (bounded
        # below): a write() per reply would be one tiny TCP segment per
        # command on a pipelined burst
        out = bytearray()
        resp = Respond(out.extend)

        def flush(bound: int = 0) -> None:
            if len(out) > bound:
                writer.write(bytes(out))
                out.clear()

        self._conns.add(writer)
        try:
            while True:
                data = await reader.read(1 << 16)
                if not data:
                    break
                parser.append(data)
                try:
                    for cmd in parser:
                        await self._database.apply_async(resp, cmd)
                        flush(1 << 16)  # bound the reply buffer mid-burst
                except RespError as e:
                    resp.err(str(e))
                    flush()
                    break
                flush()
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError, asyncio.CancelledError):
            pass
        finally:
            self._conns.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def dispose(self) -> None:
        """Stop listening and close client connections (the reference
        stops its listener and lets process exit end connections,
        server.pony:16-20)."""
        self._closing = True  # handlers not yet in _conns self-close
        if self._server is not None:
            self._server.close()
            for w in list(self._conns):
                w.close()
            await self._server.wait_closed()
