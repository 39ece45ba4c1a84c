"""RESP TCP server: the client API endpoint.

The port of jylis_tpu/server/server.py (reference analog: server.pony +
server_notify.pony): accept clients on config.port, feed their bytes to
the node's serving engine or the incremental RESP parser, and on
protocol errors reply with an error and drop the connection
(server_notify.pony:19-22).

The native burst path (``_apply_native``, JAX server.py:290-390): on a
node with a native engine (``Database(engine="auto")``) a connection's
bytes go whole to ``ServeEngine.scan_apply``, which settles every
GCOUNT/PNCOUNT/TREG/TLOG/UJSON command it can in C++ under the five
engine-backed repo locks; a command it defers (rc 1: a read that must
drain, a type it does not serve, SYSTEM, ...) runs through
Database.apply_async in order. A connection demotes to the Python path
for the rest of its life on malformed input (rc -1), an oversized
command (rc -2), a FaultError at ``native.scan_apply`` or shutdown;
demotions are counted in SYSTEM METRICS' SERVING lines. A burst arriving
while a threaded drain holds one of those locks goes through the Python
parser and the per-repo path instead, so unrelated repos never wait on
the engine's lock boundary.

The admission layer (JAX :192-270, :363-380): every Python-path command
passes ``_dispatch_py``'s gate when the node's ``AdmissionController``
is armed (a policy, or the queued-bytes bound, on by default): it is
classified (admission.classify), the ``admission.shed`` failpoint and
the overload state decide, and a refused command gets the typed BUSY
reply before it costs a session flush, a repo lock or a drain. The
burst path bounds the node-wide reply bytes parked on slow consumers
(``--admission-queue-bytes``): past the bound it waits on this
connection's ``drain()``. The serving pipeline's seams are JAX's
(``pipeline.accept``, ``.read``, ``.parse``, ``.classify``,
``.dispatch``, ``.reply_write``), recorded where JAX records them. With
``lanes > 1`` every lane binds the same port with ``SO_REUSEPORT`` and
the kernel shares the accepted connections among them.

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
import time

from .. import admission as admission_mod
from .. import faults
from ..native.resp import make_parser
from .resp import Respond, RespError


class Server:
    def __init__(self, config, database):
        self._config = config
        self._database = database
        self._log = config.log
        self._server: asyncio.base_events.Server | None = None
        self._conns: set[asyncio.StreamWriter] = set()
        self._closing = False
        # dispatch-latency seams (obs/): one native burst (one scan_apply
        # settling many commands) vs one Python-path dispatch; the
        # pipeline's dispatch stage reuses those elapsed times
        self._reg = database.metrics
        self._h_burst = self._reg.hist("server.native_burst")
        self._h_py = self._reg.hist("server.py_dispatch")
        # the serving pipeline's per-stage timers: accept (one sample a
        # connection), read (one socket read await, client idle
        # included), parse (one Python-path command), classify (the
        # admission gate, armed nodes only), dispatch, reply_write (one
        # buffered write to the transport)
        self._h_accept = self._reg.hist("pipeline.accept")
        self._h_read = self._reg.hist("pipeline.read")
        self._h_parse = self._reg.hist("pipeline.parse")
        self._h_classify = self._reg.hist("pipeline.classify")
        self._h_dispatch = self._reg.hist("pipeline.dispatch")
        self._h_reply_write = self._reg.hist("pipeline.reply_write")

    async def start(self) -> None:
        try:
            if getattr(self._config, "lanes", 1) > 1:
                # multi-lane serving: every lane binds the same port with
                # SO_REUSEPORT and the kernel shards accepted connections
                # across the lane processes (IPv4 only in this mode)
                sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
                sock.bind(("0.0.0.0", int(self._config.port)))
                self._server = await asyncio.start_server(
                    self._handle_client, sock=sock
                )
            else:
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
        reg = self._reg
        t_acc = time.perf_counter() if reg.enabled else 0.0
        engine = self._database.native_engine
        parser = make_parser(engine)
        # Python-path replies buffer here and flush once per parsed batch
        # (bounded below): a write() per reply would be one tiny TCP
        # segment per command. The engine's replies arrive pre-batched;
        # flush() runs before every direct engine write, so the reply
        # stream keeps command order across the two paths
        out = bytearray()
        resp = Respond(out.extend)

        def flush(bound: int = 0) -> None:
            if len(out) > bound:
                t_w = time.perf_counter() if reg.enabled else 0.0
                writer.write(bytes(out))
                if t_w:
                    self._h_reply_write.record(time.perf_counter() - t_w)
                out.clear()

        use_native = engine is not None
        buf = bytearray()
        self._conns.add(writer)
        try:
            adm_armed = self._database.admission.armed
            if t_acc:
                self._h_accept.record(time.perf_counter() - t_acc)
            while True:
                t_rd = time.perf_counter() if reg.enabled else 0.0
                data = await reader.read(1 << 16)
                if t_rd:
                    self._h_read.record(time.perf_counter() - t_rd)
                if not data:
                    break
                # the overload signal's arrival stamp: queue time for
                # every command in this chunk runs from this read
                t_arr = time.perf_counter() if adm_armed else 0.0
                if use_native:
                    go_native = not any(m.busy() for m in self._engine_managers())
                    if go_native and parser.has_pending():
                        # an earlier burst went through the Python parser
                        # and left a split command's head behind: reclaim
                        # it so the stream returns to the engine
                        tail = parser.take_tail()
                        if tail is None:
                            go_native = False  # malformed or unserved: stay
                        else:
                            buf += tail
                    if not go_native:
                        # a drain holds an engine repo's lock: route THIS
                        # burst through the per-repo Python path
                        parser.append(bytes(buf))
                        buf.clear()
                    else:
                        buf += data
                        use_native = await self._apply_native(
                            engine, buf, parser, resp, flush, writer, out,
                            t_arr,
                        )
                        if use_native:
                            flush()
                            await writer.drain()
                            continue
                        data = b""  # demoted: the tail is in the parser
                parser.append(data)
                try:
                    # each Python-path command's parse timed on its own;
                    # a RespError propagates as from a for loop
                    it = iter(parser)
                    while True:
                        t_ps = time.perf_counter() if reg.enabled else 0.0
                        cmd = next(it, None)
                        if t_ps:
                            self._h_parse.record(time.perf_counter() - t_ps)
                        if cmd is None:
                            break
                        await self._dispatch_py(resp, cmd, writer, out, t_arr)
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
            self._database.admission.drop_conn(id(writer))
            self._conns.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _dispatch_py(self, resp, cmd, writer, out, t_arr=0.0) -> None:
        """One Python-path dispatch (a demoted connection's commands and
        the engine's deferred ones), behind the admission gate when it is
        armed: the command is classified (SESSION WRAP/READ take their
        inner command's class), this connection's queued reply bytes are
        refreshed, and it is refused up front with a typed BUSY (a
        retry-after hint included) or dispatched and fed to the overload
        state machine. ``t_arr`` stamps the socket read that brought the
        command's chunk: the latency the state machine sees runs from
        there, so it counts the time the command queued in this
        connection's parsed burst. Unarmed costs two attribute reads."""
        adm = self._database.admission
        if adm.armed:
            adm.note_conn_queued(
                id(writer),
                writer.transport.get_write_buffer_size() + len(out),
            )
            t_cl = time.perf_counter() if self._reg.enabled else 0.0
            cls = admission_mod.classify(cmd)
            hint = await admission_mod.gate(adm, cls)
            if t_cl:
                self._h_classify.record(time.perf_counter() - t_cl)
            if hint is not None:
                resp.err(
                    admission_mod.busy_reply(
                        cls, hint, "node is shedding this class"
                    )
                )
                # the refusal path's only await: a backlogged chunk of
                # shed commands must not run as one synchronous slab
                # that stalls every other connection
                await asyncio.sleep(0)
                return
            t0 = time.perf_counter()
            await self._database.apply_async(resp, cmd)
            t1 = time.perf_counter()
            adm.done(cls, t1 - (t_arr or t0))
            if self._reg.enabled:
                self._h_py.record(t1 - t0)
                self._h_dispatch.record(t1 - t0)
            return
        t0 = time.perf_counter() if self._reg.enabled else 0.0
        await self._database.apply_async(resp, cmd)
        if t0:
            el = time.perf_counter() - t0
            self._h_py.record(el)
            self._h_dispatch.record(el)

    # the engine's changed-counter order (serve_engine.cpp scan_apply2)
    _ENGINE_TYPES = ("GCOUNT", "PNCOUNT", "TREG", "TLOG", "UJSON")

    def _engine_managers(self):
        return [self._database.manager(n) for n in self._ENGINE_TYPES]

    async def _apply_native(self, engine, buf, parser, resp, flush, writer,
                            out, t_arr=0.0) -> bool:
        """Drain ``buf`` through the native serving engine; commands it
        cannot settle go through the per-repo async path in order
        (``resp`` buffers their replies; ``flush`` pushes them before the
        engine's next direct write). Returns True (stay native) or False
        (demote this connection to the Python path; the tail is moved
        into ``parser``, whose oracle then renders a malformed input's
        specific error before the connection drops)."""
        mgrs = self._engine_managers()

        def demote() -> bool:
            self._reg.note_serving("demotions")
            self._reg.trace_event("server", "demote")
            parser.append(bytes(buf))
            buf.clear()
            return False

        while True:
            if any(m._shutdown for m in mgrs):
                return demote()
            # all five engine tables can change inside one native call:
            # hold every engine-backed repo lock, the boundary apply_async
            # keeps per repo. The order is the DATABASE MAP's (TREG, TLOG,
            # GCOUNT, PNCOUNT, UJSON), the order every multi-lock holder
            # takes, so a shutdown can never deadlock against a burst
            async with mgrs[2].locked("native"), mgrs[3].locked("native"), \
                    mgrs[0].locked("native"), mgrs[1].locked("native"), \
                    mgrs[4].locked("native"):
                try:
                    # a failure at the FFI burst boundary demotes this
                    # connection to the Python oracle path, never kills
                    # it; the ASYNC point, so an injected sleep slows this
                    # connection and not the whole loop
                    await faults.async_point("native.scan_apply")
                    t0 = time.perf_counter() if self._reg.enabled else 0.0
                    rc, consumed, replies, unhandled, changed = engine.scan_apply(buf)
                    if t0:
                        el = time.perf_counter() - t0
                        self._h_burst.record(el)
                        self._h_dispatch.record(el)
                except faults.FaultError:
                    return demote()
                if replies:
                    flush()  # deferred-command replies precede these
                    t_w = time.perf_counter() if self._reg.enabled else 0.0
                    writer.write(replies)
                    if t_w:
                        self._h_reply_write.record(time.perf_counter() - t_w)
                for mgr, ch in zip(mgrs, changed):
                    if ch:
                        mgr._maybe_proactive_flush()
            del buf[:consumed]
            # slow-consumer hard bound (--admission-queue-bytes): engine
            # replies land straight in the transport buffer; past the
            # node-wide cap, drain() parks only this connection until
            # its consumer catches up, outside the repo locks
            adm = self._database.admission
            if adm.queue_bytes_cap:
                adm.note_conn_queued(
                    id(writer), writer.transport.get_write_buffer_size()
                )
                if adm.queued_bytes > adm.queue_bytes_cap:
                    await writer.drain()
                    adm.note_conn_queued(
                        id(writer), writer.transport.get_write_buffer_size()
                    )
            if rc == 1:  # one command for the Python path, in order
                await self._dispatch_py(resp, unhandled, writer, out, t_arr)
                # a run of deferring reads makes no engine write to ride
                # on: bound the buffer here as the demoted loop does
                flush(1 << 16)
                continue
            if rc == 2:  # the engine's reply buffer filled: keep going
                continue
            if rc < 0:
                # rc -1: malformed input (the Python parser renders the
                # specific error and drops the connection); rc -2: an
                # oversized command (Python serves this connection on)
                return demote()
            return True  # rc 0: every complete command consumed

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
