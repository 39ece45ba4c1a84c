"""Synchronous Python clients for jylis-tpu.

The port's copy of jylis_tpu/client.py, whole: it speaks RESP2 to any
node, a port node or a JAX node alike, and routes by the port's own
``admission`` classifier and ``sessions`` token codec.

The server speaks RESP2, so any Redis client works against it
(docs/_docs/start/connect.md:10-14 is the reference's compatibility
contract, exercised by tests/test_client_conformance.py) — this module
is the zero-dependency in-repo client used by the smoke tooling
(scripts/smoke3.py), the conformance tests, and anyone who wants to
talk to a node without installing redis-py.

Two layers:

* :class:`Client` — one buffered connection to one node, commands in /
  replies out, nothing clever. Wire behavior matches redis-py where it
  matters: commands are packed as RESP arrays of bulk strings; replies
  parse to bytes (+simple, $bulk), int (:n), None ($-1 / *-1), list
  (*n, recursive), and error replies raise (or, in pipelines and
  nested array elements, return) ResponseError.
* :class:`ClusterClient` — the cluster-aware library (docs/client.md):
  discovers topology and regions via ``SYSTEM TOPOLOGY``, routes to
  the nearest replica (region match first), auto-threads SESSION
  tokens (writes wrap in ``SESSION WRAP``, reads present the joined
  token via ``SESSION READ``), honors typed BUSY retry-after hints
  with jittered exponential backoff, retries STALE where it wrote and
  resets on BADTOKEN, and fails over on dead nodes — recording the
  client-observed MTTR (first failure to first served command through
  a survivor) in ``stats["last_mttr_s"]``.
"""

from __future__ import annotations

import random
import re
import socket
import time


class ResponseError(Exception):
    """An -error reply from the server (the connection stays usable)."""


class ClusterError(Exception):
    """ClusterClient gave up: every endpoint dead, or an operation
    exhausted its retry budget. ``last`` carries the final underlying
    failure when there was one."""

    def __init__(self, msg: str, last: Exception | None = None):
        super().__init__(msg)
        self.last = last


def pack_command(*args) -> bytes:
    """One command as a RESP array of bulk strings (str/bytes/int args)."""
    out = b"*%d\r\n" % len(args)
    for a in args:
        if isinstance(a, str):
            a = a.encode()
        elif isinstance(a, int):
            a = b"%d" % a
        out += b"$%d\r\n%s\r\n" % (len(a), a)
    return out


class Client:
    """A buffered connection to one node.

    Replies are parsed frame-exactly (a reply split across TCP segments
    can never desync the stream). Not thread-safe; one Client per
    connection."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.settimeout(timeout)
        self.buf = b""

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self) -> "Client":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- reply parsing ----------------------------------------------------
    def _fill(self) -> None:
        chunk = self.sock.recv(1 << 16)
        if not chunk:
            raise RuntimeError("connection closed by server")
        self.buf += chunk

    def _line(self) -> bytes:
        while b"\r\n" not in self.buf:
            self._fill()
        line, self.buf = self.buf.split(b"\r\n", 1)
        return line

    def read_reply(self, _nested: bool = False):
        """Consume and decode exactly one reply from the stream.

        A top-level error reply raises; an error ELEMENT inside an
        array (e.g. the inner reply of a SESSION WRAP whose wrapped
        command failed) is returned as a ResponseError OBJECT in the
        list — raising mid-array would leave the remaining elements
        unconsumed and desync every later reply on the connection."""
        line = self._line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest
        if kind == b"-":
            if _nested:
                return ResponseError(rest.decode())
            raise ResponseError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n < 0:
                return None
            while len(self.buf) < n + 2:
                self._fill()
            out, self.buf = self.buf[:n], self.buf[n + 2 :]
            return out
        if kind == b"*":
            n = int(rest)
            if n < 0:
                return None
            return [self.read_reply(_nested=True) for _ in range(n)]
        raise RuntimeError(f"unparseable reply line: {line!r}")

    # -- commands ---------------------------------------------------------
    def execute_command(self, *args):
        self.sock.sendall(pack_command(*args))
        return self.read_reply()

    def pipeline_execute(self, commands):
        """redis-py Pipeline.execute(raise_on_error=False) semantics: one
        write carrying every command, then the replies in order, with
        error replies as ResponseError OBJECTS in the result list."""
        self.sock.sendall(b"".join(pack_command(*c) for c in commands))
        out = []
        for _ in commands:
            try:
                out.append(self.read_reply())
            except ResponseError as e:
                out.append(e)
        return out

    def send_raw(self, data: bytes) -> None:
        """Raw bytes on the wire (inline commands, tests)."""
        self.sock.sendall(data)


# ---- the cluster-aware client (docs/client.md) ----------------------------

# the machine-readable field of a typed BUSY refusal (admission.py
# busy_reply); everything else in the message is operator-facing
_RETRY_AFTER = re.compile(r"retry-after-ms=(\d+)")

# how long a connection-level failure keeps an endpoint off the
# preference list before it is probed again
_DEAD_SECS = 2.0


def _as_bytes(a) -> bytes:
    if isinstance(a, bytes):
        return a
    if isinstance(a, int):
        return b"%d" % a
    return str(a).encode()


class ClusterClient:
    """A failover client over a set of node endpoints.

    ``endpoints`` is a list of ``(host, port)`` RESP endpoints (any
    subset of the cluster; discovery fills in awareness of the rest).
    ``region`` biases routing: endpoints whose node advertises the same
    region are preferred — "nearest replica" by the operator's own
    region taxonomy, no latency probing. All operations are
    synchronous and retry internally; connection-level failures mark
    the endpoint dead for a short window and fail over to the next
    preferred endpoint, recording the client-observed MTTR.

    Session guarantees ride automatically: ``write()`` wraps in
    ``SESSION WRAP`` and folds the returned token into the client's
    running token (a JOIN, so the token stays monotone even across a
    failover to a replica that has seen less); ``read()`` presents the
    token via ``SESSION READ`` and folds the reply token back in.

    ``sleep_fn`` / ``rng`` / ``clock`` are injectable for tests — the
    default rng is seeded so backoff sequences replay."""

    def __init__(
        self,
        endpoints,
        region: str = "",
        timeout: float = 5.0,
        max_retries: int = 8,
        backoff_base_ms: float = 25.0,
        backoff_cap_ms: float = 1000.0,
        rediscover_every: int = 256,
        rng=None,
        sleep_fn=None,
        clock=None,
    ):
        self.endpoints = [(h, int(p)) for h, p in endpoints]
        if not self.endpoints:
            raise ValueError("ClusterClient needs at least one endpoint")
        self.region = region
        self.timeout = timeout
        self.max_retries = max_retries
        self.backoff_base_ms = backoff_base_ms
        self.backoff_cap_ms = backoff_cap_ms
        self.rediscover_every = rediscover_every
        self._rng = rng if rng is not None else random.Random(0xC11E27)
        self._sleep = sleep_fn if sleep_fn is not None else time.sleep
        self._clock = clock if clock is not None else time.monotonic
        self._conn: Client | None = None
        self._ep: tuple[str, int] | None = None  # endpoint of _conn
        self._write_ep: tuple[str, int] | None = None  # last write target
        self._dead: dict[tuple[str, int], float] = {}  # ep -> dead-until
        # discovery state: per-endpoint self-view and the member map
        # (advertised addr -> {"region", "live"}) folded from every
        # reachable endpoint's SYSTEM TOPOLOGY
        self.nodes: dict[tuple[str, int], dict] = {}
        self.members: dict[str, dict] = {}
        self.token: bytes | None = None
        self._ops = 0
        self.stats = {
            "retries": 0,
            "busy_backoffs": 0,
            "stale_retries": 0,
            "badtoken_resets": 0,
            "failovers": 0,
            "rediscoveries": 0,
            "last_mttr_s": 0.0,
        }

    # ---- lifecycle / discovery -------------------------------------------

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None
            self._ep = None

    def __enter__(self) -> "ClusterClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def discover(self) -> None:
        """Poll ``SYSTEM TOPOLOGY`` on every non-dead endpoint and fold
        the answers: each endpoint's own line maps it to a cluster
        identity + region; the peer lines build the member map (with
        each observer's liveness evidence — any observer calling an
        address live keeps it live here). A node that left shows up as
        live 0 (or drops out of the map once evicted), which demotes
        its endpoint in routing."""
        self.stats["rediscoveries"] += 1
        members: dict[str, dict] = {}
        now = self._clock()
        for ep in self.endpoints:
            if self._dead.get(ep, 0.0) > now:
                continue
            # probe on a short-lived connection unless this endpoint is
            # the sticky one — discovery must not churn a healthy route
            probe = None
            try:
                if ep == self._ep and self._conn is not None:
                    c = self._conn
                else:
                    probe = c = Client(ep[0], ep[1], timeout=self.timeout)
                lines = c.execute_command("SYSTEM", "TOPOLOGY")
            except (OSError, RuntimeError, ResponseError):
                self._mark_dead(ep)
                continue
            finally:
                if probe is not None:
                    probe.close()
            if not isinstance(lines, list):
                continue
            for raw in lines:
                parts = (
                    raw.split() if isinstance(raw, bytes) else []
                )
                if len(parts) >= 8 and parts[0] == b"self":
                    info = {
                        "addr": parts[1].decode(),
                        "region": parts[3].decode(),
                        "bridge": parts[5] == b"1",
                        "resp_port": int(parts[7]),
                    }
                    self.nodes[ep] = info
                    m = members.setdefault(
                        info["addr"], {"region": info["region"], "live": 1}
                    )
                    m["live"] = 1
                elif len(parts) >= 6 and parts[0] == b"node":
                    addr = parts[1].decode()
                    live = 1 if parts[5] == b"1" else 0
                    m = members.setdefault(
                        addr, {"region": parts[3].decode(), "live": live}
                    )
                    m["live"] = max(m["live"], live)
        if members:
            self.members = members

    def _client_for(self, ep) -> Client:
        if self._ep == ep and self._conn is not None:
            return self._conn
        return self._connect(ep)

    def _connect(self, ep) -> Client:
        c = Client(ep[0], ep[1], timeout=self.timeout)
        if self._conn is not None and self._ep != ep:
            self._conn.close()
        self._conn, self._ep = c, ep
        return c

    def _mark_dead(self, ep) -> None:
        self._dead[ep] = self._clock() + _DEAD_SECS
        if self._ep == ep:
            self.close()

    def _preferred(self) -> list[tuple[str, int]]:
        """Routing order: live endpoints before dead-listed ones;
        within each group, region matches first, then the rest; the
        current connection stays sticky at the front of its group so a
        healthy route is never churned."""
        now = self._clock()

        def key(ep):
            dead = 1 if self._dead.get(ep, 0.0) > now else 0
            info = self.nodes.get(ep)
            near = 0 if (
                self.region and info and info.get("region") == self.region
            ) else 1
            sticky = 0 if ep == self._ep else 1
            # a member our discovery saw leave (live 0) routes last
            # within its group
            left = 0
            if info is not None:
                m = self.members.get(info.get("addr", ""), None)
                if m is not None and not m.get("live", 1):
                    left = 1
            return (dead, left, near, sticky)

        return sorted(self.endpoints, key=key)

    # ---- the operation surface -------------------------------------------

    def write(self, *args):
        """Apply a write with the session token threaded: the command
        wraps in SESSION WRAP, and the reply token joins into the
        client's running token BEFORE any inner error is raised — a
        refused inner command must not strand the mint."""
        return self._call(list(args), is_read=False)

    def read(self, *args):
        """A read honoring the session guarantee when a token is held
        (SESSION READ <token> <cmd>); a plain command otherwise."""
        return self._call(list(args), is_read=True)

    def execute(self, *args):
        """Route by command class (admission.py's classifier, the same
        taxonomy the server sheds by): read-shaped commands go through
        read(), everything else through write()."""
        from .admission import READ as _READ
        from .admission import classify

        cmd = [_as_bytes(a) for a in args]
        if classify(cmd) == _READ:
            return self.read(*args)
        return self._call(list(args), is_read=False)

    # ---- the retry/failover engine ---------------------------------------

    def _build(self, args: list, is_read: bool, use_token: bool):
        if is_read:
            if use_token and self.token is not None:
                return ["SESSION", "READ", self.token, *args], True
            return list(args), False
        return ["SESSION", "WRAP", *args], True

    def _merge_token(self, tok) -> None:
        if not isinstance(tok, (bytes, bytearray)):
            return
        tok = bytes(tok)
        if self.token is None:
            self.token = tok
            return
        if tok == self.token:
            return
        # join, not replace: after a failover the survivor's token may
        # not dominate what the dead node already acked — monotonicity
        # of the client's guarantee is the client's job
        from . import sessions as sessions_mod

        try:
            a = sessions_mod.decode_token(self.token)
            b = sessions_mod.decode_token(tok)
            self.token = sessions_mod.encode_token(
                sessions_mod.join_vec(a, b)
            )
        except sessions_mod.SessionError:
            self.token = tok

    def _backoff(self, attempt: int, hint_ms: float) -> None:
        """Jittered exponential backoff honoring the server's
        retry-after hint: the hint is the floor of the first wait,
        doubling per attempt up to the cap, with half-to-full jitter so
        a shed herd does not re-arrive in phase."""
        base = max(hint_ms, self.backoff_base_ms) * (2.0 ** attempt)
        base = min(base, self.backoff_cap_ms)
        self._sleep(base * (0.5 + self._rng.random() * 0.5) / 1000.0)

    def _call(self, args: list, is_read: bool):
        self._ops += 1
        if self._ops % self.rediscover_every == 1 and (
            self._ops == 1 or self.rediscover_every > 1
        ):
            self.discover()
        use_token = True
        t_fail: float | None = None
        busy_attempt = 0
        last_exc: Exception | None = None
        for _ in range(self.max_retries + 1):
            ep = None
            for cand in self._preferred():
                ep = cand
                break
            try:
                c = self._client_for(ep)
                cmd, wrapped = self._build(args, is_read, use_token)
                reply = c.execute_command(*cmd)
            except ResponseError as e:
                msg = str(e)
                if msg.startswith("BUSY"):
                    self.stats["busy_backoffs"] += 1
                    m = _RETRY_AFTER.search(msg)
                    hint = float(m.group(1)) if m else self.backoff_base_ms
                    self._backoff(busy_attempt, hint)
                    busy_attempt += 1
                    last_exc = e
                    continue
                if msg.startswith("STALE") and is_read:
                    # the guarantee's typed refusal: read where we
                    # wrote if that is somewhere else, otherwise let
                    # the replica catch up and re-present the token
                    self.stats["stale_retries"] += 1
                    if (
                        self._write_ep is not None
                        and self._write_ep != ep
                        and self._dead.get(self._write_ep, 0.0)
                        <= self._clock()
                    ):
                        self._connect(self._write_ep)
                    else:
                        self._backoff(0, self.backoff_base_ms)
                    last_exc = e
                    continue
                if msg.startswith("BADTOKEN"):
                    # unusable token (corrupt, or a format from a
                    # different build): drop it and run without the
                    # guarantee; the next write mints a fresh one
                    self.stats["badtoken_resets"] += 1
                    self.token = None
                    use_token = False
                    last_exc = e
                    continue
                raise  # a genuine command error: the caller's problem
            except (OSError, RuntimeError) as e:
                # connection-level failure: start (or continue) the
                # MTTR clock, dead-list the endpoint, fail over
                if t_fail is None:
                    t_fail = self._clock()
                self.stats["failovers"] += 1
                self.stats["retries"] += 1
                self._mark_dead(ep)
                self.discover()
                last_exc = e
                continue
            # success: settle MTTR, unwrap session framing
            if t_fail is not None:
                self.stats["last_mttr_s"] = self._clock() - t_fail
                t_fail = None
            if not is_read:
                self._write_ep = ep
            if wrapped and isinstance(reply, list) and len(reply) == 2:
                if is_read:
                    token, inner = reply[0], reply[1]
                else:
                    inner, token = reply[0], reply[1]
                self._merge_token(token)
                if isinstance(inner, ResponseError):
                    raise inner
                return inner
            return reply
        raise ClusterError(
            f"operation failed after {self.max_retries + 1} attempts "
            f"({type(last_exc).__name__ if last_exc else 'no endpoint'}: "
            f"{last_exc})",
            last=last_exc,
        )
