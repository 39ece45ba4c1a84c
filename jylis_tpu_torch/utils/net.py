"""Small shared networking helpers.

The port's copy of jylis_tpu/utils/net.py, plus ``listen_port``.
"""

from __future__ import annotations

import random
import socket


def free_port() -> int:
    """Reserve-and-release an ephemeral loopback port (the lane
    supervisor's bus/metrics port picks, bench spawns). The tiny race
    — another process binding it before the intended owner does — is
    the standard trade every spawning test in this repo already
    makes."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _ephemeral_low() -> int:
    """The first port of the host's ephemeral range (Linux's default
    32768 where the range cannot be read)."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range", encoding="ascii") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def listen_port(avoid=()) -> int:
    """A port, free on every interface now, for a listener that closes
    and binds again (a lane's bus and metrics ports across a respawn):
    below the host's ephemeral range, so while it is closed no outgoing
    connection can be given it as its local port (a freed ephemeral port
    can be, and then the respawned listener fails to bind), and not in
    ``avoid`` (the ports already handed out). Falls back to ``free_port``
    when no such port is free."""
    hi = _ephemeral_low()
    lo = max(1024, hi - 16384)
    for port in random.sample(range(lo, hi), min(64, max(hi - lo, 0))):
        if port in avoid:
            continue
        s = socket.socket()
        try:
            s.bind(("0.0.0.0", port))
        except OSError:
            continue
        finally:
            s.close()
        return port
    return free_port()


def ipv4_port(server) -> int:
    """The listening port of an asyncio Server, preferring the IPv4 socket:
    with port 0 each address family gets its OWN ephemeral port, and
    loopback clients dial 127.0.0.1."""
    for sock in server.sockets:
        if sock.family == socket.AF_INET:
            return sock.getsockname()[1]
    return server.sockets[0].getsockname()[1]
