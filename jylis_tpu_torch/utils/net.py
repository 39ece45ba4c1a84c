"""Small shared networking helpers.

The port's copy of jylis_tpu/utils/net.py, whole.
"""

from __future__ import annotations

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


def ipv4_port(server) -> int:
    """The listening port of an asyncio Server, preferring the IPv4 socket:
    with port 0 each address family gets its OWN ephemeral port, and
    loopback clients dial 127.0.0.1."""
    for sock in server.sockets:
        if sock.family == socket.AF_INET:
            return sock.getsockname()[1]
    return server.sockets[0].getsockname()[1]
