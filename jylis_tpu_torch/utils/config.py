"""Config and CLI flag parsing for the serving node.

A reduced copy of jylis_tpu/utils/config.py (itself after the
reference's config.pony:5-97): the flags this slice uses keep the JAX
package's names and defaults — --port/-p, --addr/-a, --log-level/-L —
and --device picks where the repos' state lives. The address's 64-bit
hash is the node's replica identity. There is no cluster yet, so an
empty address name stays empty instead of getting a random one.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass, field

from ..models.database import SERVED_TYPES
from .address import Address
from .log import Log


@dataclass
class Config:
    port: str = "6379"
    addr: Address = field(default_factory=lambda: Address.from_string("127.0.0.1:9999:"))
    device: str = "cuda"
    log: Log = field(default_factory=Log.create_none)


def config_from_cli(argv: list[str] | None = None, log_out=None) -> Config:
    parser = argparse.ArgumentParser(
        prog="jylis-tpu-torch",
        description=f"CRDT database on PyTorch and CUDA ({', '.join(SERVED_TYPES)})",
    )
    parser.add_argument(
        "-a", "--addr", default="127.0.0.1:9999:",
        help="The host:port:name of this node; its hash is the node's "
        "replica identity.",
    )
    parser.add_argument(
        "-p", "--port", default="6379",
        help="The port for accepting commands over RESP-protocol connections.",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="Torch device that holds the keyspace state (default cuda; "
        "cpu runs the kernels' plain versions).",
    )
    parser.add_argument(
        "-L", "--log-level", default="info",
        help="Maximum level of detail for logging (error, warn, info, or debug).",
    )
    from .. import __version__

    parser.add_argument(
        "--version", action="version", version=f"jylis-tpu-torch {__version__}",
    )
    args = parser.parse_args(argv)

    config = Config()
    config.port = args.port
    config.addr = Address.from_string(args.addr)
    config.device = args.device
    level = {"error": "err", "warn": "warn", "info": "info", "debug": "debug"}.get(
        args.log_level
    )
    if level is None:
        print(f"Unknown log-level: {args.log_level}")
        sys.exit(1)
    config.log = Log(level, log_out)
    return config
