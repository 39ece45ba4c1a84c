"""Shared repo plumbing: argument parsing, batching helpers, capacity math.

The repo plugin contract (mirroring RepoAny, repo_manager.pony:5-10):

    apply(resp, args: list[bytes]) -> bool   # True if data changed;
                                             # raises ParseError for help
    deltas_size() -> int
    flush_deltas() -> list[(key: bytes, delta)]
    converge(key: bytes, delta) -> None

plus ``drain()`` (device-repo specific): apply all buffered mutations /
deltas to device state in one fused batch.
"""

from __future__ import annotations

U64_MAX = (1 << 64) - 1


class ParseError(Exception):
    """Command didn't parse; the manager replies with help text."""


def need(args: list[bytes], i: int) -> bytes:
    try:
        return args[i]
    except IndexError:
        raise ParseError() from None


def parse_u64(b: bytes) -> int:
    """Strict unsigned 64-bit parse (Pony String.u64() behavior: digits
    only, no sign, must fit)."""
    if not b.isdigit():
        raise ParseError()
    v = int(b)
    if v > U64_MAX:
        raise ParseError()
    return v


def parse_opt_count(args: list[bytes], i: int) -> int:
    """Optional count arg: any missing/unparseable value means "all"
    (the reference's try-usize-else -1 trick, repo_tlog.pony:49-50)."""
    try:
        return parse_u64(args[i])
    except (ParseError, IndexError):
        return U64_MAX


# batching helpers live in utils/batching.py; re-exported here for the
# repos' convenience
from ..utils.batching import PAD_ROW, bucket, pad_rows  # noqa: E402,F401
