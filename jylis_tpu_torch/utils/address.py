"""Node address: the host:port:name triple advertised to peers.

Reference analog: address.pony:1-44. The 64-bit hash of the address is the
node's replica identity fed to every identity-bearing CRDT
(database.pony:13), so it must be deterministic across processes — Python's
salted hash() is unusable; we use FNV-1a 64 with the same field-mixing
shape the reference applies to its per-field hashes.
"""

from __future__ import annotations

from dataclasses import dataclass

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_U64 = (1 << 64) - 1


def fnv1a64(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _U64
    return h


@dataclass(frozen=True)
class Address:
    host: str = ""
    port: str = ""
    name: str = ""

    @classmethod
    def from_string(cls, s: str) -> "Address":
        """Split on the first two colons; missing parts are empty
        (address.pony:9-21: "h", "h:p", and "h:p:n" all parse)."""
        i = s.find(":")
        if i < 0:
            return cls(s, "", "")
        j = s.find(":", i + 1)
        if j < 0:
            return cls(s[:i], s[i + 1 :], "")
        return cls(s[:i], s[i + 1 : j], s[j + 1 :])

    def hash64(self) -> int:
        h = fnv1a64(self.host.encode())
        for part in (self.port, self.name):
            h = h ^ ((fnv1a64(part.encode()) + 0x9D9EEC79 + ((h << 6) & _U64) + (h >> 2)) & _U64)
        return h & _U64

    def __str__(self) -> str:
        return f"{self.host}:{self.port}:{self.name}"
