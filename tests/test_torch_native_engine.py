"""The port's native serving engine against its Python tables and the JAX node.

At tolerance 0, on the CPU (g++ builds the library; no card is needed):

* One seeded RESP stream of every served type -- writes, reads, trims,
  u64 edge values, parse failures, an unknown type, TENSOR, MAP, BCOUNT
  and SYSTEM commands, anti-entropy deltas between bursts, a command too
  long for the engine (which demotes its connection), an injected fault
  at ``native.scan_apply`` and a malformed tail -- goes over sockets to
  three nodes: a port node with ``engine="auto"``, a port node with
  ``engine="python"`` (the oracle) and a JAX ``Database(engine="auto")``
  behind the JAX server. The replies are equal byte for byte; after a
  drain every type's dump (each encoded by its own package's codec) and
  ``SYSTEM DIGEST [TYPES]`` are equal; the native node settled commands
  in C++ (SERVING ``native_cmds`` > 0) and counted its demotions.
* A build with a compiler that does not exist raises, with its error,
  and so does a ``Database(engine="auto")`` whose library cannot build.
* The engine's drain thresholds are the repos', and an engine handle
  never crosses packages.
"""

import asyncio
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from jylis_tpu import native as jax_native
from jylis_tpu.cluster import codec as jax_codec
from jylis_tpu.cluster.msg import MsgPushDeltas as JaxMsgPushDeltas
from jylis_tpu.models.database import Database as JaxDatabase
from jylis_tpu.ops.ujson_host import UJSON as JaxUJSON
from jylis_tpu.server.server import Server as JaxServer
from jylis_tpu.utils.config import Config as JaxConfig
from jylis_tpu_torch import faults, native
from jylis_tpu_torch.cluster import codec
from jylis_tpu_torch.cluster.msg import MsgPushDeltas
from jylis_tpu_torch.models import repo_treg, tlog_table
from jylis_tpu_torch.models.database import SERVED_TYPES, Database
from jylis_tpu_torch.native import engine as engine_mod
from jylis_tpu_torch.ops.ujson_host import UJSON
from jylis_tpu_torch.server.server import Server
from jylis_tpu_torch.utils.config import Config

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)

IDENTITY = 0xABCDEF
U64 = (1 << 64) - 1
SRC = Path(native.__file__).resolve().parent / "src"


def arr(*parts) -> bytes:
    out = b"*%d\r\n" % len(parts)
    for p in parts:
        p = p if isinstance(p, bytes) else str(p).encode()
        out += b"$%d\r\n%s\r\n" % (len(p), p)
    return out


def replies_in(buf: bytes) -> int:
    """How many complete top-level RESP replies ``buf`` holds."""

    def one(pos: int):
        end = buf.find(b"\r\n", pos)
        if end < 0:
            return None
        head, nxt = buf[pos:end], end + 2
        if head[:1] == b"$":
            n = int(head[1:])
            if n < 0:
                return nxt
            return nxt + n + 2 if len(buf) >= nxt + n + 2 else None
        if head[:1] == b"*":
            for _ in range(int(head[1:])):
                nxt = one(nxt)
                if nxt is None:
                    return None
            return nxt
        return nxt

    pos = n = 0
    while pos < len(buf):
        pos = one(pos)
        if pos is None:
            break
        n += 1
    return n


# ---- the stream ------------------------------------------------------------------


def stream(rng) -> list[list[bytes]]:
    """Bursts of commands (RESP arrays, some inline) over every type."""
    keys = [b"k%d" % i for i in range(5)]
    bursts = []
    for _ in range(4):
        cmds = []
        for _ in range(160):
            k = keys[rng.integers(len(keys))]
            roll = int(rng.integers(26))
            n = int(rng.integers(1, 1000))
            if roll < 2:
                cmds.append(arr("GCOUNT", "INC", k, U64 if n < 20 else n))
            elif roll < 4:
                cmds.append(arr("PNCOUNT", ("INC", "DEC")[n % 2], k, n))
            elif roll == 4:
                cmds.append(arr("GCOUNT", "GET", k))
            elif roll == 5:
                cmds.append(b"PNCOUNT GET %s\r\n" % k)  # inline
            elif roll < 8:
                ts = (U64, 1 << 63, n)[n % 3]
                cmds.append(arr("TREG", "SET", k, b"val%d" % (n % 7), ts))
            elif roll == 8:
                cmds.append(arr("TREG", "GET", k))
            elif roll < 11:
                cmds.append(arr("TLOG", "INS", k, b"x%d" % (n % 6), (n, 1 << 40)[n % 2]))
            elif roll == 11:
                cmds.append(arr("TLOG", "SIZE", k))
            elif roll == 12:
                cmds.append(arr("TLOG", "GET", k, *([n % 5 + 1] if n % 2 else [])))
            elif roll == 13:
                sub = n % 4
                cmds.append(arr("TLOG", *(("CUTOFF", k), ("TRIM", k, n % 4),
                                          ("TRIMAT", k, n % 50), ("CLR", k))[sub]))
            elif roll == 14:
                vals = (b"%d" % (n % 20), b"1.5", b'"a\\nb"', b'"caf\\u00e9"', b"true")
                cmds.append(arr("UJSON", "INS", k, "tags", vals[n % len(vals)]))
            elif roll == 15:
                cmds.append(arr("UJSON", "GET", k, *((), ("tags",), ("meta",))[n % 3]))
            elif roll == 16:
                docs = (b"7", b'"x"', b'{"a":1,"b":[1,2]}', b"[3,4]")
                cmds.append(arr("UJSON", "SET", k, "meta", docs[n % 4]))
            elif roll == 17:
                cmds.append(arr("UJSON", ("RM", "CLR")[n % 2], k, "tags",
                                *([b"%d" % (n % 20)] if n % 2 == 0 else [])))
            elif roll == 18:
                blob = np.asarray([n % 9, -(n % 5)], "<f4").tobytes()
                cmds.append(arr("TENSOR", "SET", k, "MAX", n, blob))
            elif roll == 19:
                cmds.append(arr("TENSOR", "GET", k))
            elif roll == 20:
                cmds.append(arr("MAP", "GCOUNT", "SET", k, b"f%d" % (n % 3), n))
            elif roll == 21:
                cmds.append(arr("MAP", "GCOUNT", "KEYS", k))
            elif roll == 22:
                cmds.append(arr("BCOUNT", ("GRANT", "INC", "DEC")[n % 3], k, n % 50))
            elif roll == 23:
                cmds.append(arr("BCOUNT", "GET", k))
            elif roll == 24:  # parse failures: help replies on both paths
                cmds.append(arr(*(("GCOUNT", "INC", k, "x"), ("TREG", "SET", k),
                                  ("TLOG", "INS", k, "v", "-1"), ("FOO", "BAR"))[n % 4]))
            else:
                cmds.append(arr("SYSTEM", "VERSION"))
        bursts.append(cmds)
    return bursts


def deltas(rng, cls) -> list[tuple[str, list]]:
    """Anti-entropy batches from foreign replicas, as ``cls``'s
    package's objects (UJSON documents are per package)."""
    keys = [b"k%d" % i for i in range(5)] + [b"f%d" % i for i in range(3)]
    out = [
        ("GCOUNT", [(k, {7: int(v), 1 << 63: U64}) for k, v in
                    zip(keys, rng.integers(1, 1 << 62, len(keys)))]),
        ("PNCOUNT", [(k, ({9: int(v)}, {9: int(v) // 2})) for k, v in
                     zip(keys, rng.integers(1, 1 << 62, len(keys)))]),
        ("TREG", [(k, (b"far%d" % i, U64 - i)) for i, k in enumerate(keys)]),
        ("TLOG", [(k, ([(b"r%d" % i, 1 << 41), (b"s", 3)], 2)) for i, k in enumerate(keys)]),
    ]
    docs = []
    for i, k in enumerate(keys):
        d, src = cls(), cls()
        src.set_doc(11, ("far",), str(i), d)
        docs.append((k, d))
    out.append(("UJSON", docs))
    return out


# ---- the three nodes -------------------------------------------------------------


class Node:
    """One node behind its package's server, on this test's event loop."""

    def __init__(self, kind: str):
        self.kind = kind
        if kind == "jax":
            self.db = JaxDatabase(identity=IDENTITY, engine="auto")
            cfg = JaxConfig()
            cfg.port = "0"
            self.server = JaxServer(cfg, self.db)
        else:
            self.db = Database(IDENTITY, device="cpu",
                               engine="auto" if kind == "native" else "python")
            self.server = Server(Config(port="0"), self.db)

    async def start(self) -> None:
        await self.server.start()

    async def send(self, packets: list[bytes], n_replies: int | None) -> bytes:
        """Send ``packets`` on a fresh connection and read ``n_replies``
        replies (None: until the server closes it)."""
        reader, writer = await asyncio.open_connection("127.0.0.1", self.server.port)
        out = b""
        try:
            for p in packets:
                writer.write(p)
                await writer.drain()
            while n_replies is None or replies_in(out) < n_replies:
                chunk = await asyncio.wait_for(reader.read(1 << 16), 60)
                if not chunk:
                    break
                out += chunk
        finally:
            writer.close()
        return out

    async def converge(self, batches) -> None:
        for name, batch in batches:
            if self.kind == "jax":
                await self.db.converge_async((name, batch))
            else:
                await self.db.converge_async(name, batch)

    async def dumps(self) -> dict:
        self.db.drain_all()
        names = tuple(n for n in SERVED_TYPES)
        got = await self.db.dump_state_async(names)
        if self.kind == "jax":
            return {n: jax_codec.encode(JaxMsgPushDeltas(n, tuple(b))) for n, b in got}
        return {n: codec.encode(MsgPushDeltas(n, tuple(b))) for n, b in got}


def split(rng, wire: bytes) -> list[bytes]:
    cuts = sorted(set(rng.integers(1, len(wire), size=12).tolist()))
    return [wire[a:b] for a, b in zip([0, *cuts], [*cuts, len(wire)])]


async def drive(kind: str, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    bursts = stream(rng)
    foreign = deltas(np.random.default_rng(seed + 100), JaxUJSON if kind == "jax" else UJSON)
    node = Node(kind)
    await node.start()
    out = {}
    try:
        got = []
        for i, cmds in enumerate(bursts[:2]):
            got.append(await node.send(split(rng, b"".join(cmds)), len(cmds)))
            if i == 0:
                await node.converge(foreign)  # later GETs must drain first
        # a command too long for the engine mid-burst demotes its connection
        long_cmd = arr("GCOUNT", "GET", "k0", *[b"x"] * 1100)
        cmds = bursts[2][:80] + [long_cmd] + bursts[2][80:]
        got.append(await node.send(split(rng, b"".join(cmds)), len(cmds)))
        # an injected failure at the FFI boundary demotes too
        faults.arm("native.scan_apply", "error", budget=1)
        try:
            got.append(await node.send([b"".join(bursts[3])], len(bursts[3])))
        finally:
            faults.reset()
        # a malformed tail: the oracle's error, then the connection drops
        got.append(await node.send([arr("TREG", "GET", "k1") + b"*x\r\n"], None))
        out["replies"] = got
        out["digest"] = await node.send([arr("SYSTEM", "DIGEST"), arr("SYSTEM", "DIGEST", "TYPES")], 2)
        out["dumps"] = await node.dumps()
        out["digest_after"] = await node.send([arr("SYSTEM", "DIGEST")], 1)
        if kind != "jax":
            out["serving"] = node.db.serving_totals()
            out["resident"] = node.db.manager("UJSON").repo._res is not None
    finally:
        await node.server.dispose()
    return out


@pytest.fixture(scope="module")
def runs():
    return {kind: asyncio.run(asyncio.wait_for(drive(kind, 5), 300))
            for kind in ("native", "python", "jax")}


def test_replies_equal_on_three_nodes(runs):
    want = runs["jax"]["replies"]
    assert runs["python"]["replies"] == want
    for i, (got, w) in enumerate(zip(runs["native"]["replies"], want)):
        assert got == w, f"connection {i}"
    text = b"".join(want)
    assert b"-protocol error" in text and b":18446744073709551615" in text


def test_digests_and_dumps_equal_after_drain(runs):
    for what in ("digest", "digest_after"):
        assert runs["native"][what] == runs["python"][what] == runs["jax"][what], what
    assert runs["native"]["digest"].count(b"$") == 1 + len(SERVED_TYPES)
    for name in SERVED_TYPES:
        dumps = [runs[k]["dumps"][name] for k in ("native", "python", "jax")]
        assert dumps[0] == dumps[1] == dumps[2], name
        assert len(dumps[0]) > 12, name


def test_native_node_settles_in_cpp_and_counts_demotions(runs):
    native_split, python_split = runs["native"]["serving"], runs["python"]["serving"]
    assert native_split["native_cmds"] > 200
    # the long command, the fault and the malformed tail
    assert native_split["demotions"] == 3
    assert python_split["native_cmds"] == 0 and python_split["demotions"] == 0
    assert native_split["demoted_cmds"] < python_split["demoted_cmds"]


# ---- the library ---------------------------------------------------------------------


def test_a_failed_build_raises_with_the_compiler_error(tmp_path):
    with pytest.raises(native.NativeBuildError, match="no-such-c"):
        native.load(tmp_path / "fresh", cxx="no-such-c++-compiler")
    assert not (tmp_path / "fresh" / native.SO_NAME).exists()


def test_auto_engine_raises_when_the_library_cannot_build(tmp_path, monkeypatch):
    monkeypatch.setattr(engine_mod, "lib",
                        lambda: native.load(tmp_path / "fresh", cxx="no-such-c++-compiler"))
    with pytest.raises(native.NativeBuildError):
        Database(IDENTITY, device="cpu")
    with pytest.raises(native.NativeBuildError):
        repo_treg.RepoTREG(1, device="cpu")
    assert Database(IDENTITY, device="cpu", engine="python").native_engine is None


def test_thresholds_match_the_engine_source():
    serve = (SRC / "serve_engine.cpp").read_text()
    header = (SRC / "engine.h").read_text()

    def const(text, name):
        return int(re.search(rf"\b{name}\s*=\s*(\d+)", text).group(1))

    assert const(serve, "TREG_PENDING_DRAIN") == repo_treg.PENDING_DRAIN_THRESHOLD == 4096
    assert const(header, "ROW_DRAIN_THRESHOLD") == tlog_table.ROW_DRAIN_THRESHOLD
    assert const(header, "PENDING_DRAIN_THRESHOLD") == tlog_table.PENDING_DRAIN_THRESHOLD


def test_each_package_loads_its_own_library():
    port = native.lib()
    assert Path(native.info["path"]) == native.so_path()
    assert native.info["compiler"]
    jax_lib = jax_native.lib()
    if jax_lib is not None:
        assert port._handle != jax_lib._handle
        assert Path(jax_lib._name).resolve() != Path(port._name).resolve()
    eng = engine_mod.make_engine()
    assert eng.cdll is port
    assert engine_mod.resolve_engine(eng) is eng
    assert engine_mod.resolve_engine("python") is None
    from jylis_tpu.native.engine import make_engine as jax_make_engine

    jax_eng = jax_make_engine()
    if jax_eng is not None:
        with pytest.raises(TypeError):
            engine_mod.resolve_engine(jax_eng)
