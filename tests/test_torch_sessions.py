"""Session guarantees in the port (jylis_tpu_torch/sessions.py and the
SESSION family of models/database.py) against the JAX package.

At tolerance 0 (byte-equal), on the CPU:

* the token codec: seeded vectors encode to the same bytes and decode
  to the same vectors; every truncation, every flipped byte, a trailing
  byte, a u64 overflow, a duplicate rid and an unknown version raise
  ``SessionError`` with the same message in both packages;
* ``SessionIndex``: a seeded stream of own flushes, applied batches (in
  order, out of order, duplicated, past the park cap), adoptions and
  epoch churn gives the same return values, vectors, parked state,
  token bytes and SESSION counters, the safe rule and the unsafe one;
* a port ``Database`` (both engines) and a JAX ``Database`` fed one
  seeded stream of data commands, SESSION TOKEN / WRAP / READ (with the
  minted token, a mangled one, an uncovered one, the help) and commands
  refused by ``--admission-cap`` while their repo lock is held give the
  same reply bytes and the same SESSION and OVERLOAD sections of
  SYSTEM METRICS;
* a JAX node and a port node in one cluster honour each other's tokens:
  a SESSION WRAP at one is served by SESSION READ at the other.
"""

import asyncio
import struct
import zlib

import numpy as np
import pytest
import torch

from jylis_tpu import sessions as jax_sessions
from jylis_tpu.models.database import Database as JaxDatabase
from jylis_tpu.server.resp import Respond as JaxRespond
from jylis_tpu_torch import sessions
from jylis_tpu_torch.models.database import Database
from jylis_tpu_torch.server.resp import Respond

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)
from jax_python_paths import jax_python_paths  # noqa: E402,F401 (autouse: no JAX native build)

SEEDS = [11, 12, 13]
IDENTITY = 0x5E55


def rand_vec(rng, n: int) -> dict:
    out = {}
    for i in range(n):
        rid = "10.%d.0.%d:%d:n%d!%d" % (rng.integers(0, 256), i, rng.integers(1, 65535),
                                        rng.integers(0, 99), rng.integers(0, 1 << 45))
        pool = [0, 1, 127, 128, 1 << 32, (1 << 64) - 1, int(rng.integers(0, 1 << 62))]
        seq = pool[int(rng.integers(0, len(pool)))]
        out[rid] = seq
    return out


def both_errors(data: bytes):
    """decode_token in both packages: the message of each SessionError,
    or the vector each returned."""
    got = []
    for mod in (sessions, jax_sessions):
        try:
            got.append(("ok", mod.decode_token(data)))
        except mod.SessionError as e:
            got.append(("err", str(e)))
    return got


@pytest.mark.parametrize("seed", SEEDS)
def test_token_bytes_and_decode_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 2, 7, 40):
        vec = rand_vec(rng, n)
        tok = sessions.encode_token(vec)
        assert tok == jax_sessions.encode_token(vec)
        assert sessions.decode_token(tok) == jax_sessions.decode_token(tok) == vec
        assert sessions.decode_token_memo(tok) == vec
        assert sessions.dominates(vec, vec) == jax_sessions.dominates(vec, vec)


@pytest.mark.parametrize("seed", SEEDS)
def test_every_typed_token_error_equals_jax(seed):
    rng = np.random.default_rng(seed)
    tok = sessions.encode_token(rand_vec(rng, 3))
    cases = [tok[:i] for i in range(len(tok))]  # truncation at every byte
    for i in range(len(tok)):  # a flipped byte at every offset
        bad = bytearray(tok)
        bad[i] ^= int(rng.integers(1, 256))
        cases.append(bytes(bad))
    cases += [tok + b"x", b""]

    def sealed(body: bytes) -> bytes:
        return body + struct.pack(">I", zlib.crc32(body))

    rid = b"h:1:n!1"
    over = bytearray((sessions.TOKEN_VERSION,))
    sessions._w_varint(over, 1)
    sessions._w_varint(over, len(rid))
    over += rid
    sessions._w_varint(over, 1 << 64)
    dup = bytearray((sessions.TOKEN_VERSION,))
    sessions._w_varint(dup, 2)
    for _ in range(2):
        sessions._w_varint(dup, len(rid))
        dup += rid
        sessions._w_varint(dup, 3)
    cases += [sealed(bytes(over)), sealed(bytes(dup)),
              sealed(bytes((9, 0))),  # unknown version
              sealed(bytes((1, 1, 3)) + b"\xff\xfe\xfd" + bytes((1,))),  # rid not utf-8
              sealed(bytes((1, 1)) + b"\x80" * 11),  # varint too long
              sealed(bytes((1,)) + bytes([0x80, 0x40]))]  # entry count out of bounds
    for data in cases:
        port, jax = both_errors(data)
        assert port == jax, data.hex()
    with pytest.raises(sessions.SessionError) as e:
        sessions._w_varint(bytearray(), -1)
    with pytest.raises(jax_sessions.SessionError) as je:
        jax_sessions._w_varint(bytearray(), -1)
    assert str(e.value) == str(je.value)


def index_ops(rng, n_ops: int = 1500):
    """A seeded stream of SessionIndex calls: own flushes, applied
    batches of a few origins (in order, gapped, duplicated, far past the
    park cap), adoptions, and origins of one address over many epochs."""
    addrs = ["127.0.0.1:%d:a" % (9000 + i) for i in range(3)]
    origins = [f"{a}!{e}" for a in addrs for e in range(7)]
    srid = origins[0]
    ops, own = [("bind", srid)], 0
    cum = dict.fromkeys(origins, 0)
    for _ in range(n_ops):
        r = rng.random()
        o = origins[int(rng.integers(0, len(origins)))]
        if r < 0.1:
            own += int(rng.integers(1, 4))
            ops.append(("note_local", srid, own))
        elif r < 0.6:
            cum[o] += 1
            ops.append(("note_applied", o, cum[o]))
        elif r < 0.8:
            ops.append(("note_applied", o, cum[o] + int(rng.integers(2, 9))))
        elif r < 0.85:
            ops.append(("note_applied", o, cum[o] + 600 + int(rng.integers(0, 50))))
        elif r < 0.9:
            ops.append(("note_applied", o, max(cum[o] - 1, 0)))
        else:
            picks = rng.choice(len(origins), int(rng.integers(0, 4)), replace=False)
            vec = {origins[int(j)]: cum[origins[int(j)]] + int(rng.integers(0, 12))
                   for j in picks}
            if rng.random() < 0.1:
                vec[o] = 1 << 64  # a hostile peer's seq: ignored
            ops.append(("adopt", vec))
    return ops


@pytest.mark.parametrize("unsafe", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_session_index_stream_equals_jax(seed, unsafe):
    rng = np.random.default_rng(seed)
    port, jax = sessions.SessionIndex(unsafe=unsafe), jax_sessions.SessionIndex(unsafe=unsafe)
    for op in index_ops(rng):
        if op[0] == "bind":
            port.bind(op[1], None)
            jax.bind(op[1], None)
            continue
        got = getattr(port, op[0])(*op[1:])
        want = getattr(jax, op[0])(*op[1:])
        assert got == want, op
        assert port.canonical() == jax.canonical(), op
        assert port.token_bytes() == jax.token_bytes()
    assert port.vector() == jax.vector()
    assert port.metrics_totals() == jax.metrics_totals()
    for tok in (port.vector(), {"x!1": 1}, {}):
        assert port.dominated(tok) == jax.dominated(tok)


def test_wait_dominated_serves_on_advance_and_refuses_at_the_deadline():
    async def drive(mod):
        idx = mod.SessionIndex()
        served_now = await idx.wait_dominated({}, 5)
        waiter = asyncio.ensure_future(idx.wait_dominated({"o!1": 2}, 2000))
        await asyncio.sleep(0.01)
        idx.note_applied("o!1", 1)
        idx.note_applied("o!1", 2)
        served_late = await waiter
        stale = await idx.wait_dominated({"o!1": 3}, 20)
        return served_now, served_late, stale, idx.metrics_totals()

    port = asyncio.run(drive(sessions))
    jax = asyncio.run(drive(jax_sessions))
    assert port == jax
    assert port[:3] == (True, True, False)


def session_stream(rng):
    """Data commands, SESSION TOKEN / WRAP / READ and their refusals, in
    a seeded order. ``None`` in a READ stands for the last token the
    node minted (each node presents its own, which are equal bytes)."""
    mangled = bytearray(sessions.encode_token({"h:1:n!1": 0}))
    mangled[2] ^= 0x55
    uncovered = sessions.encode_token({"10.0.0.9:7000:ghost!1": 3})
    steps = []
    for i in range(120):
        k = f"k{int(rng.integers(0, 20))}"
        r = rng.random()
        if r < 0.25:
            steps.append(["GCOUNT", "INC", k, int(rng.integers(1, 1 << 40))])
        elif r < 0.35:
            steps.append(["PNCOUNT", "DEC", k, int(rng.integers(1, 99))])
        elif r < 0.45:
            steps.append(["SESSION", "WRAP", "TREG", "SET", k, f"v{i}", int(rng.integers(0, 99))])
        elif r < 0.55:
            steps.append(["SESSION", "WRAP", "TLOG", "INS", k, f"e{i}", int(rng.integers(0, 99))])
        elif r < 0.6:
            steps.append(["SESSION", "WRAP", "GCOUNT", "GET"])  # an inner error reply
        elif r < 0.7:
            steps.append(["SESSION", "READ", None, "GCOUNT", "GET", k])
        elif r < 0.75:
            steps.append(["SESSION", "READ", None, "TLOG", "GET", k])
        elif r < 0.8:
            steps.append(["SESSION", "TOKEN"])
        elif r < 0.84:
            steps.append(["SESSION", "READ", bytes(mangled), "TREG", "GET", k])
        elif r < 0.87:
            steps.append(["SESSION", "READ", uncovered, "TREG", "GET", k])
        elif r < 0.9:
            steps.append([["SESSION"], ["SESSION", "NOPE"], ["SESSION", "WRAP", "SESSION", "TOKEN"],
                          ["SESSION", "READ", b"x"]][int(rng.integers(0, 4))])
        else:
            steps.append(["UJSON", "SET", k, "a", '{"n": %d}' % i])
    return steps


def as_bytes(cmd) -> list[bytes]:
    return [a if isinstance(a, bytes) else str(a).encode() for a in cmd]


def metrics_sections(reply: bytes, names=(b"SESSION ", b"OVERLOAD ")) -> list[bytes]:
    return [ln for ln in reply.split(b"\r\n") if ln.startswith(names)]


async def drive_db(db, resp_cls, steps) -> tuple[list[bytes], bytes]:
    db.session_wait_ms = 30
    db.set_admission_cap(1)
    replies, minted = [], b""
    for step in steps:
        out = bytearray()
        resp = resp_cls(out.extend)
        if step == "CAP":
            # the TLOG lock held (as by a threaded drain): a first queued
            # command waits on it, a second is past the cap of 1
            mgr = db.manager("TLOG")
            await mgr._lock.acquire()
            first = asyncio.ensure_future(db.apply_async(resp, as_bytes(["TLOG", "INS", "c", "x", 1])))
            await asyncio.sleep(0)
            refused = bytearray()
            await db.apply_async(resp_cls(refused.extend), as_bytes(["TLOG", "INS", "c", "y", 2]))
            mgr._lock.release()
            await first
            replies.append(bytes(out) + b"|" + bytes(refused))
            continue
        cmd = [minted if a is None else a for a in step]
        await db.apply_async(resp, as_bytes(cmd))
        reply = bytes(out)
        if step[:2] in (["SESSION", "TOKEN"], ["SESSION", "WRAP"]) and not reply.startswith(b"-"):
            minted = reply_token(reply)
        replies.append(reply)
    out = bytearray()
    await db.apply_async(resp_cls(out.extend), [b"SYSTEM", b"METRICS"])
    return replies, bytes(out)


def parse_reply(buf: bytes, pos: int = 0):
    """One RESP reply at ``pos``: (value, end). Bulk strings as bytes,
    arrays as lists, the rest as their line."""
    eol = buf.index(b"\r\n", pos)
    kind, head = buf[pos:pos + 1], buf[pos + 1:eol]
    if kind == b"$":
        n = int(head)
        return buf[eol + 2:eol + 2 + n], eol + 4 + n
    if kind == b"*":
        out, pos = [], eol + 2
        for _ in range(int(head)):
            v, pos = parse_reply(buf, pos)
            out.append(v)
        return out, pos
    return buf[pos:eol], eol + 2


def reply_token(reply: bytes) -> bytes:
    """The token of a SESSION TOKEN reply (a bulk string) or of a
    SESSION WRAP reply ([inner reply, token])."""
    value, _ = parse_reply(reply)
    return value[-1] if isinstance(value, list) else value


@pytest.mark.parametrize("engine", ["auto", "python"])
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_session_stream_replies_and_sections_equal_jax(seed, engine):
    steps = session_stream(np.random.default_rng(seed))
    steps.insert(len(steps) // 2, "CAP")
    steps.append("CAP")
    port = asyncio.run(drive_db(Database(IDENTITY, device="cpu", engine=engine), Respond, steps))
    jax = asyncio.run(drive_db(JaxDatabase(identity=IDENTITY, engine="python"), JaxRespond, steps))
    for i, (got, want) in enumerate(zip(port[0], jax[0])):
        assert got == want, (i, steps[i])
    assert len(port[0]) == len(jax[0])
    assert any(b"-BUSY" in r for r in port[0])
    assert any(r.startswith(b"-STALE") for r in port[0])
    assert any(r.startswith(b"-BADTOKEN") for r in port[0])
    got, want = metrics_sections(port[1]), metrics_sections(jax[1])
    assert got == want and any(ln.startswith(b"SESSION reads_served") for ln in got)
    assert any(ln.startswith(b"SERVING busy_refusals") for ln in port[1].split(b"\r\n"))


def test_set_admission_arms_the_overload_section_as_jax():
    port = Database(IDENTITY, device="cpu", engine="python")
    jax = JaxDatabase(identity=IDENTITY, engine="python")
    for db in (port, jax):
        db.set_admission("bulk>write>read>control,lat=5,depth=3,protect=1", 1 << 20)
    assert port.system.overload_fn() == jax.system.overload_fn()
    assert port.admission.order == jax.admission.order
    outs = []
    for db, resp_cls in ((port, Respond), (jax, JaxRespond)):
        out = bytearray()
        db.apply(resp_cls(out.extend), [b"SYSTEM", b"METRICS"])
        outs.append(metrics_sections(bytes(out)))
    assert outs[0] == outs[1] and any(ln.startswith(b"OVERLOAD state 0") for ln in outs[0])


def test_tokens_honoured_across_a_jax_node_and_a_port_node():
    from test_torch_cluster import call, start_node, wait_converged

    async def wrap(node, *cmd):
        reply = (await call(node.server.port, [["SESSION", "WRAP", *cmd]]))[0]
        assert reply.startswith(b"*2\r\n+OK\r\n"), reply
        return reply_token(reply)

    async def read_served(node, token, *cmd):
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 60
        while True:
            reply = (await call(node.server.port, [["SESSION", "READ", token, *cmd]]))[0]
            if not reply.startswith(b"-STALE"):
                return reply
            assert loop.time() < deadline, "the token was never covered"
            await asyncio.sleep(0.05)

    async def drive():
        a = await start_node("jax", "ja")
        b = await start_node("port", "pb", seeds=[a.addr])
        try:
            tok_a = await wrap(a, "GCOUNT", "INC", "s", 5)
            tok_b = await wrap(b, "GCOUNT", "INC", "s", 7)
            assert sessions.decode_token(tok_a) and sessions.decode_token(tok_b)
            at_b = await read_served(b, tok_a, "GCOUNT", "GET", "s")
            at_a = await read_served(a, tok_b, "GCOUNT", "GET", "s")
            await wait_converged(a, b)
            # after convergence each node's vector covers both tokens
            both = sessions.encode_token(sessions.join_vec(
                sessions.decode_token(tok_a), sessions.decode_token(tok_b)))
            final = [(await call(n.server.port, [["SESSION", "READ", both, "GCOUNT", "GET", "s"]]))[0]
                     for n in (a, b)]
            return at_b, at_a, final
        finally:
            await b.stop()
            await a.stop()

    at_b, at_a, final = asyncio.run(drive())
    for reply in (at_b, at_a, *final):
        assert reply.startswith(b"*2\r\n$"), reply
    assert final[0].endswith(b":12\r\n") and final[1].endswith(b":12\r\n")
