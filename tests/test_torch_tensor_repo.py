"""Parity of the port's TENSOR gathered join, repo and delta codec with the
JAX package's, on the CPU.

The same numpy-seeded inputs go through the JAX functions and the port's
plain PyTorch versions (tolerance 0: the planes are u32 bit patterns).
The op inputs draw timestamps and rids from small pools (so every stage
of the lexicographic select sees equal operands), f32 bits with NaN
payloads and both zeros, and pad rows at PAD_ROW. The repo streams mix
SET in all three modes, MRG blobs, GETs, anti-entropy deltas (some of a
greater (mode, dim), so a key's rows are retired by a dominance flip),
drains and flushes, and compare reply bytes, flushed deltas, dumped
state, the device-row bookkeeping and the device planes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jylis_tpu.cluster import codec as jcodec
from jylis_tpu.models import repo_tensor as jrt
from jylis_tpu.ops import tensor as jt
from jylis_tpu.ops import tensor_host as jth
from jylis_tpu.server import resp as jresp
from jylis_tpu_torch import convert
from jylis_tpu_torch.cluster import codec
from jylis_tpu_torch.models import repo_tensor as rt
from jylis_tpu_torch.ops import tensor, tensor_host
from jylis_tpu_torch.server import resp as tresp
from jylis_tpu_torch.utils.batching import pad_rows

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)
from jax_python_paths import jax_python_paths  # noqa: E402,F401 (autouse: no JAX native build)

SEEDS = [0, 1, 2]
U64 = (1 << 64) - 1
F32_POOL = np.array(
    [0x00000000, 0x80000000, 0x3F800000, 0xBF800000, 0x7F800000, 0xFF800000,
     0x7FC00000, 0x7FC00001, 0xFFC00000, 0x7F800001, 0x00000001, 0x40490FDB],
    np.uint32,
)
TS_POOL = np.array([0, 1, 2, 1 << 63, U64], np.uint64)
RID_POOL = np.array([0, 1, 7, 0x80000000, 0xFFFFFFFF], np.uint32)


def f32_bits(rng, shape):
    pool = F32_POOL[rng.integers(0, len(F32_POOL), shape)]
    uni = rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)
    return np.where(rng.random(shape) < 0.6, pool, uni).astype(np.uint32)


def cell_planes(rng, shape):
    """(val, ts_hi, ts_lo, rid) u32 planes with many equal stamps."""
    ts = TS_POOL[rng.integers(0, len(TS_POOL), shape)]
    rid = RID_POOL[rng.integers(0, len(RID_POOL), shape)]
    return (f32_bits(rng, shape), (ts >> np.uint64(32)).astype(np.uint32),
            ts.astype(np.uint32), rid)


def port_planes(p):
    return convert.tensor_from_jax(*p, device="cpu")


def jax_planes(p):
    return jt.TensorState(*(jnp.asarray(x) for x in p))


def assert_same(port, jax):
    for got, want in zip(convert.tensor_to_jax(port), jax):
        assert np.array_equal(got, np.asarray(want))


def i32(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


# ---- ops ----------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n,d,b,live", [(64, 8, 16, 16), (64, 8, 16, 9),
                                        (40, 20, 32, 0), (300, 64, 128, 100)])
def test_converge_batch_matches_jax(seed, n, d, b, live):
    rng = np.random.default_rng(seed * 97 + n + d)
    st = cell_planes(rng, (n, d))
    dl = cell_planes(rng, (b, d))
    ki = pad_rows(b)
    ki[:live] = rng.choice(n, live, replace=False)
    want = jt.converge_batch(jax_planes(st), jnp.asarray(ki),
                             *(jnp.asarray(x) for x in dl))
    got = tensor.converge_batch(port_planes(st), torch.from_numpy(ki),
                                *(i32(x) for x in dl))
    assert_same(got, want)
    if live:
        changed = ~np.all(np.asarray(want.val) == st[0], axis=1)
        assert changed.any()


@pytest.mark.parametrize("seed", SEEDS)
def test_converge_many_read_and_grow_match_jax(seed):
    rng = np.random.default_rng(seed + 50)
    n, d, b, rounds = 48, 8, 16, 3
    st = cell_planes(rng, (n, d))
    ki = np.stack([pad_rows(b) for _ in range(rounds)])
    for i in range(rounds):
        ki[i, :10] = rng.choice(n, 10, replace=False)
    dl = cell_planes(rng, (rounds, b, d))
    want = jt.converge_many(jax_planes(st), jnp.asarray(ki),
                            *(jnp.asarray(x) for x in dl))
    got = tensor.converge_many(port_planes(st), torch.from_numpy(ki),
                               *(i32(x) for x in dl))
    assert_same(got, want)
    rows = rng.choice(n, 7, replace=False).astype(np.int32)
    assert np.array_equal(
        tensor.read(got, torch.from_numpy(rows)).numpy().view(np.uint32),
        np.asarray(jt.read(want, jnp.asarray(rows))),
    )
    assert_same(tensor.grow(got, 128, 32), jt.grow(want, 128, 32))
    assert tensor.grow(got, n, d) is got
    assert_same(tensor.init(5, 16, "cpu"), jt.init(5, 16))


# ---- the delta codec ----------------------------------------------------------


def spec_to(host, spec):
    """Build one package's Tensor from a (mode, dim, val, ts, rid,
    contribs) wire spec."""
    return host.Tensor.from_wire(*spec)


def draw_spec(rng, mode=None, dim=None):
    mode = int(rng.integers(1, 4)) if mode is None else mode
    dim = int(rng.choice([1, 3, 4, 8, 20])) if dim is None else dim
    val = f32_bits(rng, dim).tobytes()
    if mode == tensor_host.MODE_MAX:
        return (mode, dim, val, b"", b"", {})
    if mode == tensor_host.MODE_LWW:
        ts = TS_POOL[rng.integers(0, len(TS_POOL), dim)].astype("<u8")
        rid = RID_POOL[rng.integers(0, len(RID_POOL), dim)].astype("<u4")
        return (mode, dim, val, ts.tobytes(), rid.tobytes(), {})
    rids = rng.choice([1, 5, 9, (1 << 40) + 5, (1 << 62) + 1],
                      int(rng.integers(1, 4)), replace=False)
    contribs = {
        int(r): (int(TS_POOL[int(rng.integers(len(TS_POOL)))]),
                 f32_bits(rng, dim).tobytes())
        for r in rids
    }
    return (mode, dim, b"", b"", b"", contribs)


@pytest.mark.parametrize("seed", SEEDS)
def test_tensor_delta_codec_bytes_match_jax(seed):
    rng = np.random.default_rng(seed + 70)
    specs = [draw_spec(rng) for _ in range(30)] + [(0, 0, b"", b"", b"", {})]
    for spec in specs:
        t, j = spec_to(tensor_host, spec), spec_to(jth, spec)
        blob = codec.encode_delta("TENSOR", t)
        assert blob == jcodec.encode_delta("TENSOR", j)
        back = codec.decode_delta("TENSOR", blob)
        assert back.canon() == jcodec.decode_delta("TENSOR", blob).canon()
        assert back == t
    bad = [
        blob + b"\x00",  # trailing bytes
        b"\x01\x02\x04\x00\x00\x80\x3f\x00\x00\x00",  # MAX with short val
        b"\x03\x01\x00\x00\x00\x02\x05\x01\x04abcd\x05\x01\x04abcd",  # dup rid
        b"\x09\x01",  # bad mode, truncated
    ]
    for blob in bad:
        with pytest.raises(jcodec.CodecError):
            jcodec.decode_delta("TENSOR", blob)
        with pytest.raises(codec.CodecError):
            codec.decode_delta("TENSOR", blob)
    with pytest.raises(codec.CodecError):
        codec.decode_delta("TREG", b"\x00")


# ---- the repo -----------------------------------------------------------------

IDENTITY = (1 << 40) + 0xABCDEF  # > 32 bits: the mirror narrows rids


def run_stream(seed, n_keys, n_ops, weights):
    rng = np.random.default_rng(seed)
    keys = [b"t%d" % i for i in range(n_keys)]
    # each key's (mode, dim): client writes keep to it (else BADSHAPE)
    shape = {k: (int(rng.integers(1, 4)), int(rng.choice([1, 3, 4, 8, 20])))
             for k in keys}
    jrepo = jrt.RepoTENSOR(IDENTITY, engine="python")
    trepo = rt.RepoTENSOR(IDENTITY, device="cpu")
    jout, tout = bytearray(), bytearray()
    jr, tr = jresp.Respond(jout.extend), tresp.Respond(tout.extend)
    ops = ["SET", "MRG", "GET", "CONV", "DRAIN", "FLUSH"]
    w = np.asarray(weights, float)
    for _ in range(n_ops):
        op = ops[rng.choice(len(ops), p=w / w.sum())]
        key = keys[int(rng.integers(n_keys))]
        mode, dim = shape[key]
        if rng.random() < 0.05:  # a write of another shape
            mode, dim = int(rng.integers(1, 4)), int(rng.choice([2, 8]))
        if op == "SET":
            payload = f32_bits(rng, dim).tobytes()
            if rng.random() < 0.03:
                payload = payload[:-1] or b""  # BADSHAPE (payload)
            name = tensor_host.MODE_NAMES[mode]
            args = [b"SET", key, name, b"%d" % int(rng.choice(TS_POOL)), payload]
        elif op == "MRG":
            blob = jcodec.encode_delta(
                "TENSOR", spec_to(jth, draw_spec(rng, mode, dim)))
            r = rng.random()
            if r < 0.05:
                blob = blob + b"\x00"  # BADPAYLOAD (encoding)
            elif r < 0.1:
                blob = b"\x00\x00\x00\x00\x00\x00"  # BADPAYLOAD (empty)
            args = [b"MRG", key, blob]
        elif op == "GET":
            args = [b"GET", key]
        elif op == "CONV":
            if rng.random() < 0.15:  # any rank: dominance flips
                mode, dim = int(rng.integers(1, 4)), int(rng.choice([1, 8, 20]))
            spec = draw_spec(rng, mode, dim)
            jrepo.converge(key, spec_to(jth, spec))
            trepo.converge(key, spec_to(tensor_host, spec))
            continue
        elif op == "DRAIN":
            jrepo.drain()
            trepo.drain()
            continue
        else:
            assert [(k, t.canon()) for k, t in trepo.flush_deltas()] == [
                (k, t.canon()) for k, t in jrepo.flush_deltas()
            ]
            continue
        jrepo.apply(jr, list(args))
        trepo.apply(tr, list(args))
        assert bytes(tout) == bytes(jout), args[:2]
    for k in keys:
        jrepo.apply(jr, [b"GET", k])
        trepo.apply(tr, [b"GET", k])
    assert bytes(tout) == bytes(jout)
    assert [(k, t.canon()) for k, t in trepo.dump_state()] == [
        (k, t.canon()) for k, t in jrepo.dump_state()
    ]
    for attr in ("_dev_rows", "_avg_ver", "_row_stamp", "_next_dev",
                 "_row_cap", "_dim_cap"):
        assert getattr(trepo, attr) == getattr(jrepo, attr), attr
    assert_same(trepo._state, jrepo._state)
    return trepo, bytes(tout)


@pytest.mark.parametrize("seed,n_keys,n_ops", [(0, 10, 400), (1, 60, 600),
                                               (2, 1500, 2500)])
def test_command_and_delta_stream_matches_jax(seed, n_keys, n_ops):
    trepo, out = run_stream(seed, n_keys, n_ops, [3, 2, 3, 3, 0.5, 0.3])
    for reply in (b"*3\r\n$3\r\nMAX", b"*3\r\n$3\r\nLWW", b"*3\r\n$3\r\nAVG",
                  b"-BADSHAPE (key holds", b"-BADSHAPE (tensor payload",
                  b"-BADPAYLOAD (MRG", b"-BADPAYLOAD (empty"):
        assert reply in out, reply
    assert trepo._dim_cap == 32  # grown from 8 for the 20-dim keys
    assert trepo._state.val.device.type == "cpu"
    # more device rows than table rows: AVG contributors and flips
    assert trepo._next_dev > len(trepo._row_stamp)
    if seed == 2:
        assert trepo._row_cap == 2048


def test_dominance_flip_retires_device_rows():
    """A replicated delta of a greater (mode, dim) replaces a key's value
    wholesale; the drain abandons the key's old device rows and mirrors
    the new winner on fresh rows, in both packages alike."""
    specs = [
        (b"k", (1, 4, np.arange(4, dtype="<f4").tobytes(), b"", b"", {})),
        (b"j", (3, 4, b"", b"", b"", {5: (3, np.ones(4, "<f4").tobytes()),
                                     (1 << 33) + 2: (0, np.zeros(4, "<f4").tobytes())})),
        (b"k", (2, 4, np.full(4, 7, "<f4").tobytes(),
                np.full(4, 9, "<u8").tobytes(), np.full(4, 3, "<u4").tobytes(), {})),
        (b"j", (3, 8, b"", b"", b"", {6: (1, np.ones(8, "<f4").tobytes())})),
    ]
    jrepo = jrt.RepoTENSOR(IDENTITY, engine="python")
    trepo = rt.RepoTENSOR(IDENTITY, device="cpu")
    for i, (key, spec) in enumerate(specs):
        jrepo.converge(key, spec_to(jth, spec))
        trepo.converge(key, spec_to(tensor_host, spec))
        if i in (1, 3):
            jrepo.drain()
            trepo.drain()
    assert trepo._dev_rows == jrepo._dev_rows == {0: {-1: 3}, 1: {6: 4}}
    assert trepo._next_dev == 5
    assert trepo._avg_ver == jrepo._avg_ver
    assert_same(trepo._state, jrepo._state)
    val = convert.tensor_to_jax(trepo._state)[0]
    assert np.array_equal(val[3, :4], np.full(4, 7, "<f4").view(np.uint32))
    assert (val[0, 4:] == tensor.BOTTOM_BITS).all()
