"""jtrace: sampled end-to-end delta provenance spans.

The port's copy of jylis_tpu/obs/jtrace.py, unchanged in behaviour: the
minting half (``append_hop``), the span decoder and the ``SpanStats``
fold. A span is an append-only byte string a sequenced cluster frame
carries. The origin node mints one for 1-in-N sequenced flushes
(``--trace-sample``), every relay appends a stamp, and the receiver
appends its apply stamp and folds the chain into per-hop and end-to-end
convergence-latency histograms, SLO counters and worst-chain exemplars
(``SYSTEM TRACE SPANS``, ``SYSTEM OBSERVE``).

Wire format (LEB128, same primitives as the cluster codec):

    span  = hop*
    hop   = tag:varint len:varint payload[len]
    payload = rid:str region:str ts_ms:varint

Unknown tags are skipped via their length prefix; truncation, u64
overflow or an absurd hop count raise WireError.
"""

from __future__ import annotations

import threading

from ..utils.wire import Reader, WireError
from .hist import Histogram

# hop tags, in the order a write crosses them
HOP_ORIGIN = 1  # minted where broadcast_deltas sequenced the flush
HOP_BUS = 2  # the lane bus (intra-node fan-out between lanes)
HOP_CLUSTER = 3  # the external WAN cluster leg (lane 0's bridge tee)
HOP_RELAY = 4  # a bridge relayed it onward (origin-preserving)
HOP_APPLY = 5  # the receiving replica applied it (appended at fold)

_HOP_NAMES = {
    HOP_ORIGIN: "origin",
    HOP_BUS: "bus",
    HOP_CLUSTER: "cluster",
    HOP_RELAY: "relay",
    HOP_APPLY: "apply",
}

MAX_HOPS = 32  # a real chain is ≤ ~6; anything longer is garbage
_U64_MAX = (1 << 64) - 1

DEFAULT_SLO_MS = (50, 250, 1000)
WORST_KEEP = 8  # exemplar chains retained for SYSTEM TRACE SPANS


def hop_name(tag: int) -> str:
    return _HOP_NAMES.get(tag, f"hop{tag}")


def _w_varint(acc: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            acc.append(b | 0x80)
        else:
            acc.append(b)
            return


def append_hop(span: bytes, tag: int, rid: str, region: str,
               ts_ms: int) -> bytes:
    """Return ``span`` with one hop stamp appended (pure — the original
    bytes are never mutated; a relayed frame re-encodes its message)."""
    payload = bytearray()
    rb = rid.encode()
    _w_varint(payload, len(rb))
    payload += rb
    gb = region.encode()
    _w_varint(payload, len(gb))
    payload += gb
    _w_varint(payload, max(0, ts_ms) & _U64_MAX)
    acc = bytearray(span)
    _w_varint(acc, tag)
    _w_varint(acc, len(payload))
    acc += payload
    return bytes(acc)


def decode_span(span: bytes) -> list[tuple[int, str, str, int]]:
    """Decode a span to ``[(tag, rid, region, ts_ms), ...]``.

    Unknown hop tags are skipped via their length prefix; truncation,
    u64 overflow, or an absurd hop count raise WireError.
    """
    r = Reader(span)
    hops: list[tuple[int, str, str, int]] = []
    n_seen = 0
    while not r.done():
        tag = r.varint()
        if tag > _U64_MAX:
            raise WireError("span hop tag out of u64 range")
        body = r.bytes_()
        n_seen += 1
        if n_seen > MAX_HOPS:
            raise WireError("span hop count over bound")
        if tag not in _HOP_NAMES:
            continue  # forward compat: a newer node's hop kind
        hr = Reader(body)
        rid = hr.str_()
        region = hr.str_()
        ts = hr.varint()
        if ts > _U64_MAX:
            raise WireError("span hop ts out of u64 range")
        # trailing payload bytes are tolerated (a newer node may extend
        # a KNOWN hop's payload; the length prefix already framed it)
        hops.append((tag, rid, region, ts))
    return hops


def format_chain(hops: list[tuple[int, str, str, int]]) -> str:
    """``origin@rid[r1]+0ms -> relay@rid2[r1]+3ms -> apply@rid3[r2]+9ms``
    — per-hop offsets from the origin stamp (clock-skew caveat applies
    exactly as it does to converge_lag_ms)."""
    if not hops:
        return "(empty span)"
    t0 = hops[0][3]
    parts = []
    for tag, rid, region, ts in hops:
        where = f"{rid}[{region}]" if region else rid
        parts.append(f"{hop_name(tag)}@{where}+{max(0, ts - t0)}ms")
    return " -> ".join(parts)


class SpanStats:
    """Fold arrived spans into per-hop and end-to-end latency
    histograms, SLO counters, and worst-chain exemplars.

    NOT named like registry histograms on purpose: metric names here
    are data-dependent (region pairs, hop transitions), so this class
    IS the declared surface.

    Thread-safe under a lock: folds and SYSTEM TRACE SPANS may run on
    different threads.
    """

    def __init__(self, slo_ms: tuple[int, ...] = DEFAULT_SLO_MS):
        self._lock = threading.Lock()
        self.slo_ms: tuple[int, ...] = tuple(sorted(slo_ms))
        self.sampled = 0  # spans folded (chain decoded fine)
        self.malformed = 0  # spans dropped by the defensive decoder
        self.slo_ok = [0] * len(self.slo_ms)
        # (from_tag, to_tag) -> Histogram of the transition latency
        self.hop_hists: dict[tuple[int, int], Histogram] = {}
        # (origin_region, apply_region) -> Histogram of e2e latency
        self.e2e_hists: dict[tuple[str, str], Histogram] = {}
        # worst end-to-end chains seen: [(e2e_ms, formatted chain)]
        self.worst: list[tuple[int, str]] = []

    def set_slo_ms(self, slo_ms: tuple[int, ...]) -> None:
        with self._lock:
            self.slo_ms = tuple(sorted(slo_ms))
            self.slo_ok = [0] * len(self.slo_ms)

    def ingest(self, span: bytes, rid: str, region: str,
               now_ms: int) -> str | None:
        """Fold one arrived span; ``rid``/``region``/``now_ms`` stamp
        the local apply hop. Returns the formatted chain if it set a
        new worst-e2e record (caller traces it), else None."""
        try:
            hops = decode_span(span)
        except WireError:
            with self._lock:
                self.malformed += 1
            return None
        if not hops or hops[0][0] != HOP_ORIGIN:
            # a chain with no origin stamp can't be timed end to end
            with self._lock:
                self.malformed += 1
            return None
        hops.append((HOP_APPLY, rid, region, now_ms))
        t_origin = hops[0][3]
        e2e_ms = max(0, now_ms - t_origin)
        pair = (hops[0][2], region)
        chain = None
        with self._lock:
            self.sampled += 1
            for i, ms in enumerate(self.slo_ms):
                if e2e_ms <= ms:
                    self.slo_ok[i] += 1
            h = self.e2e_hists.get(pair)
            if h is None:
                h = self.e2e_hists[pair] = Histogram()
            h.record(e2e_ms * 1e-3)
            for (ptag, _, _, pts), (tag, _, _, ts) in zip(hops, hops[1:]):
                key = (ptag, tag)
                th = self.hop_hists.get(key)
                if th is None:
                    th = self.hop_hists[key] = Histogram()
                th.record(max(0, ts - pts) * 1e-3)
            floor = self.worst[-1][0] if len(self.worst) >= WORST_KEEP \
                else -1
            if e2e_ms > floor or len(self.worst) < WORST_KEEP:
                chain = format_chain(hops)
                self.worst.append((e2e_ms, chain))
                self.worst.sort(key=lambda w: -w[0])
                is_record = self.worst[0][1] == chain
                del self.worst[WORST_KEEP:]
                if not is_record:
                    chain = None
        return chain

    def slo_fracs(self) -> list[tuple[int, float, int]]:
        """[(threshold_ms, fraction_ok, ok_count)] over sampled spans."""
        with self._lock:
            n = max(self.sampled, 1)
            return [
                (ms, self.slo_ok[i] / n, self.slo_ok[i])
                for i, ms in enumerate(self.slo_ms)
            ]

    def report_lines(self) -> list[str]:
        """The SYSTEM TRACE SPANS body: counters, per-hop-transition
        and per-region-pair latency lines, SLO fractions, exemplars."""
        with self._lock:
            lines = [
                f"spans sampled {self.sampled} malformed {self.malformed}"
            ]
            for (a, b), h in sorted(self.hop_hists.items()):
                s = h.snapshot()
                lines.append(
                    f"hop {hop_name(a)}->{hop_name(b)} count {s['count']}"
                    f" p50_ms {s['p50_s'] * 1e3:.3f}"
                    f" p99_ms {s['p99_s'] * 1e3:.3f}"
                    f" max_ms {s['max_s'] * 1e3:.3f}"
                )
            for (src, dst), h in sorted(self.e2e_hists.items()):
                s = h.snapshot()
                lines.append(
                    f"e2e {src or '-'}->{dst or '-'} count {s['count']}"
                    f" p50_ms {s['p50_s'] * 1e3:.3f}"
                    f" p99_ms {s['p99_s'] * 1e3:.3f}"
                    f" max_ms {s['max_s'] * 1e3:.3f}"
                )
            n = max(self.sampled, 1)
            for i, ms in enumerate(self.slo_ms):
                lines.append(
                    f"slo {ms}ms frac {self.slo_ok[i] / n:.4f}"
                    f" ok {self.slo_ok[i]}"
                )
            for e2e_ms, chain in self.worst:
                lines.append(f"worst {e2e_ms}ms {chain}")
            return lines
