"""UJSON: nested observed-remove maps/sets with causal add-wins semantics.

The port's copy of jylis_tpu/ops/ujson_host.py, unchanged below this
paragraph (the port imports nothing of the JAX package).

Host-side authoritative implementation of the documented lattice
(docs/_docs/types/ujson.md:134-182): a UJSON node is a flat set of
(path, primitive-value) pairs, each tagged with a causal dot
(replica-id, seq); removal is by causal context (observed-remove), and a
concurrent insert of an identical pair beats its removal (add-wins).
Reference repo driving it: jylis/repo_ujson.pony:28-110.

The dot-store is an ORSWOT-style delta CRDT (Almeida et al.,
"Efficient State-based CRDTs by Delta-Mutation", PAPERS.md): a mutation's
delta carries only the new entries plus a causal context covering the new
dots and every removed dot. Joins are: keep an entry iff it is present in
both sides, or present in one side and its dot is NOT covered by the other
side's context (i.e. the other side never observed it — it survives).

This lattice lives on the host for SERVING: per-document data is tiny and
pointer-heavy. The anti-entropy fan-in — joining many deltas into many
replicas — is tensorised in ops/ujson_device.py (sorted packed-dot rows,
vv planes, log-depth delta folds), differentially tested against this
oracle and measured faster than the host loop on the 32-replica
benchmark (bench.py --config ujson-32).

Values are stored as canonical JSON tokens (the exact primitive serialisation,
e.g. '"user"', '42', 'true', 'null') so value identity is representation
identity — 1 and 1.0 stay distinct, matching string-typed storage in the
reference.
"""

from __future__ import annotations

import json

Dot = tuple[int, int]  # (replica-id, seq)
Path = tuple[str, ...]


class CausalContext:
    """Compacted causal history: per-replica contiguous max (version vector)
    plus a cloud of out-of-band dots (ujson.md:176 — compaction keeps this
    bounded)."""

    __slots__ = ("vv", "cloud")

    def __init__(self):
        self.vv: dict[int, int] = {}
        self.cloud: set[Dot] = set()

    def contains(self, dot: Dot) -> bool:
        r, s = dot
        return s <= self.vv.get(r, 0) or dot in self.cloud

    def __eq__(self, other) -> bool:
        """REPRESENTATIONAL equality (vv and cloud as stored) — what the
        wire codec round-trips; two contexts with identical coverage but
        different compaction states compare unequal."""
        return (
            isinstance(other, CausalContext)
            and self.vv == other.vv
            and self.cloud == other.cloud
        )

    # defining __eq__ sets __hash__ to None implicitly; keep that intent
    # EXPLICIT: contexts are mutable lattice state and must never be
    # dict keys or set members (a silent identity-hash would let two
    # equal contexts land in different buckets)
    __hash__ = None

    def add(self, dot: Dot) -> None:
        self.cloud.add(dot)
        self.compact()

    def next_dot(self, replica: int) -> Dot:
        """Mint the next contiguous dot for a replica (local mutations only)."""
        s = self.vv.get(replica, 0) + 1
        self.vv[replica] = s
        return (replica, s)

    def join(self, other: "CausalContext") -> None:
        for r, s in other.vv.items():
            if s > self.vv.get(r, 0):
                self.vv[r] = s
        self.cloud |= other.cloud
        self.compact()

    def compact(self) -> None:
        moved = True
        while moved:
            moved = False
            for dot in list(self.cloud):
                r, s = dot
                top = self.vv.get(r, 0)
                if s == top + 1:
                    self.vv[r] = s
                    self.cloud.discard(dot)
                    moved = True
                elif s <= top:
                    self.cloud.discard(dot)
                    moved = True


def parse_doc(doc: str) -> list[tuple[Path, str]]:
    """Parse a JSON document into its UJSON leaves: (relative-path, token).

    Maps extend the path; sets (JSON arrays) do NOT contribute path
    components, which is exactly why nested sets flatten and sibling maps
    in a set merge (ujson.md:165-170).
    """
    data = json.loads(doc)
    leaves: list[tuple[Path, str]] = []

    def walk(node, path: Path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, list):
            for v in node:
                walk(v, path)
        else:
            leaves.append((path, json.dumps(node)))

    walk(data, ())
    return leaves


def parse_value(doc: str) -> str:
    """Parse a single JSON primitive (INS/RM argument) to its token; raises
    ValueError on maps/sets (ujson.md:83)."""
    data = json.loads(doc)
    if isinstance(data, (dict, list)):
        raise ValueError("value must be a JSON primitive")
    return json.dumps(data)


class UJSON:
    """One document: dot-store + causal context, with delta-mutators.

    Every mutator takes an optional ``delta`` UJSON accumulating the minimal
    joinable state of the mutation (the reference's delta-accumulator
    pattern, repo_ujson.pony:53-66); deltas for the same document within a
    flush window coalesce by join.
    """

    __slots__ = ("entries", "ctx", "_by_path", "_idx_of")

    def __init__(self):
        self.entries: dict[Dot, tuple[Path, str]] = {}
        self.ctx = CausalContext()
        self._by_path: dict[Path, set[Dot]] | None = None
        self._idx_of: dict | None = None

    # -- per-path index over the dot-store ----------------------------------
    #
    # set_doc/rm/clr observe (then remove) the dots at or under a path;
    # scanning every entry per write made write-hot documents quadratic —
    # the measured floor of the all-commands serving mix (bench.py
    # `concurrent`, where 95% of mix time was this scan). The index maps
    # path -> dots, built lazily at the first observe and maintained by
    # the internal mutators; it is keyed on the entries dict's IDENTITY,
    # so consumers that install a fresh entries dict wholesale
    # (LazyWireUJSON._materialize, test fixtures) invalidate it by
    # construction. Code outside this class must never mutate an
    # existing entries dict in place after the doc has served a write —
    # decode paths populate entries only at construction, before any
    # index exists.

    def _index(self) -> dict[Path, set[Dot]]:
        if getattr(self, "_idx_of", None) is not self.entries:
            idx: dict[Path, set[Dot]] = {}
            for d, (p, _) in self.entries.items():
                s = idx.get(p)
                if s is None:
                    s = idx[p] = set()
                s.add(d)
            self._by_path = idx
            self._idx_of = self.entries
        return self._by_path

    def _idx_add(self, dot: Dot, path: Path) -> None:
        if getattr(self, "_idx_of", None) is self.entries:
            s = self._by_path.get(path)
            if s is None:
                s = self._by_path[path] = set()
            s.add(dot)

    def _idx_drop(self, dot: Dot, path: Path) -> None:
        if getattr(self, "_idx_of", None) is self.entries:
            s = self._by_path.get(path)
            if s is not None:
                s.discard(dot)
                if not s:
                    del self._by_path[path]

    def __eq__(self, other) -> bool:
        """Representational equality (see CausalContext.__eq__): used by
        message equality in the codec differential tests."""
        return (
            isinstance(other, UJSON)
            and self.entries == other.entries
            and self.ctx == other.ctx
        )

    __hash__ = None  # see CausalContext.__hash__: mutable, never hashable

    # ---- queries ----------------------------------------------------------

    def _under(self, path: Path) -> list[Dot]:
        n = len(path)
        out: list[Dot] = []
        for p, dots in self._index().items():
            if p[:n] == path:
                out.extend(dots)
        return out

    def is_empty(self) -> bool:
        return not self.entries

    def render(self, path: Path = ()) -> str:
        """Render the subtree at path as compact JSON; "" when absent
        (ujson.md:34-38). Set/map member order is unspecified by the
        semantics; we emit a deterministic sorted order."""
        n = len(path)
        values: set[str] = set()
        children: dict[str, bool] = {}
        for p, token in self.entries.values():
            if p[:n] != path:
                continue
            if len(p) == n:
                values.add(token)
            else:
                children[p[n]] = True
        if not values and not children:
            return ""
        rendered_map = None
        if children:
            items = sorted(children)
            rendered_map = (
                "{" + ",".join(json.dumps(k) + ":" + self.render(path + (k,)) for k in items) + "}"
            )
        vals = sorted(values)
        if rendered_map is None:
            return vals[0] if len(vals) == 1 else "[" + ",".join(vals) + "]"
        if not vals:
            return rendered_map
        return "[" + ",".join(vals + [rendered_map]) + "]"

    # ---- mutators ---------------------------------------------------------

    def _remove_dots(self, dots, delta: "UJSON | None") -> None:
        """Observed-remove: drop entries and record their dots in our context
        and in the delta's context (no delta entries -> receiver removes).
        A dot the SAME delta window added must also drop out of the
        delta's entries: an entry whose dot its own context covers reads
        as LIVE to any converger, so leaving it would resurrect the
        removed value on every receiver that had not yet seen the add
        (same-window SET+RM over anti-entropy, journal replay)."""
        for d in dots:
            pv = self.entries.pop(d, None)
            if pv is not None:
                self._idx_drop(d, pv[0])
            self.ctx.add(d)
            if delta is not None:
                dpv = delta.entries.pop(d, None)
                if dpv is not None:
                    delta._idx_drop(d, dpv[0])
                delta.ctx.add(d)

    def _add_leaf(self, replica: int, path: Path, token: str, delta) -> None:
        dot = self.ctx.next_dot(replica)
        self.entries[dot] = (path, token)
        self._idx_add(dot, path)
        if delta is not None:
            delta.entries[dot] = (path, token)
            delta._idx_add(dot, path)
            delta.ctx.add(dot)

    def set_doc(self, replica: int, path: Path, doc: str, delta=None) -> None:
        """SET: clear the subtree (observed dots only), then add the parsed
        leaves under fresh dots (ujson.md:44-61)."""
        leaves = parse_doc(doc)
        self._remove_dots(self._under(path), delta)
        for sub, token in leaves:
            self._add_leaf(replica, path + sub, token, delta)

    def ins(self, replica: int, path: Path, value: str, delta=None) -> None:
        """INS: add one primitive alongside existing values (ujson.md:77-89)."""
        self._add_leaf(replica, path, parse_value(value), delta)

    def rm(self, replica: int, path: Path, value: str, delta=None) -> None:
        """RM: remove the observed dots of one exact (path, value) pair
        (ujson.md:91-103)."""
        token = parse_value(value)
        dots = [
            d
            for d in self._index().get(path, ())
            if self.entries[d][1] == token
        ]
        self._remove_dots(dots, delta)

    def clr(self, replica: int, path: Path, delta=None) -> None:
        """CLR: remove all observed dots at or under path (ujson.md:63-75)."""
        self._remove_dots(self._under(path), delta)

    # ---- lattice ----------------------------------------------------------

    def converge(self, other: "UJSON") -> bool:
        """ORSWOT join; returns True if local state changed."""
        changed = False
        # entries present only here, observed (covered) by other -> removed
        for d in list(self.entries):
            if d not in other.entries and other.ctx.contains(d):
                pv = self.entries.pop(d)
                self._idx_drop(d, pv[0])
                changed = True
        # entries present only there, not covered by us -> added
        for d, pv in other.entries.items():
            if d not in self.entries and not self.ctx.contains(d):
                self.entries[d] = pv
                self._idx_add(d, pv[0])
                changed = True
        before = (dict(self.ctx.vv), set(self.ctx.cloud))
        self.ctx.join(other.ctx)
        if (self.ctx.vv, self.ctx.cloud) != before:
            changed = True
        return changed
