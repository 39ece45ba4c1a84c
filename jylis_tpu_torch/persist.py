"""Snapshot / restore: a snapshot is a full-state delta dump.

The port's copy of jylis_tpu/persist.py, with ``snapshot_name`` and
``list_snapshots`` from jylis_tpu/lanes.py:147-162 (the port runs no
lanes, so its node writes ``snapshot.jylis``; a lane file that a JAX
node with ``--lanes`` wrote still restores). For every data type and
SYSTEM, every key's complete joinable state in the per-type wire-delta
format the cluster codec speaks (cluster/codec.py), so restoring is
converging the batches back in: a stale snapshot loaded into a live node
joins with what it holds. The bytes are the JAX package's: a port node
restores a JAX node's file and the reverse.

File format: magic, the codec's DELTA-schema signature (a file whose
per-type delta encodings are incompatible is refused; transport-only
schema changes keep old files loadable), then one framed
``MsgPushDeltas`` per type, in the Database's map order.

On a card, the restore converges every type batch into host buffers and
then ``drain_all`` lands the whole keyspace on the device in one burst
of drain kernels (dense where a batch covers a quarter of a keyspace or
more); both run under the node's device scope.
"""

from __future__ import annotations

import os

from . import faults
from .cluster import codec
from .cluster.framing import FrameReader, FramingError, frame
from .cluster.msg import MsgPushDeltas

MAGIC = b"JYLSNAP1"

# how many type batches a snapshot of each legacy era wrote: the v1-v3
# full-signature era and the v4-v6 delta-signature era had five data
# types + SYSTEM; the v7/v8 era added TENSOR. Keyed by the header digests
# in codec.legacy_snapshot_signatures() order (v1, v2, v3, v1-v6 delta,
# v7/v8 delta).
_LEGACY_TYPE_BATCHES = dict(
    zip(codec.legacy_snapshot_signatures(), (6, 6, 6, 6, 7))
)


def snapshot_name(lane_id: int | None) -> str:
    if lane_id is None:
        return "snapshot.jylis"
    return f"snapshot.lane{lane_id}.jylis"


def list_snapshots(data_dir: str) -> list[str]:
    """Every snapshot file under any lane naming, sorted: boot restores
    all of them (restore is lattice convergence; overlap is a no-op)."""
    out = []
    for fname in sorted(os.listdir(data_dir)):
        if fname == "snapshot.jylis" or (
            fname.startswith("snapshot.lane") and fname.endswith(".jylis")
        ):
            out.append(os.path.join(data_dir, fname))
    return out


def save_snapshot(database, path: str) -> None:
    """Atomic (write-then-rename) full-state snapshot of every repo, each
    dumped on the node's device."""
    with database._device_scope():
        write_snapshot(
            ((mgr.name, mgr.repo.dump_state()) for mgr in database.managers()),
            path,
        )


def write_snapshot(batches, path: str) -> None:
    """Atomic snapshot from (name, batch) pairs: the online snapshot path
    dumps each type under its own repo lock (Database.dump_state_async)
    and hands the batches here; a crash mid-write leaves the previous
    file intact (write-then-rename)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(codec.delta_signature())
        for name, batch in batches:
            # snapshot.write (per type frame): error -> OSError out of
            # here, the caller logs it and the journal keeps the deltas;
            # corrupt/drop -> the next boot's validation refuses the file
            data = faults.point(
                "snapshot.write",
                frame(codec.encode(MsgPushDeltas(name, tuple(batch)))),
            )
            if data is not None:
                f.write(data)
    os.replace(tmp, path)


class SnapshotError(Exception):
    pass


def load_snapshot(database, path: str) -> int:
    """Converge a snapshot file into the database; returns the number of
    type batches loaded. Raises SnapshotError on any unreadable, corrupt,
    incompatible or incomplete file; nothing is converged unless the
    whole file validates."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
        # snapshot.load: error -> "cannot read" below; corrupt -> the
        # validation refuses; drop -> treated as unreadable
        blob = faults.point("snapshot.load", blob)
    except OSError as e:
        raise SnapshotError(f"cannot read snapshot: {e}") from None
    if blob is None:
        raise SnapshotError("snapshot dropped by failpoint")
    if blob[: len(MAGIC)] != MAGIC:
        raise SnapshotError("not a snapshot file")
    sig_end = len(MAGIC) + len(codec.delta_signature())
    header = blob[len(MAGIC) : sig_end]
    accepted = (codec.delta_signature(),) + codec.legacy_snapshot_signatures()
    if header not in accepted:
        # not loadable by this build: main.py moves the file aside as
        # .unreadable rather than deleting it
        raise SnapshotError("snapshot schema signature mismatch")
    # read whole from local disk: no peer to bound against, so lift the
    # wire-oriented frame cap
    frames = FrameReader(max_frame=1 << 62)
    frames.append(blob[sig_end:])
    msgs = []
    try:
        for body in frames:
            msg = codec.decode(body)
            if not isinstance(msg, MsgPushDeltas):
                raise SnapshotError("unexpected message in snapshot")
            msgs.append(msg)
    except (codec.CodecError, FramingError) as e:
        raise SnapshotError(f"corrupt snapshot: {e}") from None
    if frames.pending():
        raise SnapshotError("truncated snapshot (partial trailing frame)")
    expected = len(list(database.managers()))
    if header == codec.delta_signature():
        if len(msgs) != expected:
            raise SnapshotError(
                f"snapshot has {len(msgs)} type batches, expected "
                f"{expected} (truncated at a frame boundary?)"
            )
    else:
        # a legacy-era file carries exactly its era's type count (the
        # current count too: a current-shape file under a legacy header
        # loads), so a cut at a frame boundary stays detectable
        era = _LEGACY_TYPE_BATCHES.get(header)
        allowed = {expected} if era is None else {era, expected}
        if len(msgs) not in allowed:
            raise SnapshotError(
                f"legacy snapshot has {len(msgs)} type batches, "
                f"expected one of {sorted(allowed)} (truncated at a "
                "frame boundary?)"
            )
    # fully validated: only now touch the database
    with database._device_scope():
        for msg in msgs:
            database.manager(msg.name).repo.load_state(list(msg.batch))
        # restored state lands on the device now: converge only buffers,
        # and a whole snapshot left in host buffers would bypass the
        # drain thresholds and tax every read
        database.drain_all()
    return len(msgs)
