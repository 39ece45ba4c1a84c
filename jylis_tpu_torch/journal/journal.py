"""Append-only framed delta journal: crash durability between snapshots.

The port's copy of jylis_tpu/journal/journal.py: the same file format,
byte for byte, so a port node replays a JAX node's segment and the
reverse. The writer thread encodes through the port's codec (its
native path is stateless: no engine handle is shared with the serving
loop). Every flushed batch a repo hands over is built fresh at flush
time and owned by the journal from then on (no tensor, plane or engine
buffer aliases into it), so encoding it later on the writer thread reads
what was flushed.

Snapshots (persist.py) are periodic full-state dumps, so a whole-node
crash loses every delta accepted since the last one unless a peer holds
it. Delta-state CRDTs make the fix unusually clean (Almeida et al.,
arXiv:1410.2803): a journal of flushed delta BATCHES needs no ordering,
no dedup, and no replay-log semantics — recovery is literally converge,
the same lattice join the cluster codec already exercises. The journal
is the snapshot format's streaming sibling: the same MAGIC-then-
delta-signature header, the same framed ``MsgPushDeltas`` bodies in the
exact cluster wire-delta encoding — guarded by the same schema
signature, so a build whose delta encodings changed refuses the file
instead of corrupting.

File format::

    MAGIC (8 bytes)  codec.delta_signature() (32 bytes)
    frame( crc32(payload):u32be + payload )*    # framing.py frames

where each payload is one ``codec.encode(MsgPushDeltas(name, batch))``.
The one divergence from the snapshot body is the 4-byte CRC inside each
frame: a snapshot is written whole-then-renamed (torn writes impossible,
any decode failure IS corruption), while a journal lives mid-write by
design — the CRC is what separates a mid-file bit flip (refused, file
moved aside) from a torn trailing frame (truncation: appends are
sequential, so a crash mid-append leaves a byte PREFIX of a valid frame
and nothing after it — the tail is cut back to the last complete frame
and recovery proceeds).

Threading: ``append`` only enqueues; a dedicated writer thread does the
encode + write + fsync. The flush paths run on the serving event loop,
and paying a large TLOG/UJSON batch's wire encode (plus fsync latency)
inline would tax every client the loop is serving. The writer preserves
append order, ``flush()``/``close()`` drain the queue, and rotation drains
before touching files. The durability point is therefore "flushed, then
journaled within the writer's (millisecond) lag": a SIGKILL loses at
most the still-queued tail — every batch the writer has written is
recoverable under any fsync policy, because each write pushes through
Python's userspace buffer to the OS.

Compaction: the journal grows until ``max_bytes``, then asks for
rotation (``rotate_notify``): the owner cuts a fresh snapshot through
the existing ``persist.write_snapshot`` path AFTER ``rotate_begin()``
renamed the active segment aside — every delta flushed after the cut
lands in the fresh segment and the snapshot covers everything before
it, so snapshot + live segment is complete by construction (overlap is
a lattice no-op). ``rotate_commit()`` retires the old segment only once
the snapshot is durably on disk; a crash anywhere in between leaves the
``.retiring`` segment for boot recovery to replay.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from collections import deque

from .. import faults
from ..cluster import codec
from ..cluster.framing import FrameReader, FramingError, frame
from ..cluster.msg import MsgPushDeltas
from ..utils import metrics

MAGIC = b"JYLJRNL1"
_SIG_LEN = 32
HEADER_LEN = len(MAGIC) + _SIG_LEN
_CRC_LEN = 4

FSYNC_ALWAYS = "always"
FSYNC_INTERVAL = "interval"
FSYNC_OFF = "off"


class JournalError(Exception):
    """Unreadable / corrupt / schema-incompatible journal segment. The
    caller decides whether that is fatal; ``recover`` moves the segment
    aside as ``.unreadable`` (like main.py does for snapshots) and
    boots on."""


# the cluster's held-delta filter and the journal ask the same question
# ("does this batch carry joinable content?") — one shared predicate,
# owned by the codec beside the per-type delta shapes it peeks into
worth_journaling = codec.batch_has_content


class Journal:
    """The append side. One condition variable guards the queue AND the
    file state; the writer thread is the only encoder/writer, so frames
    land in append order without any further coordination."""

    def __init__(
        self,
        path: str,
        fsync: str = FSYNC_INTERVAL,
        fsync_interval: float = 0.2,
        max_bytes: int = 64 << 20,
        clock=time.monotonic,
        registry=None,
    ):
        if fsync not in (FSYNC_ALWAYS, FSYNC_INTERVAL, FSYNC_OFF):
            raise ValueError(f"unknown fsync policy: {fsync}")
        # the owning Database's MetricsRegistry (main.py passes it);
        # registry-less direct drives record into the process DEFAULT —
        # counters, the append/fsync latency histograms, and the trace
        # ring all ride this one handle
        self._reg = registry if registry is not None else metrics.DEFAULT
        self._h_append = self._reg.hist("journal.append")
        self._h_fsync = self._reg.hist("journal.fsync")
        self._path = path
        self._fsync = fsync
        self._fsync_interval = fsync_interval
        self._max_bytes = max_bytes
        self._clock = clock
        self._cv = threading.Condition()
        self._q: deque = deque()
        self._busy = False  # writer mid-encode/mid-write
        self._paused = False  # rotation owns the file; writer sleeps
        self._stop = False
        self._worker: threading.Thread | None = None
        self._f = None
        self._size = 0
        self._last_sync = None
        self._dirty = False  # bytes written since the last fsync
        self._rotation_asked = False
        self.last_error: Exception | None = None  # writer-side encode bug
        # the owner points this at a loop-threadsafe wakeup for the
        # compaction loop; called at most once per threshold crossing
        self.rotate_notify = None

    @property
    def path(self) -> str:
        return self._path

    def retiring_path(self) -> str:
        return self._path + ".retiring"

    # ---- lifecycle ---------------------------------------------------------

    def open(self) -> None:
        """Open (or create) the active segment and start the writer.
        Call AFTER ``recover``: recovery is what validates the header and
        truncates any torn tail; this method trusts an existing
        well-sized file."""
        with self._cv:
            if (
                os.path.exists(self._path)
                and os.path.getsize(self._path) >= HEADER_LEN
            ):
                # boot: no writer thread, no serving loop
                self._f = open(self._path, "ab")
                self._size = os.path.getsize(self._path)
            else:
                # boot: no writer thread, no serving loop; nothing
                # else can contend for _cv yet
                self._open_fresh_locked()
            self._stop = False
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._run, name="jylis-journal", daemon=True
                )
                self._worker.start()

    def _open_fresh_file(self):
        """Open a fresh segment and write its header; touches NO shared
        state, so both the boot path (under ``_cv``) and rotation (under
        the ``_paused`` hand-off, outside the lock) share it — the one
        place the header bytes are spelled. Returns ``(file, synced_at)``
        where ``synced_at`` is the fsync clock stamp or None."""
        f = open(self._path, "wb")
        try:
            f.write(MAGIC + codec.delta_signature())
            f.flush()
            synced_at = None
            if self._fsync != FSYNC_OFF:
                os.fsync(f.fileno())
                synced_at = self._clock()
        except OSError:
            # a failed header write (ENOSPC) must not leak the fd: the
            # rotation retry path re-opens per attempt, and leaking one
            # per retry would turn a full disk into EMFILE
            f.close()
            raise
        return f, synced_at

    def _open_fresh_locked(self) -> None:
        # boot path: the caller (open) holds _cv and the writer thread
        # does not exist yet, so these stores are serialised
        self._f, synced_at = self._open_fresh_file()
        if synced_at is not None:
            self._last_sync = synced_at
        self._size = HEADER_LEN
        self._dirty = False
        self._rotation_asked = False

    def close(self) -> None:
        """Drain the queue, stop the writer, fsync, close."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        worker = self._worker
        if worker is not None and worker is not threading.current_thread():
            worker.join()
        with self._cv:
            if self._f is None:
                return
            self._f.flush()
            if self._fsync != FSYNC_OFF:
                # terminal: the writer is already joined and appends are
                # rejected, nothing contends for _cv
                os.fsync(self._f.fileno())
            self._f.close()
            self._f = None

    def flush(self) -> None:
        """Block until every enqueued batch is on disk (tests, quiesce)."""
        with self._cv:
            self._drain_locked()

    def size(self) -> int:
        with self._cv:
            return self._size

    def needs_rotation(self) -> bool:
        """True when the active segment is at/over the compaction
        threshold — checked by the compaction loop right after it
        installs rotate_notify, so a segment already oversized at boot
        (a crash beat the previous compaction) still rotates."""
        with self._cv:
            return self._size >= self._max_bytes

    # ---- append ------------------------------------------------------------

    def append(self, name: str, batch) -> None:
        """Enqueue one flushed delta batch for the writer thread. The
        caller's ``batch`` is exported, immutable flush output — safe to
        encode later without copying."""
        if not worth_journaling(name, batch):
            return
        with self._cv:
            if self._stop:
                return  # closing: a late flush raced clean shutdown
            self._q.append((name, batch))
            self._cv.notify_all()

    def _drain_locked(self) -> None:
        # _paused too: "drained" must mean on THIS segment's disk, and —
        # since rotate_begin drains first — it is also what serialises
        # two rotations against each other (shutdown's final rotation
        # can overlap the compaction loop's in-flight one: cancelling
        # the loop task cannot stop its to_thread worker)
        while self._q or self._busy or self._paused:
            self._cv.wait()

    # ---- the writer thread -------------------------------------------------

    def _run(self) -> None:
        # While _busy is set, the writer OWNS self._f and the fsync
        # bookkeeping (_last_sync/_dirty): rotation and close wait the
        # flag out before touching the file, so all disk I/O below runs
        # OUTSIDE the condition variable — append() on the serving loop
        # only ever contends for the brief state mutations.
        while True:
            item = None
            idle_sync = False
            with self._cv:
                while self._paused or (not self._q and not self._stop):
                    if self._paused:
                        # rotation owns the file: sleep until it installs
                        # the fresh segment (appends keep enqueueing)
                        self._cv.wait()
                        continue
                    # under the interval policy an unsynced tail must
                    # NOT wait for the next append (the CLI promises a
                    # bounded power-loss window): when idle with dirty
                    # bytes, sleep only until the interval is due and
                    # fsync then
                    wait_s = None
                    if (
                        self._fsync == FSYNC_INTERVAL
                        and self._dirty
                        and self._f is not None
                    ):
                        due = (self._last_sync or 0.0) + self._fsync_interval
                        now = self._clock()
                        if now >= due:
                            idle_sync = True
                            break
                        wait_s = max(due - now, 0.005)
                    self._cv.wait(wait_s)
                if not idle_sync:
                    if not self._q:
                        return  # stopping and drained
                    item = self._q.popleft()
                self._busy = True
                f = self._f
            if idle_sync:
                try:
                    synced = self._sync_file(f)
                    if synced:
                        self._reg.note_journal("fsyncs")
                finally:
                    with self._cv:
                        self._busy = False
                        self._cv.notify_all()
                continue
            name, batch = item
            ask = False
            wrote = 0
            synced = False
            try:
                data = None
                try:
                    payload = codec.encode(MsgPushDeltas(name, tuple(batch)))
                    data = frame(
                        struct.pack(">I", zlib.crc32(payload)) + payload
                    )
                except Exception as e:  # an encode bug
                    # must not kill the writer thread (a dead writer
                    # silently ends durability); recorded via last_error
                    # and the JOURNAL errors counter
                    self.last_error = e
                    self._reg.note_journal("errors")
                    self._reg.trace_event("journal", "error", "encode", repr(e))
                if data is not None and f is None:
                    # no active segment (a failed rotation): the batch
                    # cannot be made durable — count the drop instead of
                    # losing it silently (peers/snapshots still hold it),
                    # and re-ask for rotation: it is what re-opens the
                    # segment, and in size-triggered-only mode
                    # (--snapshot-interval 0) nothing else ever would.
                    # Paced to append cadence, so a dead disk retries
                    # per flush, not in a hot loop.
                    self._reg.note_journal("errors")
                    self._reg.trace_event("journal", "error", "no_segment")
                    with self._cv:
                        if (
                            not self._rotation_asked
                            and self.rotate_notify is not None
                        ):
                            self._rotation_asked = True
                            ask = True
                if data is not None and f is not None:
                    try:
                        # journal.append: error -> the OSError recovery
                        # below (counted, writer survives); corrupt ->
                        # boot replay's CRC refusal; drop -> this batch
                        # silently never reaches disk (peers still hold
                        # it — the drill's local-durability-loss case)
                        data = faults.point("journal.append", data)
                        if data is not None:
                            t0 = time.perf_counter() if self._reg.enabled else 0.0
                            f.write(data)
                            # push past userspace buffering: a SIGKILL
                            # must lose at most the queued tail, never
                            # batches parked in Python's file buffer
                            f.flush()
                            if t0:
                                self._h_append.record(time.perf_counter() - t0)
                            wrote = len(data)
                            # _busy protocol: while set, the writer owns
                            # _f and the fsync bookkeeping — rotation and
                            # close wait the flag out
                            self._dirty = True
                            if self._fsync == FSYNC_ALWAYS or (
                                self._fsync == FSYNC_INTERVAL
                                and (
                                    self._last_sync is None
                                    or self._clock() - self._last_sync
                                    >= self._fsync_interval
                                )
                            ):
                                synced = self._sync_file(f)
                    except OSError as e:  # full disk etc: keep the writer
                        self.last_error = e
                        self._reg.note_journal("errors")
                        self._reg.trace_event("journal", "error", "append", repr(e))
                with self._cv:
                    if wrote:
                        self._size += wrote
                        # latch the rotation request only when someone is
                        # listening: before the compaction loop installs
                        # rotate_notify (or without one at all), latching
                        # would swallow the request for the whole segment
                        # — the loop ALSO checks needs_rotation() when it
                        # installs the hook, covering a journal already
                        # oversized at boot
                        if (
                            self._size >= self._max_bytes
                            and not self._rotation_asked
                            and self.rotate_notify is not None
                        ):
                            self._rotation_asked = True
                            ask = True
                if wrote:
                    self._reg.note_journal("appends")
                    self._reg.note_journal("bytes", wrote)
                if synced:
                    self._reg.note_journal("fsyncs")
                notify = self.rotate_notify
                if ask and notify is not None:
                    notify()
            finally:
                # busy clears only after the metrics/rotation side
                # effects, so flush() returning means they happened too
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def _sync_file(self, f) -> bool:
        """fsync + bookkeeping; writer-thread only (or under drain)."""
        try:
            # journal.fsync: error -> the recovery below (counted, sync
            # skipped, durability window widens); sleep -> a slow disk
            # (writer thread stalls, serving-loop appends keep queueing)
            faults.point("journal.fsync")
            t0 = time.perf_counter() if self._reg.enabled else 0.0
            os.fsync(f.fileno())
            if t0:
                self._h_fsync.record(time.perf_counter() - t0)
        except OSError as e:
            self.last_error = e
            self._reg.note_journal("errors")
            self._reg.trace_event("journal", "error", "fsync", repr(e))
            return False
        # writer-owns-file protocol (see _run): only the writer (or a
        # drain-holding caller) reaches here
        self._last_sync = self._clock()
        self._dirty = False
        return True

    # ---- rotation (size-triggered compaction) ------------------------------

    def rotate_begin(self) -> None:
        """Retire the active segment and start a fresh one. The caller
        then cuts a snapshot (persist.write_snapshot) and, on success,
        calls ``rotate_commit``; on failure the retired segment simply
        stays — recovery replays snapshot + retiring + active, and the
        next rotation folds the segments together.

        All disk I/O here runs OUTSIDE the condition variable, under the
        ``_paused`` hand-off: the writer sleeps, ``_f`` is detached, and
        serving-loop ``append()`` calls keep enqueueing at memory speed
        for the whole fsync + fold + rename (holding ``_cv`` across it
        would stall every append, and with it the event loop, behind
        the disk for up to a full 64 MB segment fold)."""
        self._reg.trace_event("journal", "rotate")
        with self._cv:
            self._drain_locked()  # queued batches belong to the OLD cut
            self._paused = True  # writer sleeps; appends only enqueue
            f = self._f
            self._f = None
        fresh = None
        synced_at = None
        try:
            # journal.rotate: error -> the failed-rotation path below
            # (writer resumes with no active segment, re-asks, retries);
            # crash -> dies between drain and rename, leaving .retiring
            # for boot recovery — the exact window the format defends
            faults.point("journal.rotate")
            if f is not None:
                try:
                    f.flush()
                    os.fsync(f.fileno())  # rename only what is durable
                finally:
                    f.close()  # even when the fsync fails: no fd leak
                    # per retry — the segment itself stays on disk for
                    # the next attempt either way
            retiring = self.retiring_path()
            # guard on the active segment existing: a prior failed
            # rotation may have renamed it aside and then died before
            # opening the fresh one — the retry must not wedge on the
            # missing file, just re-open and carry on
            if os.path.exists(self._path):
                if os.path.exists(retiring):
                    # the previous rotation's snapshot never landed: fold
                    # the just-closed segment into the retiring one (both
                    # are valid framed streams with identical headers, so
                    # frames concatenate into a valid stream — join order
                    # is free)
                    with open(self._path, "rb") as src, \
                            open(retiring, "ab") as dst:
                        src.seek(HEADER_LEN)
                        while True:
                            chunk = src.read(1 << 20)
                            if not chunk:
                                break
                            dst.write(chunk)
                        dst.flush()
                        os.fsync(dst.fileno())
                    os.remove(self._path)
                else:
                    os.replace(self._path, retiring)
            fresh, synced_at = self._open_fresh_file()
        except OSError as e:
            # a failed rotation must never leave the writer paused
            # forever: record, resume on whatever file state we reached.
            # ``_f`` may stay None — batches then drain undurable (each
            # counted as a JOURNAL error) until the next successful
            # rotation re-opens the segment; the snapshot loop keeps
            # retrying on its interval
            self.last_error = e
            self._reg.note_journal("errors")
            self._reg.trace_event("journal", "error", "rotate", repr(e))
        finally:
            with self._cv:
                self._f = fresh
                if fresh is not None:
                    self._size = HEADER_LEN
                    self._dirty = False
                    if synced_at is not None:
                        self._last_sync = synced_at
                # unlatch even on failure: the writer re-asks on its
                # next undurable drop, which is the retry path that
                # eventually re-opens the segment
                self._rotation_asked = False
                self._paused = False
                self._cv.notify_all()

    def rotate_commit(self) -> None:
        """The snapshot superseding the retired segment is durable:
        delete it. A plain unlink that touches no shared state — taking
        ``_cv`` here would only serialise appends behind the disk."""
        try:
            os.remove(self.retiring_path())
        except FileNotFoundError:
            pass


# ---- replay / recovery ------------------------------------------------------


def read_journal(path: str):
    """Parse one journal segment WITHOUT touching any database: returns
    ``(msgs, good_end, total)`` where ``good_end < total`` means a torn
    trailing frame (bytes past ``good_end`` are a partial frame — crash
    mid-append, not corruption). Raises JournalError on anything else
    unreadable; FileNotFoundError passes through for the caller."""
    with open(path, "rb") as f:
        blob = f.read()
    header = MAGIC + codec.delta_signature()
    if len(blob) < HEADER_LEN:
        # a prefix of a valid header is a file torn during creation —
        # nothing was ever appended; anything else is not a journal
        if blob == header[: len(blob)]:
            return [], 0, len(blob)
        raise JournalError("not a journal file")
    if blob[: len(MAGIC)] != MAGIC:
        raise JournalError("not a journal file")
    accepted = (codec.delta_signature(),) + codec.legacy_delta_signatures()
    if blob[len(MAGIC) : HEADER_LEN] not in accepted:
        # NOT loadable by this build: the caller moves the file aside as
        # .unreadable rather than deleting the only copy. Legacy delta
        # signatures (pre-v7, before delta/TENSOR) ARE loadable: their
        # frames carry only old-type payloads this codec still decodes.
        raise JournalError("journal schema signature mismatch")
    # local-disk read, like snapshots: lift the wire-oriented frame cap
    frames = FrameReader(max_frame=1 << 62)
    frames.append(blob[HEADER_LEN:])
    msgs = []
    try:
        for body in frames:
            if len(body) < _CRC_LEN:
                raise JournalError("corrupt journal: frame shorter than CRC")
            (crc,) = struct.unpack(">I", body[:_CRC_LEN])
            payload = body[_CRC_LEN:]
            if zlib.crc32(payload) != crc:
                raise JournalError("corrupt journal: frame CRC mismatch")
            msg = codec.decode(payload)
            if not isinstance(msg, MsgPushDeltas):
                raise JournalError("unexpected message in journal")
            msgs.append(msg)
    except (codec.CodecError, FramingError) as e:
        # a complete frame that fails to parse can only be corruption:
        # appends are sequential, so torn writes never complete a frame
        raise JournalError(f"corrupt journal: {e}") from None
    return msgs, len(blob) - frames.pending(), len(blob)


def replay_journal(database, path: str, truncate_tail: bool = True) -> int:
    """Converge one journal segment into the database; returns the
    number of batches replayed (0 for a missing file). A torn trailing
    frame is truncation: the file is cut back to its last complete frame
    and everything before it converges. Raises JournalError on any
    OTHER unreadable file — and like snapshot loading, nothing is
    converged unless the readable part fully validates first."""
    try:
        # journal.replay: error -> JournalError -> recover() moves the
        # segment aside (.unreadable) and boots on, healing from peers
        faults.point("journal.replay")
        msgs, good_end, total = read_journal(path)
    except FileNotFoundError:
        return 0
    except OSError as e:
        raise JournalError(f"cannot read journal: {e}") from None
    if truncate_tail and good_end < total:
        os.truncate(path, good_end)
    if truncate_tail and _header_is_legacy(path):
        # a legacy-delta-signature segment is about to be APPENDED to by
        # this build's Journal.open(): re-stamp it in the current schema
        # first, or new-type frames would land in a file whose header
        # promises the old delta encodings (a rolled-back build would
        # then classify the whole segment as corrupt mid-replay instead
        # of refusing it cleanly at the header). Foreign lane segments
        # (truncate_tail=False) belong to live siblings and are never
        # touched.
        _migrate_legacy_segment(path, msgs)
    # fully validated: only now touch the database. load_state (not bare
    # converge) for the same reason snapshots use it: this node's own
    # counter columns are private monotonic state — converging them as
    # foreign would let the next INC vanish under the pending max.
    with database._device_scope():
        for msg in msgs:
            database.manager(msg.name).repo.load_state(list(msg.batch))
        if msgs:
            # land replayed state on the device now (persist.py's
            # rationale: a boot-sized host pending buffer taxes every read)
            database.drain_all()
    if msgs:
        _db_registry(database).note_journal("replayed_batches", len(msgs))
    return len(msgs)


def _header_is_legacy(path: str) -> bool:
    with open(path, "rb") as f:
        hdr = f.read(HEADER_LEN)
    return (
        len(hdr) == HEADER_LEN
        and hdr[: len(MAGIC)] == MAGIC
        and hdr[len(MAGIC):] != codec.delta_signature()
    )


def _migrate_legacy_segment(path: str, msgs) -> None:
    """Atomically rewrite a validated legacy segment under the CURRENT
    delta signature (same batches, re-encoded — the delta content is
    schema-compatible by the legacy-acceptance contract). Write-then-
    rename like snapshots: a crash leaves either the old valid file or
    the new valid file, never a torn one."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC + codec.delta_signature())
        for msg in msgs:
            payload = codec.encode(msg)
            f.write(frame(struct.pack(">I", zlib.crc32(payload)) + payload))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _db_registry(database):
    """The database's MetricsRegistry, or the process DEFAULT for bare
    drivers (the replay helpers take any converge-shaped object)."""
    return metrics.resolve_registry(database)


def segment_name(lane_id: int | None) -> str:
    """The journal segment filename for a lane (None / lane-less nodes
    keep the classic ``journal.jylis``; lane k writes
    ``journal.lane<k>.jylis`` so N lanes append independently)."""
    if lane_id is None:
        return "journal.jylis"
    return f"journal.lane{lane_id}.jylis"


def list_segments(data_dir: str) -> list[str]:
    """Every journal segment path in ``data_dir``, ANY lane naming —
    the classic ``journal.jylis`` plus every ``journal.lane<k>.jylis``
    (``.retiring``/``.unreadable`` variants are handled by recover,
    not listed here). Sorted for deterministic replay order (order is
    a formality: replay is lattice join)."""
    out = []
    for fname in sorted(os.listdir(data_dir)):
        if fname == "journal.jylis" or (
            fname.startswith("journal.lane") and fname.endswith(".jylis")
        ):
            out.append(os.path.join(data_dir, fname))
    return out


def recover_all(database, data_dir: str, own_path: str, log=None) -> int:
    """Boot-path MERGE replay for multi-lane nodes: every lane's
    segment (and its ``.retiring`` sibling) converges into this
    database. Lattice join makes cross-segment overlap harmless, and a
    node rebooted with a DIFFERENT lane count (or ``--lanes 1``) still
    recovers every lane's accepted writes — segments are disjoint by
    acceptance (each lane journals only batches its own serving path
    flushed), and their union is the node's whole journaled state.

    Only the lane's OWN segment (``own_path``) gets the mutating
    recovery (torn-tail truncation, ``.unreadable`` move-aside): a lane
    restarting while its siblings are still serving reads THEIR
    segments mid-append, so a foreign segment's torn tail is the
    owner's live write, not a crash artifact — foreign segments replay
    best-effort with no truncation and no rename, and whatever the
    read missed converges in over the lane bus sync instead."""
    # the own segment recovers unconditionally (its .retiring sibling
    # can exist even when the active file does not — a crash between
    # rotate_begin's rename and the fresh open)
    total = recover(database, own_path, log)
    try:
        segments = list_segments(data_dir)
    except OSError:
        return total
    for path in segments:
        if path == own_path:
            continue
        for p in (path + ".retiring", path):
            try:
                total += replay_journal(database, p, truncate_tail=False)
            except JournalError as e:
                # a foreign lane's problem (or its live mid-write tail):
                # never mutate another lane's file; the owner heals it
                # and the bus sync heals us
                if log is not None:
                    log.warn() and log.w(
                        f"foreign journal segment skipped ({p}): {e}"
                    )
    return total


def recover(database, path: str, log=None) -> int:
    """THE boot-path entry (main.py): replay the retiring segment first
    (present only when a crash interrupted compaction), then the active
    one. An unreadable segment is moved aside as ``.unreadable`` —
    preserving the only copy of whatever it held — and recovery
    continues with the rest; lattice join makes any overlap with the
    snapshot or between segments harmless. Returns batches converged."""
    total = 0
    for p in (path + ".retiring", path):
        try:
            total += replay_journal(database, p)
        except JournalError as e:
            if log is not None:
                log.err() and log.e(f"journal not replayed: {e}")
            _db_registry(database).trace_event(
                "journal", "error", "replay_refused", str(e)
            )
            aside = p + ".unreadable"
            try:
                os.replace(p, aside)
                if log is not None:
                    log.err() and log.e(f"moved aside to {aside}")
            except OSError:
                pass
    return total
