"""Delta write-ahead journal (see journal/journal.py)."""

from .journal import (  # noqa: F401
    FSYNC_ALWAYS,
    FSYNC_INTERVAL,
    FSYNC_OFF,
    HEADER_LEN,
    Journal,
    JournalError,
    MAGIC,
    list_segments,
    recover,
    recover_all,
    segment_name,
    replay_journal,
)
