"""Safe snapshots (Ports & Grittner) — the paper's principal baseline.

PostgreSQL's READ ONLY DEFERRABLE transactions wait for a *safe snapshot*: a
snapshot taken at a moment when no concurrent read/write transaction is
active (then the read-only transaction can never be part of a dangerous
structure, so SSI validation can be skipped entirely).

This module provides the prefix-level predicate and the reader-wait oracle
used by the `mvcc` engine's SSI+SafeSnapshots mode and by benchmarks to
account reader-wait time — the cost RSS eliminates.
"""

from __future__ import annotations

from .history import History


def snapshot_is_safe(h: History, *, read_only: set[int] = frozenset()) -> bool:
    """True iff taking a snapshot at the current prefix end is *safe*: there
    is no active (begun, unended) read/write transaction.

    `read_only` lists txn ids known to be read-only (they never endanger a
    deferrable snapshot).
    """
    for t in h.active():
        if t not in read_only:
            return False  # any active (potential) writer makes it unsafe
    return True


def earliest_safe_point(h: History, from_pos: int,
                        *, read_only: set[int] = frozenset()) -> int | None:
    """The earliest prefix length >= from_pos at which a snapshot is safe.

    Returns None if no safe point exists within the history (the deferrable
    transaction would still be waiting at the end) — unbounded reader-wait,
    the pathology the paper's Sec. 2.2/6.1 describes.
    """
    for n in range(from_pos, len(h.ops) + 1):
        if snapshot_is_safe(h.prefix(n), read_only=read_only):
            return n
    return None


def reader_wait(h: History, request_pos: int,
                *, read_only: set[int] = frozenset()) -> int | None:
    """Number of history positions a deferrable read-only transaction
    requested at `request_pos` must wait before its snapshot is safe.
    None == never within this history."""
    pt = earliest_safe_point(h, request_pos, read_only=read_only)
    return None if pt is None else pt - request_pos
