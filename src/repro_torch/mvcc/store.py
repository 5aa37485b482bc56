"""In-memory multiversion storage (the paper's PostgreSQL-heap analogue).

Every key maps to a chain of committed versions, newest last.  Versions carry
(commit_seq, writer txn id, value).  Version 0 (writer T0==0, commit_seq 0) is
the initial version of every key.  Uncommitted writes never enter the chain —
transactions buffer their writesets until commit (install-at-commit, which
makes First-Committer-Wins the natural SI-W rule).

GC: `prune(floor_seq)` drops versions strictly older than the newest version
at-or-below `floor_seq` per key — the replica/PRoT pin (hot_standby_feedback
analogue) sets the floor.
"""

from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, Optional


@dataclass(frozen=True)
class Version:
    commit_seq: int
    writer: int
    value: Any


class VersionChain:
    __slots__ = ("versions",)

    def __init__(self, initial: Any = 0) -> None:
        self.versions: list[Version] = [Version(0, 0, initial)]

    def install(self, commit_seq: int, writer: int, value: Any) -> None:
        assert commit_seq > self.versions[-1].commit_seq
        self.versions.append(Version(commit_seq, writer, value))

    def newest(self) -> Version:
        return self.versions[-1]

    def visible_at(self, snapshot_seq: int) -> Version:
        """SI-V: newest version with commit_seq <= snapshot_seq."""
        seqs = [v.commit_seq for v in self.versions]
        i = bisect_right(seqs, snapshot_seq) - 1
        return self.versions[max(i, 0)]

    def visible_in(self, member: Callable[[int, int], bool]) -> Version:
        """RSS read protocol: newest version whose writer is in the snapshot
        set (walk newest-to-oldest; RSS closure guarantees consistency).
        `member` is called with (writer txn id, commit seq) — the seq lets
        compressed snapshots resolve floor-covered members without per-txn
        bookkeeping (`RssSnapshot.visible`)."""
        for v in reversed(self.versions):
            if v.writer == 0 or member(v.writer, v.commit_seq):
                return v
        return self.versions[0]

    def prune(self, floor_seq: int) -> int:
        """Drop versions not visible at any snapshot >= floor_seq."""
        seqs = [v.commit_seq for v in self.versions]
        i = bisect_right(seqs, floor_seq) - 1
        if i > 0:
            dropped = i
            self.versions = self.versions[i:]
            return dropped
        return 0


class Store:
    def __init__(self) -> None:
        self.chains: dict[str, VersionChain] = {}

    def chain(self, key: str) -> VersionChain:
        ch = self.chains.get(key)
        if ch is None:
            ch = self.chains[key] = VersionChain()
        return ch

    def keys(self) -> Iterator[str]:
        return iter(self.chains)

    def newest_seq(self) -> int:
        return max((c.newest().commit_seq for c in self.chains.values()),
                   default=0)

    def prune(self, floor_seq: int) -> int:
        return sum(c.prune(floor_seq) for c in self.chains.values())

    def version_count(self) -> int:
        return sum(len(c.versions) for c in self.chains.values())
