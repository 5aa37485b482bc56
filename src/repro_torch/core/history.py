"""Multiversion histories in the Adya formalization used by the paper.

The paper (Sec. 3) adopts Adya et al.'s multiversion history model with a
version order induced by commit order (the "SI version order" of Schenkel &
Weikum), and calls the serializable class VOCSR (version-ordered
conflict-serializability, PL-3).

A history is a totally ordered sequence of operations:
    b(T)        Begin(T)
    r(T, X, V)  T reads the version of X written by transaction V
    w(T, X)     T writes (installs a new version of) X
    c(T)        Commit(T) == End(T) for committed transactions
    a(T)        Abort(T)  == End(T) for aborted transactions

Version identity: the version of X written by T is denoted (X, T).  The
initial (pre-history) version of every key is (X, T0) with T0 == 0.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Iterator, Optional, Sequence

T0 = 0  # the fictitious initial transaction that installed all initial versions

BEGIN, READ, WRITE, COMMIT, ABORT = "b", "r", "w", "c", "a"


@dataclass(frozen=True)
class Op:
    kind: str              # one of b/r/w/c/a
    txn: int               # transaction id (> 0)
    key: Optional[str] = None
    # for READ ops: id of the transaction that wrote the version being read.
    version: Optional[int] = None

    def __repr__(self) -> str:  # compact, paper-like notation
        if self.kind == READ:
            return f"R{self.txn}({self.key}_{self.version})"
        if self.kind == WRITE:
            return f"W{self.txn}({self.key}_{self.txn})"
        return f"{self.kind.upper()}{self.txn}"


def b(t: int) -> Op:
    return Op(BEGIN, t)


def r(t: int, key: str, version: int) -> Op:
    return Op(READ, t, key, version)


def w(t: int, key: str) -> Op:
    return Op(WRITE, t, key)


def c(t: int) -> Op:
    return Op(COMMIT, t)


def a(t: int) -> Op:
    return Op(ABORT, t)


class History:
    """An (interleaved) multiversion history with helpers used throughout.

    Histories are append-only; every accessor works on the current prefix, so
    the same object can serve as "the current prefix p" while a workload runs.
    """

    def __init__(self, ops: Iterable[Op] = ()) -> None:
        self.ops: list[Op] = []
        # index caches, maintained incrementally
        self._begin_pos: dict[int, int] = {}
        self._end_pos: dict[int, int] = {}
        self._committed: set[int] = set()
        self._aborted: set[int] = set()
        self._writes: dict[int, list[tuple[int, str]]] = {}   # txn -> [(pos, key)]
        self._reads: dict[int, list[tuple[int, str, int]]] = {}  # txn -> [(pos, key, ver)]
        self._txns: set[int] = set()
        for op in ops:
            self.append(op)

    # ------------------------------------------------------------------ build
    def append(self, op: Op) -> None:
        pos = len(self.ops)
        self.ops.append(op)
        t = op.txn
        self._txns.add(t)
        if op.kind == BEGIN:
            self._begin_pos.setdefault(t, pos)
        elif op.kind == COMMIT:
            self._end_pos[t] = pos
            self._committed.add(t)
        elif op.kind == ABORT:
            self._end_pos[t] = pos
            self._aborted.add(t)
        elif op.kind == WRITE:
            self._writes.setdefault(t, []).append((pos, op.key))
            self._begin_pos.setdefault(t, pos)  # implicit begin at first op
        elif op.kind == READ:
            self._reads.setdefault(t, []).append((pos, op.key, op.version))
            self._begin_pos.setdefault(t, pos)

    def extend(self, ops: Iterable[Op]) -> None:
        for op in ops:
            self.append(op)

    def __iter__(self) -> Iterator[Op]:
        return iter(self.ops)

    def __len__(self) -> int:
        return len(self.ops)

    # ---------------------------------------------------------------- queries
    @property
    def txns(self) -> set[int]:
        return set(self._txns)

    @property
    def committed(self) -> set[int]:
        return set(self._committed)

    @property
    def aborted(self) -> set[int]:
        return set(self._aborted)

    def active(self) -> set[int]:
        """Transactions that have begun but not ended in the current prefix."""
        return {t for t in self._txns if t in self._begin_pos and t not in self._end_pos}

    def begin_pos(self, t: int) -> int:
        return self._begin_pos[t]

    def end_pos(self, t: int) -> int:
        """Position of End(T); +inf if T has not ended in this prefix."""
        return self._end_pos.get(t, 1 << 62)

    def is_committed(self, t: int) -> bool:
        return t in self._committed

    def commit_order(self) -> list[int]:
        """Committed transactions in End() order — the SI version order."""
        return sorted(self._committed, key=self._end_pos.__getitem__)

    def reads_of(self, t: int) -> list[tuple[int, str, int]]:
        return list(self._reads.get(t, ()))

    def writes_of(self, t: int) -> list[tuple[int, str]]:
        return list(self._writes.get(t, ()))

    def writeset(self, t: int) -> set[str]:
        return {k for _, k in self._writes.get(t, ())}

    def readset(self, t: int) -> set[str]:
        return {k for _, k, _ in self._reads.get(t, ())}

    def is_read_only(self, t: int) -> bool:
        return not self._writes.get(t)

    def concurrent(self, ta: int, tb: int) -> bool:
        """Lifetime intervals [Begin, End] overlap (paper Sec. 4.3)."""
        if ta == tb:
            return False
        ba, ea = self._begin_pos.get(ta, 1 << 62), self.end_pos(ta)
        bb, eb = self._begin_pos.get(tb, 1 << 62), self.end_pos(tb)
        return not (ea < bb or eb < ba)

    # ------------------------------------------------------------- projections
    def committed_projection(self) -> "History":
        """The committed projection: ops of committed transactions only."""
        keep = self._committed
        return History(op for op in self.ops if op.txn in keep)

    def without_txn(self, t: int) -> "History":
        """h' in Theorem 4.4: h with all operations of txn t removed."""
        return History(op for op in self.ops if op.txn != t)

    def prefix(self, n: int) -> "History":
        return History(self.ops[:n])

    def __repr__(self) -> str:
        return " ".join(repr(op) for op in self.ops)


def read_only_anomaly_example() -> History:
    """The paper's h_s (Sec 3.3), Fekete/O'Neil read-only anomaly.

    h_s: R2(X0,0) R2(Y0,0) R1(Y0,0) W1(Y1,20) C1 R3(X0,0) R3(Y1,20) C3
         W2(X2,-11) C2

    T3 is the read-only transaction whose participation creates the cycle
    T1 -wr-> T3 -rw-> T2 -rw-> T1.
    """
    h = History()
    h.extend([
        b(2), r(2, "X", T0), r(2, "Y", T0),
        b(1), r(1, "Y", T0), w(1, "Y"), c(1),
        b(3), r(3, "X", T0), r(3, "Y", 1), c(3),
        w(2, "X"), c(2),
    ])
    return h
