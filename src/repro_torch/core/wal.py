"""Write-ahead-log records for RSS construction (paper Sec 5.1).

The OLTP side ships, per transaction:
  * BEGIN  (start information; induced by the first operation)
  * COMMIT / ABORT (end information)
  * DEPS   (logical message: the transaction's *outgoing* concurrent
            rw-antidependency edges, written immediately after the reader
            commits — "an array of writer transaction IDs")

Records carry a monotonically increasing LSN assigned by the log. Shipping is
asynchronous (streaming replication); the replica replays records in LSN
order (`repro_torch.core.replica.RSSManager`).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Iterator, Literal, Optional, Sequence

RecordType = Literal["begin", "commit", "abort", "deps"]


def effective_commit_seq(max_seen: int, shipped_seq: int) -> int:
    """THE commit clock every WAL consumer (RSSManager, PagedMirror,
    Replica) derives version stamps from, so their seq mappings stay
    bit-identical.

    Stamped records normally carry a seq above everything seen and keep the
    primary's clock.  A legacy record (shipped_seq == 0) — or a stamped seq
    that collides with / regresses below a locally-minted fallback when
    record kinds mix — takes max(seen) + 1: the clock is strictly monotone
    in apply order, so commit-seq order always equals commit-LSN order
    (floor_seq prefix-safety and VersionChain.install both rely on it)."""
    if shipped_seq > max_seen:
        return shipped_seq
    return max_seen + 1


@dataclass(frozen=True)
class WalRecord:
    lsn: int
    type: RecordType
    txn: int
    # for "deps": ids of writers this (committed reader) txn has outgoing
    # concurrent rw-antidependency edges to.
    out_rw: tuple[int, ...] = ()
    # for "commit": the committed writeset (key, value) — the data payload a
    # physical/logical replication stream ships to replicas.
    writes: tuple[tuple[str, object], ...] = ()
    # for "commit": the primary's commit sequence number (the version
    # timestamp installed into the store).  Lets replicas stamp mirrored
    # versions with the SAME clock the RSS membership mapping uses (0 =
    # unknown / legacy record; replicas then fall back to a local counter).
    seq: int = 0

    def to_json(self) -> str:
        d = {"lsn": self.lsn, "type": self.type, "txn": self.txn}
        if self.type == "deps":
            d["out_rw"] = list(self.out_rw)
        if self.writes:
            d["writes"] = [list(kv) for kv in self.writes]
        if self.seq:
            d["seq"] = self.seq
        return json.dumps(d, separators=(",", ":"))

    @staticmethod
    def from_json(s: str) -> "WalRecord":
        d = json.loads(s)
        return WalRecord(d["lsn"], d["type"], d["txn"],
                         tuple(d.get("out_rw", ())),
                         tuple((k, v) for k, v in d.get("writes", ())),
                         d.get("seq", 0))


class Wal:
    """An append-only in-memory WAL with optional persistence.

    `tail(from_lsn)` is the streaming-replication read path: it yields
    records with lsn > from_lsn, letting a replica poll asynchronously.

    `truncate(up_to_lsn)` is WAL segment recycling: once every consumer
    (RSS manager, paged mirror, replica) has applied a prefix, the primary
    drops it so log state stays bounded by replication lag, not history.
    LSNs keep counting from `base_lsn`; tailing below a truncated prefix is
    an error (a real system would re-seed the replica from a basebackup).

    Multi-consumer accounting (replication slots): `register_consumer`
    declares a named consumer, `ack(name, lsn)` records the prefix it has
    durably applied, and `truncate` then never discards a record any
    registered consumer still needs — the recycle point is clamped to
    `min_acked_lsn()`, the minimum applied LSN across all consumers.  A WAL
    with no registered consumers keeps the legacy single-consumer contract:
    the caller is the only consumer and `truncate(lsn)` is taken at face
    value.
    """

    def __init__(self) -> None:
        self.records: list[WalRecord] = []
        self.base_lsn = 0          # lsn of the newest truncated-away record
        self.consumers: dict[str, int] = {}   # name -> acked (applied) lsn

    @property
    def head_lsn(self) -> int:
        return self.base_lsn + len(self.records)

    def _append(self, type: RecordType, txn: int,
                out_rw: Sequence[int] = (),
                writes: Sequence[tuple[str, object]] = (),
                seq: int = 0) -> WalRecord:
        rec = WalRecord(self.head_lsn + 1, type, txn, tuple(out_rw),
                        tuple(writes), seq)
        self.records.append(rec)
        return rec

    def log_begin(self, txn: int) -> WalRecord:
        return self._append("begin", txn)

    def log_commit(self, txn: int,
                   writes: Sequence[tuple[str, object]] = (),
                   seq: int = 0) -> WalRecord:
        return self._append("commit", txn, writes=writes, seq=seq)

    def log_abort(self, txn: int) -> WalRecord:
        return self._append("abort", txn)

    def log_deps(self, txn: int, out_rw: Sequence[int]) -> WalRecord:
        return self._append("deps", txn, out_rw)

    def tail(self, from_lsn: int) -> Iterator[WalRecord]:
        if from_lsn < self.base_lsn:
            raise LookupError(
                f"WAL truncated to lsn {self.base_lsn}; cannot tail from "
                f"{from_lsn} (re-seed the consumer from a base snapshot)")
        yield from self.records[from_lsn - self.base_lsn:]

    # ---------------------------------------------------- consumer slots
    def register_consumer(self, name: str, *,
                          start_lsn: Optional[int] = None) -> str:
        """Declare a named consumer (replication-slot analogue).  It holds
        the truncation point at `start_lsn` (default: the current base —
        the earliest prefix still tailable) until it acks progress."""
        start = self.base_lsn if start_lsn is None else start_lsn
        if start < self.base_lsn:
            raise LookupError(
                f"WAL truncated to lsn {self.base_lsn}; consumer {name!r} "
                f"cannot start at {start} (re-seed from a base snapshot)")
        self.consumers[name] = start
        return name

    def deregister_consumer(self, name: str) -> None:
        self.consumers.pop(name, None)

    def ack(self, name: str, lsn: int) -> None:
        """Record that `name` has applied the prefix up to `lsn` (monotone:
        a stale ack never moves a slot backwards)."""
        if name not in self.consumers:
            raise KeyError(f"unregistered WAL consumer {name!r}")
        self.consumers[name] = max(self.consumers[name], lsn)

    def min_acked_lsn(self) -> int:
        """The cluster-wide recycle horizon: the minimum applied LSN across
        registered consumers (head when none are registered)."""
        return min(self.consumers.values(), default=self.head_lsn)

    def truncate(self, up_to_lsn: Optional[int] = None) -> int:
        """Drop records with lsn <= up_to_lsn (already applied by every
        consumer); returns the number of records recycled.

        With registered consumers the cut is clamped to `min_acked_lsn()`,
        so no consumer can ever be handed a recycled prefix; passing no
        argument recycles exactly up to that horizon."""
        if up_to_lsn is None:
            up_to_lsn = self.min_acked_lsn()
        elif self.consumers:
            up_to_lsn = min(up_to_lsn, self.min_acked_lsn())
        cut = min(max(up_to_lsn - self.base_lsn, 0), len(self.records))
        if cut:
            del self.records[:cut]
            self.base_lsn += cut
        return cut

    # -------------------------------------------------------- persistence
    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            if self.base_lsn or self.consumers:
                # header so a fully-truncated WAL reloads with its LSN
                # clock intact (no records left to infer it from) and
                # consumer slots survive restarts
                hdr = {"base_lsn": self.base_lsn}
                if self.consumers:
                    hdr["consumers"] = self.consumers
                f.write(json.dumps(hdr) + "\n")
            for rec in self.records:
                f.write(rec.to_json() + "\n")

    @staticmethod
    def load(path: str) -> "Wal":
        wal = Wal()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                d = json.loads(line)
                if "type" not in d:                  # base_lsn header
                    wal.base_lsn = d["base_lsn"]
                    wal.consumers = dict(d.get("consumers", {}))
                else:
                    wal.records.append(WalRecord.from_json(line))
        if wal.records and not wal.base_lsn:
            wal.base_lsn = wal.records[0].lsn - 1    # headerless legacy dump
        return wal
