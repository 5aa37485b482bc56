"""Session tokens: per-client consistency guarantees across the fleet.

A `Session` is the unit of client-visible consistency in a replicated
HTAP deployment (million-user serving): each client carries a small
token recording the LSN horizon it has *observed* — the WAL position of
its last OLTP commit (`last_commit_lsn`) and the applied LSN of the
replica that served its last read (`last_read_lsn`).  Routing honours
the token (`ReplicaCluster.acquire(session=...)`):

  * **read-your-writes** — only replicas whose applied LSN covers
    `last_commit_lsn` may serve the session, so a client never misses
    the WAL prefix containing its own committed writes;
  * **monotonic reads**   — only replicas at or above `last_read_lsn`
    may serve, so a session's observed horizon never regresses even as
    round-robin / bounded-staleness routing hops it across a lag-skewed
    fleet.

Both collapse into one predicate: serve from any replica with
`applied_lsn >= session.min_required_lsn()`.  When no replica covers
the token the cluster runs a cadence-owed *delta* ship on the freshest
replica (`token_ships` in the cluster stats) — never a synchronous
stall: delta shipping replays exactly the records the replication
schedule was about to replay anyway.

The guarantee is LSN-prefix-level (PostgreSQL hot-standby style).
Under RSS a committed-but-Obscure transaction may be held out of
snapshot *membership* until its dependencies resolve — on every replica
identically, because membership is a deterministic function of the
applied WAL prefix — so prefix coverage is the strongest portable
token; SI-mode sessions additionally get value-level read-your-writes.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Session:
    """A client session token.  Mutable by design: the cluster advances
    `last_read_lsn` on every serve and the client (facade) advances
    `last_commit_lsn` on every OLTP commit."""

    sid: int
    last_commit_lsn: int = 0
    last_read_lsn: int = 0
    serves: int = 0
    # recorded (replica_idx, served_applied_lsn, required_lsn) per serve
    # when keep_history — the property tests replay these to check both
    # guarantees offline against the token floor that held at serve time
    history: list = field(default_factory=list)
    keep_history: bool = False

    def min_required_lsn(self) -> int:
        """The LSN any serving replica must have applied: read-your-writes
        (last_commit_lsn) and monotonic reads (last_read_lsn) combined."""
        return max(self.last_commit_lsn, self.last_read_lsn)

    def note_commit(self, lsn: int) -> None:
        """The client committed an OLTP transaction whose record sits at
        WAL position `lsn` (primary head after commit)."""
        if lsn > self.last_commit_lsn:
            self.last_commit_lsn = lsn

    def note_read(self, applied_lsn: int, replica: int = -1) -> None:
        """A replica at `applied_lsn` served this session; ratchets the
        monotonic-reads floor (never decreases)."""
        self.serves += 1
        if self.keep_history:
            self.history.append((replica, applied_lsn,
                                 self.min_required_lsn()))
        if applied_lsn > self.last_read_lsn:
            self.last_read_lsn = applied_lsn

    def violations(self) -> int:
        """Offline check over a kept history: serves whose replica had not
        applied the token floor in force at serve time — read-your-writes
        and monotonic reads both (0 when the guarantees held)."""
        return sum(1 for _, lsn, req in self.history if lsn < req)
