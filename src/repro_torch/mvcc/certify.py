"""Pluggable commit certification for the SSI engine.

Every ABORT decision the engine makes (other than first-committer-wins,
which is an SI storage rule, not a serializability criterion) lives behind
the `Certifier` protocol.  The engine keeps the mechanism — version
install, WAL logging, SIRead bookkeeping, the in_rw/out_rw vulnerable-edge
sets that feed the WAL `deps` messages, and GC — and reports events to its
certifier; the certifier holds the policy and decides who dies.

Three certifiers, ordered by the schedules they admit
(SSN ⊇ CommitOrderSSI ⊇ ConservativeSSI):

  * `ConservativeSSI` — the structural pivot abort (PostgreSQL-style):
    any transaction with both an incoming and an outgoing vulnerable rw
    edge is killed, regardless of commit order.  Extracted verbatim from
    the seed engine and behaviour-pinned by the test suite.
  * `CommitOrderSSI` — the engine-level twin of
    `core.ssi.fatal_dangerous_structures`: a dangerous structure
    Ta -rw-> Tb -rw-> Tc is fatal only when Tc commits FIRST of the three
    (Ta == Tc allowed: plain write skew).  Tracks two sticky per-txn
    summaries — min commit seq over committed out-neighbours (`min_out`)
    and max commit seq over committed in-neighbours (`max_in`) — which
    survive engine edge-GC, the analogue of PostgreSQL's SLRU conflict
    summarization.
  * `SSN` — Wang et al.'s Serial Safety Net exclusion window: per-txn
    low/high watermarks pi(T)/eta(T) folded on edge events, abort iff
    pi(T) <= eta(T) at commit.  Admits some genuinely-serializable
    dangerous structures CommitOrderSSI still aborts.

Certifier instances are stateful and strictly per-engine (`attach`
asserts single ownership); pass a name or factory when configuring
several engines.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

# circular-import note: `engine` imports this module lazily (inside
# Engine.__init__), so a top-level import of engine names is safe here.
from .engine import AbortReason, SerializationFailure, Status, Txn

INF = 1 << 62

CertifierSpec = Union[None, str, "Certifier", Callable[[], "Certifier"]]


class Certifier:
    """Event hooks the engine calls; every default is a no-op.

    Hook contract (all `Txn` arguments are live engine transactions):

      * `on_begin(t)` — t entered the system.
      * `on_read(t, writer_tid, commit_seq)` — t read the version written
        by `writer_tid` (commit seq of that version; 0 for the initial).
      * `on_read_skipped_version(t, writer, commit_seq)` — t's snapshot
        read skipped a newer committed version (`writer` may be None when
        the writer was already GC'd).  Fired before the matching
        `on_rw_edge`.
      * `on_rw_edge(reader, writer)` — a vulnerable (concurrent) rw
        anti-dependency reader -> writer was recorded.  Neither endpoint
        is aborted at call time.  The certifier may abort either endpoint
        (or a neighbour) via `self.abort(...)`.
      * `on_precommit(t)` — t passed first-committer-wins and is about to
        commit; raise `SerializationFailure` to reject it.  If it returns,
        t's commit seq will be `engine.seq + 1`.
      * `on_end(t, committed)` — t committed (end_seq = its commit seq) or
        aborted; fired after the engine's own bookkeeping.
      * `on_gc(dead)` — the engine reaped these tids; drop any per-txn
        state keyed on them.
    """

    name = "abstract"

    def __init__(self) -> None:
        self.engine = None

    def attach(self, engine) -> None:
        assert self.engine is None, \
            "certifier instances are per-engine; pass a name or factory"
        self.engine = engine

    # ------------------------------------------------------------- hooks
    def on_begin(self, t: Txn) -> None:
        pass

    def on_read(self, t: Txn, writer_tid: int, commit_seq: int) -> None:
        pass

    def on_read_skipped_version(self, t: Txn, writer: Optional[Txn],
                                commit_seq: int) -> None:
        pass

    def on_rw_edge(self, reader: Txn, writer: Txn) -> None:
        pass

    def on_precommit(self, t: Txn) -> None:
        pass

    def on_end(self, t: Txn, committed: bool) -> None:
        pass

    def on_gc(self, dead: set[int]) -> None:
        pass

    # ----------------------------------------------------------- helpers
    def abort(self, t: Txn, reason: AbortReason) -> None:
        """Kill a transaction mid-flight (the engine logs/aborts it)."""
        self.engine._abort(t, reason)


class ConservativeSSI(Certifier):
    """The seed engine's structural dangerous-structure abort, extracted
    verbatim: any pivot (a txn with both in- and out- vulnerable rw edges)
    is aborted when the second edge appears — while still active, else an
    active neighbour dies in its place (PostgreSQL never aborts an
    already-committed transaction).  Commit order is ignored, so provably
    benign structures (Tc committing last) are still aborted."""

    name = "conservative-ssi"

    def on_rw_edge(self, reader: Txn, writer: Txn) -> None:
        eng = self.engine
        for cand in (writer, reader):
            if cand.is_pivot:
                if cand.status == Status.ACTIVE:
                    self.abort(cand, AbortReason.PIVOT)
                    return
                # pivot already committed: abort an active neighbour
                for nid in list(cand.in_rw) + list(cand.out_rw):
                    n = eng.txns.get(nid)
                    if n is not None and n.status == Status.ACTIVE:
                        self.abort(n, AbortReason.INCOMING_PIVOT)
                        return

    def on_precommit(self, t: Txn) -> None:
        if t.is_pivot and t.status == Status.ACTIVE:
            raise SerializationFailure(AbortReason.PIVOT)


@dataclass
class _CoState:
    """Sticky commit-order summary.  min_out/max_in fold in neighbour
    commit seqs as neighbours commit and are never un-folded, so the
    summary outlives engine edge-GC of the neighbour itself."""
    cstamp: int = 0          # own commit seq once committed
    min_out: int = INF       # min commit seq over committed out-neighbours
    max_in: int = 0          # max commit seq over committed in-neighbours


class CommitOrderSSI(Certifier):
    """Full Fekete-condition certification at commit time.

    A structure Ta -rw-> Tb -rw-> Tc is fatal iff Tc commits first of the
    three (Ta == Tc allowed).  Because aborts happen only at the aborting
    transaction's own commit, the LAST of the three to (attempt to) commit
    is the one rejected:

      * t is the pivot Tb: fatal iff some out-neighbour committed no later
        than some in-neighbour — `min_out <= max_in` (equality is the
        two-transaction write-skew cycle, where the out- and in-neighbour
        are the same transaction).
      * t is the in-neighbour Ta of a committed pivot W whose own
        out-neighbour committed before W did: `min_out(W) < cstamp(W)`.
        (Tc committing first of the three is implied: c(Tc) < c(W) and t,
        still uncommitted, necessarily commits after both.)

    The structural pivot (Tb) is never aborted mid-flight, so unlike
    ConservativeSSI this certifier admits every structure whose Tc
    commits last — exactly `core.ssi.fatal_dangerous_structures`."""

    name = "commit-order-ssi"

    def __init__(self) -> None:
        super().__init__()
        self.state: dict[int, _CoState] = {}

    def _st(self, tid: int) -> _CoState:
        st = self.state.get(tid)
        if st is None:
            st = self.state[tid] = _CoState()
        return st

    def on_begin(self, t: Txn) -> None:
        self._st(t.tid)

    def on_rw_edge(self, reader: Txn, writer: Txn) -> None:
        # edge to/from an already-committed endpoint: fold its cstamp now
        # (the on_end fan-out below only reaches then-live neighbours)
        if writer.status == Status.COMMITTED:
            st = self._st(reader.tid)
            st.min_out = min(st.min_out, writer.end_seq)
        if reader.status == Status.COMMITTED:
            st = self._st(writer.tid)
            st.max_in = max(st.max_in, reader.end_seq)

    def on_precommit(self, t: Txn) -> None:
        st = self._st(t.tid)
        if st.min_out <= st.max_in:                      # t is the pivot Tb
            raise SerializationFailure(AbortReason.FATAL_PIVOT)
        eng = self.engine
        for wid in t.out_rw:                             # t is Ta, W a pivot
            w = eng.txns.get(wid)
            wst = self.state.get(wid)
            if (w is not None and w.status == Status.COMMITTED
                    and wst is not None and wst.min_out < wst.cstamp):
                raise SerializationFailure(AbortReason.FATAL_NEIGHBOUR)

    def on_end(self, t: Txn, committed: bool) -> None:
        if not committed:
            self.state.pop(t.tid, None)
            return
        c = t.end_seq
        st = self._st(t.tid)
        st.cstamp = c
        eng = self.engine
        for rid in t.in_rw:          # r -rw-> t: t is r's committed out-nbr
            r = eng.txns.get(rid)
            if r is not None and r.status == Status.ACTIVE:
                rs = self._st(rid)
                rs.min_out = min(rs.min_out, c)
        for wid in t.out_rw:         # t -rw-> w: t is w's committed in-nbr
            w = eng.txns.get(wid)
            if w is not None and w.status == Status.ACTIVE:
                ws = self._st(wid)
                ws.max_in = max(ws.max_in, c)

    def on_gc(self, dead: set[int]) -> None:
        for tid in dead:
            self.state.pop(tid, None)


@dataclass
class _SsnState:
    """SSN watermarks.  pi(T) is the low watermark (min sstamp over T's
    committed rw successors, i.e. the earliest serial position forced
    *after* T); eta(T) the high watermark (max cstamp over T's committed
    predecessors — versions read, overwritten versions and their readers,
    committed in-rw readers).  The exclusion window inverts — pi <= eta —
    exactly when some predecessor is forced to serialize after some
    successor, i.e. a potential cycle through committed transactions."""
    pi: int = INF
    eta: int = 0
    cstamp: int = 0
    sstamp: int = INF        # min(pi, cstamp) at commit; propagated back


class SSN(Certifier):
    """Wang et al.'s Serial Safety Net (arXiv:1605.04292) on top of SI.

    Cheaper and more permissive than dangerous-structure certification:
    two per-txn watermarks folded on read/edge/commit events, one
    comparison at commit.  Admits serializable schedules CommitOrderSSI
    aborts (the committed-pivot Ta case when no cycle exists), and aborts
    only when the exclusion window pi(T) <= eta(T) proves a potential
    serial-order inversion through committed transactions."""

    name = "ssn"

    def __init__(self) -> None:
        super().__init__()
        self.state: dict[int, _SsnState] = {}
        # (key, writer_tid) -> max cstamp over committed readers of that
        # version: the v.pstamp of the paper, folded into eta(T) when T
        # overwrites the version.  Pruned against the concurrency horizon.
        self.pstamp: dict[tuple[str, int], int] = {}

    _PSTAMP_PRUNE = 4096     # amortized prune threshold

    def _st(self, tid: int) -> _SsnState:
        st = self.state.get(tid)
        if st is None:
            st = self.state[tid] = _SsnState()
        return st

    def on_begin(self, t: Txn) -> None:
        self._st(t.tid)

    def on_read(self, t: Txn, writer_tid: int, commit_seq: int) -> None:
        # wr predecessor: the version's writer committed before our read
        st = self._st(t.tid)
        st.eta = max(st.eta, commit_seq)

    def on_read_skipped_version(self, t: Txn, writer: Optional[Txn],
                                commit_seq: int) -> None:
        # t -rw-> writer with writer committed: successor's sstamp bounds pi
        st = self._st(t.tid)
        ws = self.state.get(writer.tid) if writer is not None else None
        s = min(ws.sstamp, commit_seq) if ws is not None else commit_seq
        st.pi = min(st.pi, s)

    def on_rw_edge(self, reader: Txn, writer: Txn) -> None:
        if writer.status == Status.COMMITTED:
            ws = self.state.get(writer.tid)
            s = min(ws.sstamp, writer.end_seq) if ws is not None \
                else writer.end_seq
            rs = self._st(reader.tid)
            rs.pi = min(rs.pi, s)
        if reader.status == Status.COMMITTED:
            st = self._st(writer.tid)
            st.eta = max(st.eta, reader.end_seq)

    def on_precommit(self, t: Txn) -> None:
        eng = self.engine
        st = self._st(t.tid)
        eta = st.eta
        for key in t.writes:
            # ww predecessor (the version we overwrite — FCW already
            # guarantees it is <= our snapshot) and the committed readers
            # of that version (rw predecessors through v.pstamp)
            v = eng.store.chain(key).newest()
            eta = max(eta, v.commit_seq,
                      self.pstamp.get((key, v.writer), 0))
        st.eta = eta
        pi = min(st.pi, eng.seq + 1)         # prospective cstamp
        if pi <= eta:
            raise SerializationFailure(AbortReason.EXCLUSION_WINDOW)

    def on_end(self, t: Txn, committed: bool) -> None:
        if not committed:
            self.state.pop(t.tid, None)
            return
        c = t.end_seq
        st = self._st(t.tid)
        st.cstamp = c
        st.sstamp = min(st.pi, c)
        eng = self.engine
        for rid in t.in_rw:          # r -rw-> t: t committed successor of r
            r = eng.txns.get(rid)
            if r is not None and r.status == Status.ACTIVE:
                rs = self._st(rid)
                rs.pi = min(rs.pi, st.sstamp)
        for wid in t.out_rw:         # t -rw-> w: t committed predecessor
            w = eng.txns.get(wid)
            if w is not None and w.status == Status.ACTIVE:
                ws = self._st(wid)
                ws.eta = max(ws.eta, c)
        for key, writer in t.reads.items():
            k = (key, writer)
            if self.pstamp.get(k, 0) < c:
                self.pstamp[k] = c

    def on_gc(self, dead: set[int]) -> None:
        for tid in dead:
            self.state.pop(tid, None)
        if len(self.pstamp) > self._PSTAMP_PRUNE:
            eng = self.engine
            horizon = min((t.begin_seq for t in eng.active.values()),
                          default=eng.seq)
            self.pstamp = {k: s for k, s in self.pstamp.items()
                           if s >= horizon}


CERTIFIERS: dict[str, Callable[[], Certifier]] = {
    "conservative": ConservativeSSI,
    "conservative-ssi": ConservativeSSI,
    "commit-order": CommitOrderSSI,
    "commit-order-ssi": CommitOrderSSI,
    "ssn": SSN,
}


def make_certifier(spec: CertifierSpec) -> Certifier:
    """Resolve a certifier spec: None -> ConservativeSSI (the seed
    behaviour), a registry name, a ready instance, or a zero-arg factory."""
    if spec is None:
        return ConservativeSSI()
    if isinstance(spec, str):
        try:
            return CERTIFIERS[spec]()
        except KeyError:
            raise ValueError(
                f"unknown certifier {spec!r}; known: "
                f"{sorted(set(CERTIFIERS))}") from None
    if isinstance(spec, Certifier):
        return spec
    return spec()
