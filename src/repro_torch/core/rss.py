"""Read Safe Snapshot (RSS): Definitions 4.1/4.2, Algorithm 1 and oracles.

The executable artifacts:
  * `is_rss(h, P)`            — Definition 4.1 checker (oracle, brute force)
  * `clear_set / done_set`    — Definition 4.6 transaction states
  * `construct_rss_ssi(...)`  — Algorithm 1 (SSI-based construction) given
                                only begin/commit/abort events and the
                                concurrent-rw (vulnerable) edges observed so
                                far — exactly the information the paper ships
                                through the WAL.
  * `IncrementalRss`/`advance` — the same Algorithm 1 applied only to the
                                *delta* of newly-committed/newly-Clear
                                transactions and newly-shipped edges: O(1)
                                amortized per event instead of O(history)
                                per construction round.
  * `protected_read(...)`     — build a PRoT (Def 4.2) reading the
                                most-recent-in-P version of each key.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterable, Mapping, Sequence

from .dsg import build_dsg
from .history import History, Op, READ, T0, b, c, r


# --------------------------------------------------------------------- oracle
def is_rss(h: History, P: set[int]) -> bool:
    """Definition 4.1: P is RSS iff for all Tp in P and committed Tq not in P,
    Tp is unreachable from Tq in the DSG of h's committed projection."""
    committed = h.committed
    if not P <= committed:
        return False
    g = build_dsg(h)
    outside = committed - P
    for q in outside:
        if g.reachable_from(q) & P:
            return False
    return True


def rss_violations(h: History, P: set[int]) -> list[tuple[int, int]]:
    """(Tq outside, Tp inside) witnesses that P is not an RSS of h."""
    g = build_dsg(h)
    out = []
    for q in h.committed - P:
        hit = g.reachable_from(q) & P
        for p in sorted(hit):
            out.append((q, p))
    return out


# --------------------------------------------------- Definition 4.6: states
def done_set(h: History) -> set[int]:
    """Done(p): transactions whose End (commit or abort) is in the prefix."""
    return {t for t in h.txns if h.end_pos(t) < (1 << 62)}


def clear_set(h: History) -> set[int]:
    """Clear(p): Ta with End(Ta) preceding Begin(Tb) of every not-Done Tb.

    Only committed transactions are returned (aborted ones can never be part
    of an RSS; their ops leave the committed projection).
    """
    done = done_set(h)
    not_done = h.txns - done
    if not_done:
        horizon = min(h.begin_pos(t) for t in not_done)
    else:
        horizon = 1 << 62
    return {t for t in h.committed if h.end_pos(t) < horizon}


def obscure_set(h: History) -> set[int]:
    """Done but not Clear (possibly concurrent with an active transaction)."""
    return (done_set(h) & h.committed) - clear_set(h)


# ------------------------------------------------------------- Algorithm 1
def construct_rss_ssi(
    clear: set[int],
    committed: set[int],
    rw_edges: Iterable[tuple[int, int]],
) -> set[int]:
    """Algorithm 1 (paper Sec 4.2) on pre-extracted state.

      (1) contain the entire Clear(p) in RSS
      (2)-(5) for every dependency edge Tu -> Tc with Tc in Clear(p) and
              Tu not in Clear(p), add Tu to RSS.

    Per Lemma 4.9 every such incoming edge is a *vulnerable* (concurrent rw)
    dependency, so tracking only SSI's rw-conflict list suffices — this is the
    cost reduction the paper claims.  Tu must itself be committed (Fig. 2:
    uncommitted or aborted transactions never join RSS).
    """
    rss = set(clear)
    for tu, tc in rw_edges:
        if tc in clear and tu not in clear and tu in committed:
            rss.add(tu)
    return rss


class IncrementalRss:
    """Incremental Algorithm 1: equal to ``construct_rss_ssi(clear,
    committed, edges)`` over the cumulative event stream, maintained in O(1)
    amortized per event.

    Events (any interleaving; each is idempotent):
      * ``add_committed(t)`` — Tc's commit observed,
      * ``add_clear(t)``     — Tc entered Clear(p) (caller derives Clear from
                               begin/end ordering; see `RSSManager`),
      * ``add_edge(u, w)``   — concurrent rw antidependency Tu -> Tw shipped.

    Rule (2)-(5) of Algorithm 1 — pull committed Tu with an edge into a Clear
    transaction — is re-checked only for the endpoints an event touches:
    a new edge checks (u, w) directly; a transaction entering Clear drains
    the stashed in-edges (`rw_in`); a late commit of Tu re-checks Tu's
    stashed out-edges.  `rss` only ever grows (the monotonicity Theorem 4.4
    readers rely on).
    """

    def __init__(self) -> None:
        self.rss: set[int] = set()
        self.clear: set[int] = set()
        self.committed: set[int] = set()
        self.rw_out: dict[int, set[int]] = {}   # reader -> shipped writers
        self.rw_in: dict[int, set[int]] = {}    # writer -> shipped readers
        self._new: set[int] = set()             # members added, undrained
        self._pending_pull: set[int] = set()    # pulled before commit seen

    # ------------------------------------------------------------- events
    def _join(self, t: int) -> None:
        if t not in self.rss:
            self.rss.add(t)
            self._new.add(t)

    def add_committed(self, t: int) -> None:
        if t in self.committed:
            return
        self.committed.add(t)
        if t in self._pending_pull:
            self._pending_pull.discard(t)
            self._join(t)
        # edges shipped before the commit (lagged/batched streams)
        for w in self.rw_out.get(t, ()):
            if w in self.clear:
                self._join(t)
                break

    def add_clear(self, t: int) -> None:
        if t in self.clear:
            return
        self.clear.add(t)
        self._join(t)                       # step (1): Clear(p) ⊆ RSS
        for u in self.rw_in.get(t, ()):     # steps (2)-(5): drain in-edges
            if u in self.committed:
                self._join(u)

    def add_edge(self, u: int, w: int) -> None:
        self.rw_out.setdefault(u, set()).add(w)
        self.rw_in.setdefault(w, set()).add(u)
        if w in self.clear and u in self.committed:
            self._join(u)

    def pull(self, u: int) -> None:
        """Force-join a committed reader whose witness writer is no longer
        tracked (the writer's bookkeeping was GC'd below the state
        watermark, which implies it was Clear)."""
        if u in self.committed:
            self._join(u)
        else:
            # commit event not applied yet: joined on add_committed(u)
            self._pending_pull.add(u)

    # ------------------------------------------------------------ draining
    def drain_new(self) -> set[int]:
        """Members added since the last drain (the construction delta)."""
        out, self._new = self._new, set()
        return out

    # ------------------------------------------------------------------ GC
    def forget(self, t: int) -> None:
        """Drop Tt's bookkeeping.  Only safe for transactions already
        resolved below the caller's state watermark (Clear members or
        aborted): their membership is covered by the snapshot floor and no
        future event can reference them as a non-Clear endpoint."""
        self.rss.discard(t)
        self.clear.discard(t)
        self.committed.discard(t)
        self._new.discard(t)
        self._pending_pull.discard(t)
        for w in self.rw_out.pop(t, ()):
            ins = self.rw_in.get(w)
            if ins is not None:
                ins.discard(t)
                if not ins:
                    del self.rw_in[w]
        for u in self.rw_in.pop(t, ()):
            outs = self.rw_out.get(u)
            if outs is not None:
                outs.discard(t)
                if not outs:
                    del self.rw_out[u]


def advance(state: IncrementalRss, *,
            committed: Iterable[int] = (),
            clear: Iterable[int] = (),
            edges: Iterable[tuple[int, int]] = ()) -> set[int]:
    """Apply one delta of events to an `IncrementalRss` and return the set
    of NEW members — Algorithm 1 restricted to the delta.  Feeding every
    prefix delta reproduces `construct_rss_ssi` over the cumulative state
    (property-tested in tests/test_rss_incremental.py)."""
    for t in committed:
        state.add_committed(t)
    for u, w in edges:
        state.add_edge(u, w)
    for t in clear:
        state.add_clear(t)
    return state.drain_new()


def construct_rss(h: History) -> set[int]:
    """Algorithm 1 driven directly from a history prefix.

    Uses only the information the WAL would carry: begin/end events (for
    Clear/Done) and concurrent rw anti-dependency edges among committed txns.
    """
    from .ssi import vulnerable_edges  # local import to avoid cycle

    clear = clear_set(h)
    edges = [(v.src, v.dst) for v in vulnerable_edges(h)]
    return construct_rss_ssi(clear, h.committed, edges)


# ------------------------------------------------------- PRoT (Def 4.2)
def latest_versions_in(h: History, P: set[int]) -> dict[str, int]:
    """For every key, the writer of the most recent committed version among
    transactions in P (T0 if no P-transaction wrote the key)."""
    latest: dict[str, int] = {}
    keys: set[str] = set()
    for t in h.txns:
        keys |= h.writeset(t)
        keys |= h.readset(t)
    for key in keys:
        latest[key] = T0
    for t in h.commit_order():
        if t in P:
            for key in h.writeset(t):
                latest[key] = t
    return latest


def protected_read(h: History, P: set[int], keys: Sequence[str],
                   txn_id: int) -> list[Op]:
    """Operations of a PRoT (Def 4.2): a read-only transaction reading, for
    each requested key, the most recent committed version in P."""
    latest = latest_versions_in(h, P)
    ops: list[Op] = [b(txn_id)]
    for key in keys:
        ops.append(r(txn_id, key, latest.get(key, T0)))
    ops.append(c(txn_id))
    return ops


def with_protected_reader(h: History, P: set[int], keys: Sequence[str],
                          txn_id: int) -> History:
    """h extended by a PRoT over `keys` — the Theorem 4.4 construction."""
    h2 = History(h.ops)
    h2.extend(protected_read(h, P, keys, txn_id))
    return h2
