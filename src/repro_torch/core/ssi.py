"""SSI (serializable snapshot isolation) properties at the history level.

Implements, over `History` objects:
  * SI-V / SI-W validation (the Schenkel-Weikum SI conditions, paper Sec 3.2)
  * vulnerable dependencies (concurrent rw anti-dependencies, paper Sec 4.3)
  * dangerous structures (Fekete et al.): two successive vulnerable edges
  * `ssi_accepts(h)` — would an SSI scheduler accept this committed history?

These are the *specification-level* checks; the executable SSI engine lives in
`repro_torch.mvcc` and must only ever produce histories that pass these checks
(asserted by property tests).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

from .dsg import RW, build_dsg
from .history import History, T0


def si_v_holds(h: History) -> bool:
    """SI read protocol: every read of X by T returns the version written by
    the most recent committed writer of X as of Begin(T) (or T's own write)."""
    # committed writers of each key by end position
    for t in h.txns:
        begin = h.begin_pos(t)
        own_writes: set[str] = set()
        # iterate T's ops in order to honour read-your-own-writes
        for op in h.ops:
            if op.txn != t:
                continue
            if op.kind == "w":
                own_writes.add(op.key)
            elif op.kind == "r":
                if op.key in own_writes:
                    if op.version != t:
                        return False
                    continue
                expected = T0
                best = -1
                for u in h.committed:
                    if u == t or op.key not in h.writeset(u):
                        continue
                    e = h.end_pos(u)
                    if e < begin and e > best:
                        best, expected = e, u
                if op.version != expected:
                    return False
    return True


def si_w_holds(h: History) -> bool:
    """First-committer-wins: concurrent committed txns have disjoint writesets."""
    committed = sorted(h.committed)
    for i, ta in enumerate(committed):
        for tb in committed[i + 1:]:
            if h.concurrent(ta, tb) and (h.writeset(ta) & h.writeset(tb)):
                return False
    return True


def is_si_history(h: History) -> bool:
    return si_v_holds(h) and si_w_holds(h)


@dataclass(frozen=True)
class Vulnerable:
    src: int
    dst: int
    key: str


def vulnerable_edges(h: History) -> list[Vulnerable]:
    """Concurrent rw anti-dependencies among committed txns (paper Sec 4.3:
    the only conflicts that can be vulnerable under SSI are concurrent rw)."""
    g = build_dsg(h)
    out: list[Vulnerable] = []
    for e in g.edges:
        if e.kind == RW and h.concurrent(e.src, e.dst):
            out.append(Vulnerable(e.src, e.dst, e.key))
    return out


def dangerous_structures(h: History) -> list[tuple[int, int, int]]:
    """(Ta, Tb, Tc) with vulnerable Ta->Tb and vulnerable Tb->Tc.

    Fekete et al.: every non-serializable SI execution contains such a
    structure where additionally Tc is the first of the three to commit; we
    report the structural condition (what PostgreSQL's conservative detector
    aborts on) — tests that need the exact theorem add the commit-order check.
    """
    vul = vulnerable_edges(h)
    by_src: dict[int, list[Vulnerable]] = defaultdict(list)
    for v in vul:
        by_src[v.src].append(v)
    found: list[tuple[int, int, int]] = []
    for v1 in vul:
        for v2 in by_src.get(v1.dst, ()):
            found.append((v1.src, v1.dst, v2.dst))
    return found


def fatal_dangerous_structures(h: History) -> list[tuple[int, int, int]]:
    """Dangerous structures satisfying the full Fekete condition: the
    structure can close a cycle only if Tc (the pivot's out-neighbour)
    commits FIRST of the three.  PostgreSQL's commit-time check aborts
    exactly these; a structure whose Tc commits last is provably benign.

    Fekete et al. allow Ta and Tc to coincide (plain two-transaction write
    skew is the structure Tc -> Tb -> Tc): then "Tc first" only constrains
    Tc against Tb."""
    out = []
    for (ta, tb, tc) in dangerous_structures(h):
        ec = h.end_pos(tc)
        if ec < h.end_pos(tb) and (ta == tc or ec < h.end_pos(ta)):
            out.append((ta, tb, tc))
    return out


def ssi_accepts(h: History) -> bool:
    """A committed SI history is SSI-acceptable iff it is SI and contains no
    *fatal* dangerous structure (two successive vulnerable edges whose
    out-neighbour committed first — the Fekete et al. necessary condition
    for non-serializability under SI)."""
    return is_si_history(h) and not fatal_dangerous_structures(h)
