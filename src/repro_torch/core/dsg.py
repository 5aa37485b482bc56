"""Direct serialization graph (DSG) over a multiversion history (Adya).

Edges over committed transactions (committed projection of the prefix):
  ww  Ta -> Tb : Ta installs a version of X, Tb installs the *next* version
                 of X in the version order (== commit order; SI version order).
  wr  Ta -> Tb : Tb reads the version of X that Ta wrote.
  rw  Ta -> Tb : Ta reads a version of X, and Tb installs the version of X
                 that *immediately follows* the read version (anti-dependency).

Serializable (VOCSR / PL-3) == DSG acyclic.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Iterable

from .history import History, T0

WW, WR, RW = "ww", "wr", "rw"


@dataclass(frozen=True)
class Edge:
    src: int
    dst: int
    kind: str
    key: str

    def __repr__(self) -> str:
        return f"{self.src} -{self.kind}({self.key})-> {self.dst}"


class DSG:
    def __init__(self, nodes: Iterable[int], edges: Iterable[Edge]):
        self.nodes: set[int] = set(nodes)
        self.edges: list[Edge] = list(edges)
        self.adj: dict[int, set[int]] = defaultdict(set)
        for e in self.edges:
            if e.src != e.dst:  # T ->* T reflexivity is not a cycle (paper 3.2)
                self.adj[e.src].add(e.dst)

    # ------------------------------------------------------------ reachability
    def reachable_from(self, src: int) -> set[int]:
        """All nodes reachable from src via directed edges (excl. src itself
        unless on a real cycle)."""
        seen: set[int] = set()
        stack = list(self.adj.get(src, ()))
        while stack:
            n = stack.pop()
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self.adj.get(n, ()))
        return seen

    def reaches(self, src: int, dst: int) -> bool:
        if src == dst:
            return True  # reflexive ->* per the paper's notation
        return dst in self.reachable_from(src)

    def has_cycle(self) -> bool:
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {n: WHITE for n in self.nodes}
        for root in self.nodes:
            if color[root] != WHITE:
                continue
            stack: list[tuple[int, Iterable[int]]] = [(root, iter(self.adj.get(root, ())))]
            color[root] = GRAY
            while stack:
                node, it = stack[-1]
                advanced = False
                for nxt in it:
                    if color.get(nxt, WHITE) == GRAY:
                        return True
                    if color.get(nxt, WHITE) == WHITE:
                        color[nxt] = GRAY
                        stack.append((nxt, iter(self.adj.get(nxt, ()))))
                        advanced = True
                        break
                if not advanced:
                    color[node] = BLACK
                    stack.pop()
        return False

    def edges_between(self, src: int, dst: int) -> list[Edge]:
        return [e for e in self.edges if e.src == src and e.dst == dst]


def build_dsg(h: History, *, restrict_to: set[int] | None = None) -> DSG:
    """Build the DSG of the committed projection of history h.

    restrict_to: optionally only consider this subset of committed txns
    (used for H(S_1..S_{n-1}) style restrictions).
    """
    committed = h.committed if restrict_to is None else (h.committed & restrict_to)

    # Version order per key: T0 first, then committed writers by commit order.
    order = [t for t in h.commit_order() if t in committed]
    versions: dict[str, list[int]] = defaultdict(lambda: [T0])
    for t in order:
        for key in sorted(h.writeset(t)):
            versions[key].append(t)

    # also include keys only ever read
    nxt: dict[tuple[str, int], int] = {}
    for key, chain in versions.items():
        for i, t in enumerate(chain[:-1]):
            nxt[(key, t)] = chain[i + 1]

    edges: list[Edge] = []
    # ww edges: consecutive writers
    for key, chain in versions.items():
        for i in range(1, len(chain) - 1):
            edges.append(Edge(chain[i], chain[i + 1], WW, key))

    for t in committed:
        for _, key, ver in h.reads_of(t):
            if ver != t and ver in committed or ver == T0:
                # wr edge from the writer of the read version
                if ver != T0 and ver != t:
                    edges.append(Edge(ver, t, WR, key))
                # rw anti-dependency to the writer of the *next* version
                follower = nxt.get((key, ver))
                if follower is not None and follower != t:
                    edges.append(Edge(t, follower, RW, key))
    return DSG(committed, edges)


def is_serializable(h: History) -> bool:
    """VOCSR membership: DSG of the committed projection is acyclic."""
    return not build_dsg(h).has_cycle()


def find_cycle(h: History) -> list[int] | None:
    """Return one dependency cycle (list of txn ids) if the DSG has one."""
    g = build_dsg(h)
    path: list[int] = []
    on_path: set[int] = set()
    visited: set[int] = set()

    def dfs(n: int) -> list[int] | None:
        visited.add(n)
        path.append(n)
        on_path.add(n)
        for m in g.adj.get(n, ()):
            if m in on_path:
                return path[path.index(m):] + [m]
            if m not in visited:
                res = dfs(m)
                if res is not None:
                    return res
        path.pop()
        on_path.discard(n)
        return None

    for node in g.nodes:
        if node not in visited:
            res = dfs(node)
            if res is not None:
                return res
    return None
