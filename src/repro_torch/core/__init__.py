"""Core: the paper's contribution — RSS theory + SSI-based construction.

Layers:
  history.py        Adya-style multiversion histories (VOCSR prerequisites)
  dsg.py            direct serialization graph, cycles, reachability
  ssi.py            SI-V / SI-W / vulnerable deps / dangerous structures
  rss.py            Definition 4.1/4.2, Algorithm 1, PRoT construction
  safe_snapshots.py Ports & Grittner deferrable-snapshot baseline
  wal.py            begin/commit/abort + rw-dependency logical messages
  replica.py        log-shipping replay, RSS manager, PRoT manager
"""

from .history import (History, Op, T0, b, r, w, c, a,
                      read_only_anomaly_example)
from .dsg import DSG, Edge, build_dsg, is_serializable, find_cycle, WW, WR, RW
from .ssi import (si_v_holds, si_w_holds, is_si_history, vulnerable_edges,
                  dangerous_structures, fatal_dangerous_structures,
                  ssi_accepts, Vulnerable)
from .rss import (is_rss, rss_violations, done_set, clear_set, obscure_set,
                  construct_rss, construct_rss_ssi, IncrementalRss, advance,
                  latest_versions_in, protected_read, with_protected_reader)
from .safe_snapshots import snapshot_is_safe, earliest_safe_point, reader_wait
from .wal import Wal, WalRecord
from .replica import RSSManager, PRoTManager, RssSnapshot, replicate

__all__ = [
    "History", "Op", "T0", "b", "r", "w", "c", "a",
    "read_only_anomaly_example",
    "DSG", "Edge", "build_dsg", "is_serializable", "find_cycle",
    "WW", "WR", "RW",
    "si_v_holds", "si_w_holds", "is_si_history", "vulnerable_edges",
    "dangerous_structures", "fatal_dangerous_structures",
    "ssi_accepts", "Vulnerable",
    "is_rss", "rss_violations", "done_set", "clear_set", "obscure_set",
    "construct_rss", "construct_rss_ssi", "IncrementalRss", "advance",
    "latest_versions_in",
    "protected_read", "with_protected_reader",
    "snapshot_is_safe", "earliest_safe_point", "reader_wait",
    "Wal", "WalRecord", "RSSManager", "PRoTManager", "RssSnapshot",
    "replicate",
]
