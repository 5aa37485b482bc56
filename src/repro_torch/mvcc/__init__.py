"""Executable MVCC engine + HTAP architectures (the paper's Sec 5 systems)."""

from .store import Store, Version, VersionChain
from .engine import (Engine, Txn, Status, AbortReason, SerializationFailure)
from .certify import (Certifier, ConservativeSSI, CommitOrderSSI, SSN,
                      make_certifier, CERTIFIERS)
from .htap import SingleNodeHTAP, MultiNodeHTAP, Replica
from .workload import (Scale, load_initial, oltp_transaction, olap_query,
                       olap_freshness, write_skew)
from .driver import (Metrics, run_multi_node, run_sessions, run_single_node,
                     run_write_skew)

__all__ = [
    "Store", "Version", "VersionChain",
    "Engine", "Txn", "Status", "AbortReason", "SerializationFailure",
    "Certifier", "ConservativeSSI", "CommitOrderSSI", "SSN",
    "make_certifier", "CERTIFIERS",
    "SingleNodeHTAP", "MultiNodeHTAP", "Replica",
    "Scale", "load_initial", "oltp_transaction", "olap_query",
    "olap_freshness", "write_skew",
    "Metrics", "run_single_node", "run_multi_node", "run_sessions",
    "run_write_skew",
]
