"""RSS-versioned paged stores: the WAL mirror, its plan executor and
materialized views (PyTorch port of `repro.tensorstore`'s OLAP path)."""

from .paged import as_page_range
from .materialized import MaterializedView
from .mirror import PagedMirror, decode_value, encode_value
from .version_store import (AggOp, AggPlan, BatchPlan, ChainVersionStore,
                            GroupByPlan, MultiAggPlan, PagedVersionStore,
                            Plan, ScanPlan, VersionStore, agg_value,
                            apply_agg, apply_plan, finalize_agg, group_by,
                            plan_keys)

__all__ = [
    "as_page_range",
    "PagedMirror", "MaterializedView", "encode_value", "decode_value",
    "VersionStore", "ChainVersionStore", "PagedVersionStore",
    "AggOp", "AggPlan", "BatchPlan", "MultiAggPlan", "GroupByPlan",
    "ScanPlan", "Plan",
    "agg_value", "apply_agg", "apply_plan", "finalize_agg", "group_by",
    "plan_keys",
]
