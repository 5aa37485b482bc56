"""RSS-versioned tensor stores (PyTorch port of `repro.tensorstore`): the
page-granular snapshot-read store, the versioned parameter store, the WAL
mirror, its plan executor and materialized views."""

from .versioned import VersionedParamStore
from .paged import (init_store, store_from_numpy, visible_slots,
                    snapshot_read_ref, visible_slots_members,
                    snapshot_read_members, publish_page, as_page_range,
                    gather_pages)
from .materialized import MaterializedView
from .mirror import PagedMirror, decode_value, encode_value
from .version_store import (AggOp, AggPlan, BatchPlan, ChainVersionStore,
                            GroupByPlan, MultiAggPlan, PagedVersionStore,
                            Plan, ScanPlan, VersionStore, agg_value,
                            apply_agg, apply_plan, finalize_agg, group_by,
                            plan_keys)

__all__ = [
    "VersionedParamStore",
    "init_store", "store_from_numpy", "visible_slots", "snapshot_read_ref",
    "visible_slots_members", "snapshot_read_members", "publish_page",
    "as_page_range", "gather_pages",
    "PagedMirror", "MaterializedView", "encode_value", "decode_value",
    "VersionStore", "ChainVersionStore", "PagedVersionStore",
    "AggOp", "AggPlan", "BatchPlan", "MultiAggPlan", "GroupByPlan",
    "ScanPlan", "Plan",
    "agg_value", "apply_agg", "apply_plan", "finalize_agg", "group_by",
    "plan_keys",
]
