"""Sharded execution over a mesh of ranks: the process groups
(`group`: a rank's coordinates, device and axis sub-groups; `spawn`) and
tensor-parallel placement (`tensor`: the ported partition rules applied
to parameter trees, the batch over "data", greedy decoding over
vocab-sharded logits).  The model stack reduces its partial sums through
`models.sharding`; `serve.ServingEngine(group=)` serves on it."""

from .group import MeshGroup, init_group, spawn
from .tensor import (check_tp, init_local_params, serve_specs,
                     shard_params)

__all__ = ["MeshGroup", "init_group", "spawn", "check_tp",
           "init_local_params", "serve_specs", "shard_params"]
