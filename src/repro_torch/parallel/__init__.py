"""Sharded execution over a mesh of ranks: the process groups
(`group`: a rank's coordinates, device and axis sub-groups, the
collectives over one axis or several; `spawn`), tensor-parallel
placement (`tensor`: the ported partition rules applied to parameter
trees, the batch over "data", greedy decoding over vocab-sharded
logits) and sharded training (`fsdp`: the reference's training
placements as a storage layout, each layer gathered before its compute
and its gradient reduce-scattered into the rank's piece; `ServeView`,
the same pieces read by a server).  The model stack reduces its partial
sums and gathers its pieces through `models.sharding`;
`serve.ServingEngine(group=)` serves on it (tensor parallel, or with
`specs=` gathered from a training placement),
`train.make_train_step(group=)` and `train.Trainer(group=)` train on
it."""

from .fsdp import (Layout, ServeView, gather_state, init_local_state,
                   shard_state, train_specs)
from .group import MeshGroup, init_group, spawn
from .tensor import (check_tp, check_train, init_local_params, serve_specs,
                     shard_params)

__all__ = ["MeshGroup", "init_group", "spawn", "check_tp", "check_train",
           "init_local_params", "serve_specs", "shard_params", "Layout",
           "ServeView", "gather_state", "init_local_state", "shard_state",
           "train_specs"]
