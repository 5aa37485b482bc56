"""What each rank runs in tests/test_torch_fsdp_train.py and
tests/test_torch_pod_train.py: `run(group, jobs)`, which
`repro_torch.parallel.spawn` starts in one process a rank (pickled by
name, so it lives in a module that imports neither jax nor the test's
reference).  Every job returns plain Python values and CPU tensors; the
whole state, where a job returns it, from rank 0 only.  The serving
jobs of tests/torch_fsdp_serve_ranks.py and tests/torch_tp_ranks.py run
here too, so a pod mesh's ranks train and serve in one spawn."""

import torch

import torch_fsdp_serve_ranks
import torch_tp_ranks

from repro_torch.checkpoint import manager as ckpt
from repro_torch.parallel.fsdp import (gather_state, init_local_state,
                                       shard_state)
from repro_torch.tensorstore import VersionedParamStore
from repro_torch.train import Trainer, init_state, make_train_step
from repro_torch.tree import leaves, leaves_with_path, path_key


def run(group, jobs):
    """[JOBS[name](group, *args) for (name, args) in jobs]."""
    return [JOBS[name](group, *args) for name, args in jobs]


def _whole(state, layout, group):
    """The gathered state on rank 0, None on the others (every rank
    takes part in the gathers)."""
    whole = gather_state(state, layout)
    return whole if group.rank == 0 else None


def step(group, cfg, opt, state, batch):
    """The rank's pieces of the whole `state`, its rows of the global
    `batch`, one sharded step: {"metrics", "state" (gathered, rank 0),
    "gathers", "reduce_scatters", "pieces" ({leaf path: the rank's
    piece of each parameter}, rank 0 and the last rank)}."""
    train_step = make_train_step(cfg, opt, group)
    layout = train_step.layout
    new, metrics = train_step(shard_state(state, layout),
                              layout.rows(batch, cfg.microbatches))
    ends = group.rank in (0, group.mesh.size - 1)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": _whole(new, layout, group),
            "gathers": layout.gathers,
            "reduce_scatters": layout.reduce_scatters,
            "pieces": {path_key(p): x.clone() for p, x in
                       leaves_with_path(new["params"])} if ends else None}


def _bits(x):
    """`x`'s bytes, flat (its bits, whatever its dtype)."""
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def _replicas_equal(state, group):
    """Whether each leaf of the rank's `state` equals, bit for bit, the
    same leaf on every rank that differs from it on "pod" alone (True
    without a pod axis)."""
    if "pod" not in group.mesh.axis_names:
        return True
    for x in leaves(state):
        mine = _bits(x)
        every = group.all_gather(mine[None], ("pod",))
        if not all(torch.equal(row, mine) for row in every):
            return False
    return True


def steps(group, cfg, opt, state, batches):
    """The rank's pieces of the whole `state`, then a sharded step on its
    rows of each global batch of `batches`: {"metrics" (a step's each),
    "replicas" (after each step, `_replicas_equal`), "state" (gathered,
    rank 0)}."""
    train_step = make_train_step(cfg, opt, group)
    layout = train_step.layout
    state = shard_state(state, layout)
    metrics, same = [], []
    for batch in batches:
        state, m = train_step(state, layout.rows(batch, cfg.microbatches))
        metrics.append({k: float(v) for k, v in m.items()})
        same.append(_replicas_equal(state, group))
    return {"metrics": metrics, "replicas": same,
            "state": _whole(state, layout, group)}


def _saved(group, cfg, opt, state, batch, ckpt_dir):
    """One sharded step, then the state saved under the group (step 1):
    (the gathered state (rank 0), the all-gathers the rank made in the
    save)."""
    train_step = make_train_step(cfg, opt, group)
    layout = train_step.layout
    new, _ = train_step(shard_state(state, layout),
                        layout.rows(batch, cfg.microbatches))
    calls, gather = [0], group.all_gather

    def counted(*a, **kw):
        calls[0] += 1
        return gather(*a, **kw)
    group.all_gather = counted
    try:
        ckpt.save(new, 1, ckpt_dir, group=group, specs=layout.specs.state)
    finally:
        group.all_gather = gather
    return _whole(new, layout, group), calls[0]


def save(group, cfg, opt, state, batch, ckpt_dir):
    """One sharded step, then the state saved under the group (step 1):
    the gathered state (rank 0)."""
    return _saved(group, cfg, opt, state, batch, ckpt_dir)[0]


def restore(group, cfg, opt, ckpt_dir):
    """The rank's pieces of the checkpoint under this mesh's specs
    (a "meta" template), gathered (rank 0)."""
    layout = make_train_step(cfg, opt, group).layout
    template = dict(layout.meta, step=torch.zeros((), dtype=torch.int32,
                                                  device="meta"))
    local = ckpt.restore(ckpt_dir, template, device="cpu", group=group,
                         specs=layout.specs.state)
    return _whole(local, layout, group)


def init(group, cfg, opt, seed):
    """`init_local_state` of `seed` against the rank's pieces of
    `init_state` of the same seed: the paths that differ."""
    layout = make_train_step(cfg, opt, group).layout
    got = init_local_state(cfg, torch.Generator().manual_seed(seed), group,
                           opt, "cpu")
    want = shard_state(init_state(torch.Generator().manual_seed(seed), cfg,
                                  opt, device="cpu"), layout)
    return [path_key(p) for (p, a), (_, b) in
            zip(leaves_with_path(got), leaves_with_path(want))
            if a.shape != b.shape or not torch.equal(a, b)]


def trainer(group, cfg, opt, batch, seq_len, ckpt_dir):
    """`Trainer(group=)` publishing into the rank's own store, a reader
    pinned at v1 before the first step, 3 steps with a checkpoint after
    each and a failure injected before step 2 (restored from the step-2
    checkpoint): {"losses", "v1_bitwise" (the pinned read against the
    rank's v1 pieces), "lsns", "params" (gathered, rank 0)}."""
    store = VersionedParamStore(slots=2)
    tr = Trainer(cfg, batch=batch, seq_len=seq_len, opt=opt, seed=0,
                 ckpt_dir=ckpt_dir, ckpt_every=1, store=store,
                 device="cpu", group=group)
    v1 = {path_key(p): x.clone() for p, x in
          leaves_with_path(tr.state["params"])}
    pin, tree = store.pin_snapshot()
    log = tr.run(3, inject_failure_at=2)
    store.refresh()
    same = all(torch.equal(x, v1[path_key(p)])
               for p, x in leaves_with_path(tree))
    lsns = (store.pinned_lsn(pin), store.visible_lsn())
    store.release(pin)
    whole = _whole(tr.state, tr.layout, group)
    return {"losses": [m["loss"] for m in log], "v1_bitwise": same,
            "lsns": lsns, "params": whole and whole["params"]}


JOBS = {"step": step, "steps": steps, "save": save, "saved": _saved,
        "restore": restore, "init": init, "trainer": trainer,
        "serve logits": torch_fsdp_serve_ranks.logits,
        "serve engine": torch_fsdp_serve_ranks.engine,
        "tp logits": torch_tp_ranks.logits,
        "tp engine": torch_tp_ranks.engine}
