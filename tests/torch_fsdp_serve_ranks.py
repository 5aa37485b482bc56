"""What each rank runs in tests/test_torch_fsdp_serve.py: `run(group,
jobs)`, which `repro_torch.parallel.spawn` starts in one process a rank
(pickled by name, so it lives in a module that imports neither jax nor
the test's reference).  Every job returns plain numpy and Python
values, or the text of the ValueError it met."""

import torch

from repro_torch.models import decode_step, prefill
from repro_torch.models.sharding import with_mesh
from repro_torch.parallel import (Layout, ServeView, shard_params,
                                  shard_state)
from repro_torch.serve import ServingEngine
from repro_torch.tensorstore import VersionedParamStore
from repro_torch.train import Trainer, init_state
from repro_torch.train import loop

from torch_tp_ranks import replaying


def run(group, jobs):
    """[JOBS[name](group, *args) for (name, args) in jobs]."""
    return [JOBS[name](group, *args) for name, args in jobs]


def _counting(group):
    """Counts the group's all-reduces (a `psum` over "model" would be
    one) in the returned list's one entry."""
    calls, reduce = [0], group.all_reduce

    def counted(*a, **kw):
        calls[0] += 1
        return reduce(*a, **kw)
    group.all_reduce = counted
    return calls


def logits(group, cfg, tree, specs, batch, toks, routes=None):
    """The rank's pieces of the whole `tree` under `specs`, its rows of
    the batch over the placement's batch axes, prefill and N
    teacher-forced decode steps of `toks` [B, N] under the rank's
    `ServeView`, the MoE layers replaying `routes` cut to its rows:
    (batch rank, [prefill logits, step logits...] f32 numpy, the shapes
    of its cache entries by pattern position, the routing choices that
    flipped, the all-reduces made, the gathers made)."""
    view = ServeView(group, cfg, specs)
    local = shard_params(cfg, tree, group.mesh, group.coords, specs=specs)
    view.check(local)
    b = view.rows(batch)
    t = view.rows({"tokens": toks})["tokens"]
    mine = None if routes is None else [
        view.rows({"tokens": r})["tokens"] for r in routes]
    S, N = b["tokens"].shape[1], t.shape[1]
    reduces = _counting(group)
    with torch.no_grad(), with_mesh(view), replaying(mine, None) as flips:
        lg, cache = prefill(local, cfg, b, cache_len=S + N)
        got = [lg]
        for k in range(N):
            lg, cache = decode_step(local, cfg, t[:, k:k + 1], cache, S + k)
            got.append(lg)
    shapes = [{k: tuple(x.shape) for k, x in entry.items()}
              for entry in cache["blocks"]]
    return (view.batch_rank, [x.float().numpy() for x in got], shapes,
            flips[0], reduces[0], view.gathers)


def engine(group, cfg, tree, specs, batch, n_steps):
    """The rank's pieces of `tree` under `specs` published into its own
    store, then one `generate` of `batch` (the whole batch, on every
    rank) through an engine over the mesh serving them gathered:
    (tokens, snapshot lsn, freshness lag, all-reduces made)."""
    store = VersionedParamStore(slots=2)
    store.publish(shard_params(cfg, tree, group.mesh, group.coords,
                               specs=specs))
    eng = ServingEngine(cfg, store,
                        max_seq=batch["tokens"].shape[1] + n_steps,
                        device="cpu", group=group, specs=specs)
    eng.refresh()
    reduces = _counting(group)
    res = eng.generate(batch, n_steps)
    return res.tokens.numpy(), res.snapshot_lsn, res.freshness_lag, \
        reduces[0]


def htap(group, cfg, opt, params, batch, seq_len, train_steps, prompt,
         n_steps):
    """`repro.launch.serve`'s flow on the mesh: a `Trainer(group=)`
    starting from the rank's pieces of `params` (the reference's draw)
    publishes `train_steps` steps of `batch` rows x `seq_len` into the
    rank's own store, then a `ServingEngine(group=, specs=<the trainer's
    parameter placement>)` serves all-ones prompts [batch, prompt] for
    `n_steps` steps: (tokens, snapshot lsn, freshness lag)."""
    carried = lambda cfg_, gen, grp, opt_cfg, dev: shard_state(
        init_state(None, cfg_, opt_cfg, params=params, device=dev),
        Layout(grp, cfg_, opt_cfg))
    saved, loop.init_local_state = loop.init_local_state, carried
    try:
        store = VersionedParamStore(slots=2)
        tr = Trainer(cfg, batch=batch, seq_len=seq_len, opt=opt, seed=0,
                     store=store, device="cpu", group=group)
    finally:
        loop.init_local_state = saved
    tr.run(train_steps)
    eng = ServingEngine(cfg, store, max_seq=prompt + n_steps + 8,
                        device="cpu", group=group,
                        specs=tr.layout.param_specs)
    eng.refresh()
    res = eng.generate({"tokens": torch.ones((batch, prompt),
                                             dtype=torch.int32)}, n_steps)
    return res.tokens.numpy(), res.snapshot_lsn, res.freshness_lag


def pins(group, cfg, tree, specs, batch, publish_at):
    """v1 (the rank's pieces of `tree`) served by request 1, v2 (v1
    with its embedding negated) published on every rank under request
    1's pin after its decode step `publish_at`, then request 2: per
    request (snapshot lsn, the version each prefill and decode call
    read, tokens), and the pins left in the store's slots."""
    store = VersionedParamStore(slots=2)
    v1 = shard_params(cfg, tree, group.mesh, group.coords, specs=specs)
    v2 = dict(v1, embed=-v1["embed"])
    store.publish(v1)
    eng = ServingEngine(cfg, store, max_seq=batch["tokens"].shape[1] + 4,
                        device="cpu", group=group, specs=specs)
    eng.refresh()
    seen = []
    name = lambda p: "v1" if p is v1 else "v2" if p is v2 else "?"
    prefill_fn, decode_fn = eng._prefill, eng._decode
    eng._prefill = lambda p, b: (seen.append(name(p)), prefill_fn(p, b))[1]

    def decode(p, *a):
        seen.append(name(p))
        if len(seen) == 1 + publish_at and p is v1:
            store.publish(v2)                 # commit under the pin
        return decode_fn(p, *a)
    eng._decode = decode
    out = []
    for _ in range(2):
        seen.clear()
        res = eng.generate(batch, 4, refresh_between_steps=True)
        out.append((res.snapshot_lsn, list(seen), res.tokens.numpy()))
        eng.refresh()
    return out, [s.pins for s in store.slots]


def mismatch(group, cfg, tree, specs, batch):
    """The whole `tree` published where `specs` cut it: the engine's
    ValueError on every rank."""
    store = VersionedParamStore(slots=2)
    store.publish(tree)
    eng = ServingEngine(cfg, store, max_seq=batch["tokens"].shape[1] + 2,
                        device="cpu", group=group, specs=specs)
    eng.refresh()
    try:
        eng.generate(batch, 2)
    except ValueError as e:
        return str(e), [s.pins for s in store.slots]
    return None, [s.pins for s in store.slots]


JOBS = {"logits": logits, "engine": engine, "htap": htap, "pins": pins,
        "mismatch": mismatch}
