"""What each rank runs in tests/test_torch_tp_serve.py: `run(group,
jobs)`, which `repro_torch.parallel.spawn` starts in one process a rank
(pickled by name, so it lives in a module that imports neither jax nor
the test's reference).  Every job returns plain numpy and Python
values."""

import contextlib

import torch

from repro_torch.models import decode_step, layers, prefill
from repro_torch.models.sharding import with_mesh
from repro_torch.parallel import shard_params
from repro_torch.parallel.tensor import gather_vocab, split_batch
from repro_torch.serve import ServingEngine
from repro_torch.tensorstore import VersionedParamStore


def run(group, jobs):
    """[JOBS[name](group, *args) for (name, args) in jobs]."""
    return [JOBS[name](group, *args) for name, args in jobs]


@contextlib.contextmanager
def replaying(routes, group):
    """Inside the block, the i-th `layers.moe_route` call takes the
    experts of routes[i] (the whole batch's [B, S, K]; under a `group`,
    the rank's rows over "data") instead of its own top-k, with its own
    router's softmax at them, renormalised, and its own slots.  Yields a
    list whose one entry counts the choices where a call's own top-k
    differed.  `routes` None: no replay."""
    flips = [0]
    if routes is None:
        yield flips
        return
    route, calls = layers.moe_route, iter(routes)

    def replayed(p, x, cfg, *, capacity_factor=0.0):
        _, own, _ = route(p, x, cfg, capacity_factor=capacity_factor)
        idx = next(calls)
        if group is not None:
            idx = split_batch({"tokens": idx}, group)["tokens"]
        flips[0] += int((own != idx).sum())
        vals = torch.softmax(x.float() @ p["router"], -1).gather(-1, idx)
        vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
        C = layers.moe_capacity(cfg, x.shape[1], capacity_factor)
        return vals, idx, layers.moe_slots(idx, cfg.n_experts, C)

    layers.moe_route = replayed
    try:
        yield flips
    finally:
        layers.moe_route = route
    if next(calls, None) is not None:
        raise AssertionError("MoE calls left unreplayed")


def logits(group, cfg, tree, batch, toks, routes=None):
    """The rank's pieces of the whole `tree`, its rows of the batch over
    "data", prefill and N teacher-forced decode steps of `toks` [B, N]
    under the mesh, the MoE layers replaying `routes` (`replaying`):
    (data rank, [prefill logits, step logits...] gathered over "model",
    f32 numpy, the shapes of the rank's cache entries [{name: shape}]
    by pattern position, the routing choices that flipped)."""
    local = shard_params(cfg, tree, group.mesh, group.coords)
    b = split_batch(batch, group)
    t = split_batch({"tokens": toks}, group)["tokens"]
    S, N = b["tokens"].shape[1], t.shape[1]
    with torch.no_grad(), with_mesh(group), \
            replaying(routes, group) as flips:
        lg, cache = prefill(local, cfg, b, cache_len=S + N)
        got = [gather_vocab(lg, group)]
        for k in range(N):
            lg, cache = decode_step(local, cfg, t[:, k:k + 1], cache, S + k)
            got.append(gather_vocab(lg, group))
    shapes = [{k: tuple(x.shape) for k, x in entry.items()}
              for entry in cache["blocks"]]
    return (group.data_rank, [x.float().numpy() for x in got], shapes,
            flips[0])


def engine(group, cfg, tree, batch, n_steps):
    """The rank's pieces of `tree` published into its own store, then one
    `generate` of `batch` (the whole batch, on every rank) through an
    engine over the mesh: (tokens, snapshot lsn)."""
    store = VersionedParamStore(slots=2)
    store.publish(shard_params(cfg, tree, group.mesh, group.coords))
    eng = ServingEngine(cfg, store,
                        max_seq=batch["tokens"].shape[1] + n_steps,
                        device="cpu", group=group)
    eng.refresh()
    res = eng.generate(batch, n_steps)
    return res.tokens.numpy(), res.snapshot_lsn


def pins(group, cfg, tree, batch, fault):
    """v1, then v2 (v1 with its embedding negated) published on every
    rank, but only rank 0 refreshes after v2; then a request of 2 steps.
    `fault` "lacking": rank 1 never publishes v2; "extra": rank 1
    publishes one version more, before v1, so its v1 has the commit LSN
    of rank 0's v2.  Returns (snapshot lsn, the version each prefill and
    decode call read, newest visible lsn, pins left in the store's
    slots), or the ValueError's text."""
    store = VersionedParamStore(slots=2)
    v1 = shard_params(cfg, tree, group.mesh, group.coords)
    v2 = dict(v1, embed=-v1["embed"])
    if fault == "extra" and group.rank == 1:
        store.publish(dict(v1, embed=2 * v1["embed"]))
    store.publish(v1)
    eng = ServingEngine(cfg, store, max_seq=batch["tokens"].shape[1] + 2,
                        device="cpu", group=group)
    eng.refresh()
    if not (fault == "lacking" and group.rank == 1):
        store.publish(v2)
    if group.rank == 0:
        eng.refresh()
    seen = []
    name = lambda p: "v1" if p is v1 else "v2" if p is v2 else "?"
    prefill_fn, decode_fn = eng._prefill, eng._decode
    eng._prefill = lambda p, b: (seen.append(name(p)), prefill_fn(p, b))[1]
    eng._decode = lambda p, *a: (seen.append(name(p)), decode_fn(p, *a))[1]
    try:
        res = eng.generate(batch, 2)
    except ValueError as e:
        return str(e)
    return (res.snapshot_lsn, seen, store.visible_lsn(),
            [s.pins for s in store.slots])


JOBS = {"logits": logits, "engine": engine, "pins": pins}
