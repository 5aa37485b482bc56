"""The port's meshes, partition rules, meta-tensor specs, sharding hint
and per-card residency dry-run (`repro_torch.launch.mesh`, `shardings`,
`specs`, `dryrun`, `repro_torch.models.sharding`) on the CPU.

The rules are held leaf for leaf against the reference's: for every
config, on the 16 x 16 and 2 x 16 x 16 production shapes and on 4 x 2,
the reference's `input_specs` of each shape of SHAPES (train: the state
with its optimizer and the batch; prefill: serving parameters and the
batch; decode: serving parameters, tokens, the KV cache and its length)
over a `jax.sharding.AbstractMesh` (its `sanitize` reads only the
mesh's shape and axis names, so no devices are needed) against the
port's over a logical `Mesh` of the same shape: the same leaves (but
the port's `expert_ids`), shapes, dtypes and partition specs (an axis
entry compared as the tuple of its axis names).  Serving's choice of
resident parameters reads a budget a card: the port's is the H100's,
and the parity test holds the rules under the reference's budget."""

import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import shared_cores  # noqa: E402,F401 (autouse)

from jax.sharding import AbstractMesh

import repro.configs as JC
from repro.launch import specs as JS

from repro_torch.configs import SHAPES, get_config, iter_cells, list_archs
from repro_torch.launch import dryrun, shardings, specs
from repro_torch.launch.mesh import (Mesh, dp_axes, make_host_mesh,
                                     make_production_mesh, train_dp_axes)
from repro_torch.models import sharding as TS
from repro_torch.tree import leaves_with_path, path_key

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}


def _norm(spec, ndim):
    entries = list(spec) + [None] * (ndim - len(spec))
    return tuple(None if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in entries)


def _ref_leaves(tree) -> dict:
    """path -> (shape, dtype name, spec) of a reference spec tree."""
    out = {}
    for path, x in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in path)
        out[key] = (tuple(x.shape), np.dtype(x.dtype).name,
                    _norm(x.sharding.spec, len(x.shape)))
    return out


def _port_leaves(placed) -> dict:
    out = {}
    for path, x in leaves_with_path(placed.tree):
        key = path_key(path)
        if key.endswith("expert_ids"):
            continue                    # the port's one extra leaf
        out[key] = (tuple(x.shape), str(x.dtype).replace("torch.", ""),
                    _norm(placed.specs[key], x.dim()))
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_rules_equal_the_reference_leaf_for_leaf(arch, mesh_name,
                                                 monkeypatch):
    monkeypatch.setattr(specs, "SERVE_RESIDENT_LIMIT",
                        JS.SERVE_RESIDENT_LIMIT)
    sizes, axes = MESHES[mesh_name]
    jmesh, tmesh = AbstractMesh(sizes, axes), Mesh(sizes, axes)
    jcfg, tcfg = JC.get_config(arch), get_config(arch)
    for name, shape in SHAPES.items():
        jmode, jspecs = JS.input_specs(jcfg, JC.SHAPES[name], jmesh)
        tmode, tspecs = specs.input_specs(tcfg, shape, tmesh)
        assert tmode == jmode
        for key, jtree in jspecs.items():
            if key == "opt_cfg":
                assert tspecs[key] == specs.adamw.AdamWConfig(
                    **vars(jtree))
                continue
            want, got = _ref_leaves(jtree), _port_leaves(tspecs[key])
            assert list(got) == list(want), (name, key)
            for path in want:
                assert got[path] == want[path], (name, key, path)


def test_sanitize_drops_indivisible_and_unknown_axes():
    mesh = Mesh((4, 2), ("data", "model"))
    assert shardings.sanitize(mesh, (8, 6, 3), ("data", "model", "model")) \
        == ("data", "model", None)
    assert shardings.sanitize(mesh, (8, 4), (("pod", "data"), "model")) \
        == (None, "model")
    assert shardings.sanitize(mesh, (8, 4), (("data", "model"),)) \
        == (("data", "model"), None)
    assert shardings.shards(mesh, (("data", "model"), None)) == 8


def test_meshes():
    m = make_production_mesh()
    assert (m.axis_sizes, m.axis_names, m.size) == \
        ((16, 16), ("data", "model"), 256)
    m2 = make_production_mesh(multi_pod=True)
    assert m2.shape == {"pod": 2, "data": 16, "model": 16}
    assert dp_axes(m2) == ("pod", "data") and dp_axes(m) == ("data",)
    assert train_dp_axes(m, get_config("qwen2-vl-72b")) == ("data", "model")
    assert make_host_mesh(device="cpu").shape == {"data": 1, "model": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh()


def test_hint_is_the_identity_on_one_device_and_refuses_a_larger_mesh():
    x = torch.ones(4, 8)
    assert TS.hint(x, "data", "model") is x            # no mesh active
    with TS.with_mesh(make_host_mesh(device="cpu")):
        assert TS.hint(x, "data", "model") is x
    with TS.with_mesh(make_production_mesh()):
        with pytest.raises(ValueError, match="ROADMAP"):
            TS.hint(x, "data", "model")
    assert TS.hint(x, "data", "model") is x            # the mesh is gone


@pytest.mark.parametrize("model_axis,resident", [(16, True), (2, False)])
def test_serving_keeps_parameters_resident_within_a_cards_budget(
        model_axis, resident):
    """Jamba's 398 B parameters in bf16 take 49.8 GB a card over a model
    axis of 16, within the H100's budget (resident: no parameter is cut
    over the data axis), and 399 GB over 2, beyond it (FSDP: some are)."""
    cfg = get_config("jamba-1.5-large-398b")
    assert specs.SERVE_RESIDENT_LIMIT == 0.75 * specs.CARD_BYTES
    mesh = Mesh((256 // model_axis, model_axis), ("data", "model"))
    placed = specs.params_specs(mesh, cfg, serving=True)
    over_data = [p for p, sp in placed.specs.items()
                 if any(e == "data" or (isinstance(e, tuple) and "data" in e)
                        for e in sp)]
    assert (not over_data) == resident

@pytest.mark.parametrize("arch", list_archs())
def test_dryrun_reports_every_cell(arch):
    """Every cell of `iter_cells()` on the single-pod mesh reports (or
    is skipped as the reference skips it), and each group's bytes a card
    equal its leaves' bytes divided by the pieces their specs give."""
    mesh = make_production_mesh()
    for a, shape_name, skip in iter_cells():
        if a != arch:
            continue
        r = dryrun.run_cell(arch, shape_name)
        if skip:
            assert "skipped" in r
            continue
        mode, sp = specs.input_specs(get_config(arch), SHAPES[shape_name],
                                     mesh)
        assert r["mode"] == mode and r["n_devices"] == 256
        want = {"params": 0, "opt": 0, "batch": 0, "cache": 0}
        for group, name, prefix in dryrun.GROUPS[mode]:
            for path, leaf in leaves_with_path(sp[name].tree):
                key = path_key(path)
                if key.startswith(prefix):
                    n = shardings.shards(mesh, sp[name].specs[key])
                    want[group] += leaf.numel() * leaf.element_size() / n
        want["total"] = sum(want.values())
        assert r["bytes_per_card"] == want
        assert r["bytes_per_card"]["params"] > 0
        assert (r["bytes_per_card"]["opt"] > 0) == (mode == "train")
        assert (r["bytes_per_card"]["cache"] > 0) == (mode != "train")


def test_dryrun_cli_writes_the_report(tmp_path, capsys):
    out = tmp_path / "r.json"
    assert dryrun.main(["--arch", "whisper-tiny", "--both-meshes",
                        "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert len(rows) == 8
    assert sum("skipped" in r for r in rows) == 2
    assert {tuple(r["mesh"]) for r in rows if "mesh" in r} == \
        {(16, 16), (2, 16, 16)}
    assert "8 cells, 0 failures" in capsys.readouterr().out
