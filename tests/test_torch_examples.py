"""The port's example twins (`examples/pt_anomaly_demo.py`,
`examples/pt_cluster_fanout.py`, `examples/pt_observability_demo.py`) run
on the CPU and print the reference script's logical output for the same
seed: the anomaly's four outcomes and the cluster demo line for line; the
observability demo's counts (plans served, stage and commit samples, the
span trees' shape, dispatches, commits, spans), with its wall-clock
latencies masked."""

import importlib.util
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from torch_threads import shared_cores  # noqa: E402,F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _run(name: str, capsys, *args) -> str:
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    capsys.readouterr()
    mod.main(*args)
    return capsys.readouterr().out


@pytest.mark.parametrize("name", ["anomaly_demo", "cluster_fanout"])
def test_twin_prints_the_reference_output(name, capsys):
    want = _run(name, capsys)
    got = _run(f"pt_{name}", capsys, "cpu")
    assert got == want
    assert got.strip()


def _logical(out: str) -> list[str]:
    """The demo's lines with wall-clock numbers masked; the export lines
    (whose bucket counts and JSON size follow the latencies) dropped."""
    keep = out.split("\n5) exports")[0]
    keep = re.sub(r"\s*-?\d+\.\d+us", " _us", keep)
    return [re.sub(r" +", " ", ln).strip() for ln in keep.splitlines()]


def test_observability_twin_counts_equal_the_reference(capsys):
    want = _logical(_run("observability_demo", capsys))
    out = _run("pt_observability_demo", capsys, "cpu")
    got = _logical(out)
    assert got == want
    assert any("n=452" in ln for ln in got)
    assert "span trees balanced" in out and "prometheus text" in out
