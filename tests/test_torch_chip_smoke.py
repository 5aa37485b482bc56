"""`chip_smoke.py`'s snapshot-read phases rehearsed on the CPU at a tiny
size (the plain versions stand in for the kernels), so the script's own
logic — traffic with writers left in flight, the whole-mirror read held
against `scan_members`, `scan_at` and the engine, the param-store oracle
— is checked here before it runs on the card at full size."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "TPCC", dict(
        warehouses=2, districts=4, customers=150, items=2000,
        order_capacity=40))
    monkeypatch.setattr(chip_smoke, "EMBED_P", 2000)
    monkeypatch.setattr(chip_smoke, "EMBED_E", 48)
    return chip_smoke


def test_path_phase_on_cpu(smoke, capsys):
    times = smoke.path_phase(torch, 500, device="cpu")
    assert {"rss_read_s", "engine_reads_s", "scan_at_and_sub_s"} <= set(times)
    out = capsys.readouterr().out
    assert "pages read a previous version" in out


def test_param_store_phase_on_cpu(smoke, capsys):
    smoke.param_store_phase(torch, device="cpu")
    assert "== oracle" in capsys.readouterr().out


def test_chip_smoke_refuses_without_cuda(monkeypatch):
    """No card: exit code 2, nothing printed on stdout."""
    import subprocess

    code = ("import sys, torch; torch.cuda.is_available = lambda: False; "
            f"sys.argv = ['chip_smoke.py']; sys.path.insert(0, {str(ROOT)!r});"
            " import chip_smoke; sys.exit(chip_smoke.main())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 2 and out.stdout == ""
