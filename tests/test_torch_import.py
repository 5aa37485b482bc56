"""The port stands alone: `repro_torch` (and `chip_smoke.py`, which drives
it on the GPU machine, where JAX is not installed) imports neither jax nor
the reference package `repro`, nor `ml_dtypes` (JAX's bf16 arrays; the
GPU machine does not list it)."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro|ml_dtypes)\b(?!_torch)"
    r"|from\s+(jax|repro|ml_dtypes)\b(?!_torch))", re.M)


def _port_modules():
    import repro_torch

    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_every_port_module_imports_without_jax_or_repro():
    names = _port_modules()
    for name in ("repro_torch.kernels.rss_scan_agg.kernel",
                 "repro_torch.mvcc.driver",
                 "repro_torch.serve.engine",
                 "repro_torch.kernels.flash_attention.kernel",
                 "repro_torch.kernels.decode_attention.kernel",
                 "repro_torch.models.transformer",
                 "repro_torch.configs.qwen1_5_0_5b",
                 "repro_torch.train.loop", "repro_torch.checkpoint.manager",
                 "repro_torch.optim.adamw", "repro_torch.data.pipeline",
                 "repro_torch.launch.train", "repro_torch.launch.serve",
                 "repro_torch.launch.mesh", "repro_torch.launch.shardings",
                 "repro_torch.launch.specs", "repro_torch.launch.dryrun",
                 "repro_torch.models.sharding",
                 "repro_torch.parallel.group", "repro_torch.parallel.tensor"):
        assert name in names
    code = ("import importlib, sys\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro',\n"
            "                                    'ml_dtypes'))\n"
            "print(bad)\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_or_repro_import_statement(path):
    text = (ROOT / path).read_text()
    assert not FORBIDDEN.findall(text), path
