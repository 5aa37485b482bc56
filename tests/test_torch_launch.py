"""The port's launchers (`python -m repro_torch.launch.train` and
`... .serve`) against the reference's (`repro.launch.train`, `serve`) at
`--smoke` sizes on the CPU, for the same seed: each `main` run in the
process and its printed lines compared.

The port's `Trainer` draws its weights from a `torch.Generator`, the
reference's from `jax.random.PRNGKey(seed)`; here the port's
`init_state` is handed the reference's draw (carried by
`params_from_numpy`), so both train the same weights on the pipeline's
same batches.  Train: the metrics lines' steps equal, their losses and
gradient norms within the bf16 step parity's tolerance (3e-2 relative:
the smoke configs are bf16; Whisper's frames go to the port's encoder
rounded to bf16 and to the reference's in f32, by promotion), the final
loss within it, the published versions and the last checkpoint's step
equal.  Serve: the line (tokens' shape, snapshot LSN, lag) equal."""

import dataclasses
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import shared_cores  # noqa: E402,F401 (autouse)

import repro.configs as JC
import repro.models as JM
from repro.launch import serve as jserve
from repro.launch import train as jtrain

import repro_torch.models as TM
from repro_torch.checkpoint import manager as ckpt
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.train import loop

ARCHS = ["qwen1.5-0.5b", "whisper-tiny"]
TOL = 3e-2


@pytest.fixture
def reference_weights(monkeypatch):
    """The port's trainers start from the reference's weights for seed 0
    (the launchers' default)."""
    real = loop.init_state

    def carried(generator, cfg, opt_cfg, params=None, device=None):
        d = dataclasses.asdict(cfg)
        d["pattern"] = tuple(JM.LayerSpec(**s) for s in d["pattern"])
        jp = JM.init_params(jax.random.PRNGKey(0), JM.ModelConfig(**d))
        params = TM.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                      device)
        return real(None, cfg, opt_cfg, params=params, device=device)

    monkeypatch.setattr(loop, "init_state", carried)


def _run(main, argv, capsys) -> list[str]:
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_matches_the_reference(arch, tmp_path, capsys,
                                              reference_weights):
    argv = ["--arch", arch, "--smoke", "--steps", "4", "--batch", "2",
            "--seq", "16", "--publish", "--ckpt-every", "2"]
    want = _run(jtrain.main, argv + ["--ckpt-dir", str(tmp_path / "j")],
                capsys)
    got = _run(ttrain.main, argv + ["--ckpt-dir", str(tmp_path / "t"),
                                    "--device", "cpu"], capsys)
    assert len(got) == len(want) == 8
    for g, w in zip(got[:6], want[:6]):
        g, w = json.loads(g), json.loads(w)
        assert sorted(g) == sorted(w)
        assert g["step"] == w["step"]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, err_msg=k)
    final = lambda line: float(line.split()[2])
    assert got[6].startswith("final loss: ")
    np.testing.assert_allclose(final(got[6]), final(want[6]), rtol=TOL)
    assert got[7] == want[7] == "published versions: 5"
    assert ckpt.latest_step(str(tmp_path / "t")) == \
        ckpt.latest_step(str(tmp_path / "j")) == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_matches_the_reference(arch, capsys,
                                              reference_weights):
    argv = ["--arch", arch, "--smoke", "--train-steps", "2", "--steps", "4",
            "--prompt-len", "8"]
    want = _run(jserve.main, argv, capsys)
    got = _run(tserve.main, argv + ["--device", "cpu"], capsys)
    assert got == want
    assert got[-1].startswith(f"arch={arch}-smoke generated (2, 4) tokens")


def test_launchers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default runs")
    for main in (ttrain.main, tserve.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "1"]
                 if main is ttrain.main else
                 ["--arch", "qwen1.5-0.5b", "--smoke"])
