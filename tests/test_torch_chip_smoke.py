"""`chip_smoke.py`'s snapshot-read and serve phases rehearsed on the CPU
at a tiny size (the plain versions stand in for the kernels), so the
script's own logic — traffic with writers left in flight, the
whole-mirror read held against `scan_members`, `scan_at` and the engine,
the param-store oracle, the serve phase's writer under a pinned request
and its checks (a), (b) and (d) — is checked here before it runs on the
card at full size."""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import shared_cores  # noqa: E402,F401 (autouse)

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
    monkeypatch.setattr(chip_smoke, "SERVE_SMOKE", True)
    for name, value in (("SERVE_B", 2), ("SERVE_S", 24), ("SERVE_STEPS", 6),
                        ("SERVE_PUBLISH_AT", 2)):
        monkeypatch.setattr(chip_smoke, name, value)
    for name, value in (("TRAIN_SMOKE", True), ("TRAIN_B", 2),
                        ("TRAIN_S", 16), ("TRAIN_STEPS", 3),
                        ("TRAIN_SERVE", (1, 4, 2)), ("TRAIN_CHECK_B", 2),
                        ("TRAIN_CRASH_LAYERS", 1)):
        monkeypatch.setattr(chip_smoke, name, value)
    return chip_smoke


def test_path_phase_on_cpu(smoke, capsys):
    times = smoke.path_phase(torch, 500, device="cpu")
    assert {"rss_read_s", "engine_reads_s", "scan_at_and_sub_s"} <= set(times)
    out = capsys.readouterr().out
    assert "pages read a previous version" in out


def test_param_store_phase_on_cpu(smoke, capsys):
    smoke.param_store_phase(torch, device="cpu")
    assert "== oracle" in capsys.readouterr().out


def test_serve_phase_on_cpu(smoke, capsys):
    """Qwen1.5-0.5B's smoke variant (bf16) through the serve phase: no
    kernel launches off the card, the plain path standing in."""
    import numpy as np

    launches = smoke.serve_phase(torch, np, device="cpu")
    assert launches == {"flash_attention": 0, "decode_attention": 0}
    out = capsys.readouterr().out
    assert "serve request 2" in out and "serve checks: (a)" in out


def test_long_context_serve_phase_on_cpu(smoke, capsys, monkeypatch):
    """The long-context Qwen run (one prompt) through the same serve
    phase at a tiny size: its own shape, checks (a), (b) and (d), the
    split count printed."""
    import numpy as np

    monkeypatch.setitem(smoke.SERVE_LONG, "qwen1.5-0.5b", (1, 40, 6))
    launches = smoke.serve_phase(torch, np, device="cpu", long=True)
    assert launches == {"flash_attention": 0, "decode_attention": 0}
    out = capsys.readouterr().out
    assert "serve request 2 (qwen1.5-0.5b-smoke long context)" in out
    assert "(1x40 tokens)" in out and "(0 of them split)" in out


def test_tp_serve_phase_on_cpu(smoke, capsys, monkeypatch, tmp_path):
    """The sharded serve phase at the smoke size: Qwen2-VL's smoke config
    (2 KV heads) on a mesh of (1, 2), two ranks over gloo on the CPU,
    checks (s1) and (s2); no kernel launches off the card."""
    import numpy as np

    for name, value in (("TP_B", 2), ("TP_S", 24), ("TP_STEPS", 4),
                        ("TP_PUBLISH_AT", 2), ("TP_DIR", tmp_path)):
        monkeypatch.setattr(smoke, name, value)
    launches = smoke.tp_serve_phase(torch, np, device="cpu",
                                    mesh_shape=(1, 2))
    assert launches == {"flash_attention tp4": 0, "decode_attention tp4": 0}
    out = capsys.readouterr().out
    assert "2 ranks on the CPU over gloo" in out
    assert "tp serve rank 1 {'data': 0, 'model': 1}" in out
    assert "(s1) sharded vs unsharded kernel path" in out
    assert "request 1 read v1 in all 5 calls" in out
    assert not list(tmp_path.iterdir())         # the reference removed


def test_jamba_tp_serve_phase_on_cpu(smoke, capsys, monkeypatch, tmp_path):
    """The sharded serve phase's Jamba at the smoke size, cut as on the
    card (one period of 8 layers, experts 0-1 of 4 in each MoE layer) on
    a mesh of (1, 2), two ranks over gloo on the CPU: the unsharded
    path's routing written under TP_DIR and replayed into every rank,
    each rank's Mamba cache of Di / 2 channels, every scan launch of
    (s1) held against plain, (s2); no kernel launches off the card.  The
    smoke variant's 128-wide bf16 layers put the sharded logits ~3e-2 of
    their max-abs from the unsharded ones (the partial sums' bf16
    roundings), so the rehearsal prints (s1) unbounded, as
    `test_jamba_serve_phase_on_cpu` prints (a) and (b); the card holds
    it at 3e-2."""
    import numpy as np

    arch = "jamba-1.5-large-398b"
    for name, value in (("TP_B", 2), ("TP_S", 24), ("TP_STEPS", 4),
                        ("TP_PUBLISH_AT", 2), ("TP_DIR", tmp_path)):
        monkeypatch.setattr(smoke, name, value)
    monkeypatch.setitem(smoke.SERVE_BF16_TOL, arch, None)
    launches = smoke.tp_serve_phase(torch, np, device="cpu",
                                    mesh_shape=(1, 2), arch=arch)
    assert launches == {"flash_attention tp4": 0, "decode_attention tp4": 0,
                        "ssm_scan tp4": 0, "ssm_scan step tp4": 0}
    out = capsys.readouterr().out
    assert "experts 0-1 of 4, mesh {'data': 1, 'model': 2}" in out
    assert ("every rank's Mamba cache {'ssm': (1, 2, 128, 8), 'conv': "
            "(1, 2, 3, 128)} (Di 128 of 256)") in out
    assert "(s1)'s 35 ssm_scan launches a rank held against plain" in out
    assert "MoE routing replayed in (s1): of 448 routing decisions" in out
    assert "Jamba's bf16 noise floor at 8 layers" in out
    assert "request 1 read v1 in all 5 calls" in out
    assert not list(tmp_path.iterdir())         # reference and routing


def test_rwkv_tp_serve_phase_on_cpu(smoke, capsys, monkeypatch, tmp_path):
    """The sharded serve phase's RWKV6 at the smoke size on its mesh of
    (2, 2) (`TP_MESHES`), four ranks over gloo on the CPU: the unsharded
    kernel path run on each data rank's row, (s1) within the bf16 bound,
    every rank's state whole-headed, every `wkv_scan` launch of (s1) held
    against plain, (s2), no plain version called in the requests' count;
    no kernel launches off the card."""
    import numpy as np

    for name, value in (("TP_B", 2), ("TP_S", 24), ("TP_STEPS", 4),
                        ("TP_PUBLISH_AT", 2), ("TP_DIR", tmp_path)):
        monkeypatch.setattr(smoke, name, value)
    launches = smoke.tp_serve_phase(torch, np, device="cpu",
                                    arch="rwkv6-3b")
    assert launches == {"wkv_scan tp4": 0, "wkv_scan step tp4": 0}
    out = capsys.readouterr().out
    assert "rwkv6-3b-smoke 2 of 32 layers, mesh {'data': 2, 'model': 2}" \
        in out
    assert "4 ranks on the CPU over gloo" in out
    assert "tp serve rank 3 {'data': 1, 'model': 1}" in out
    assert "the unsharded kernel path run on each data rank's 1 rows" in out
    assert ("every rank's RWKV state {'shift': (2, 1, 128), 'wkv': "
            "(2, 1, 4, 32, 32), 'cmix_shift': (2, 1, 128)}") in out
    assert "(s1)'s 10 wkv_scan launches a rank held against plain" in out
    assert "request 1 read v1 in all 5 calls" in out
    assert not list(tmp_path.iterdir())         # the reference removed


def test_fsdp_train_phase_on_cpu(smoke, capsys, monkeypatch, tmp_path):
    """The sharded train phase at the smoke size: Qwen1.5's smoke config
    under fsdp2d on a mesh of (1, 2), two ranks over gloo on the CPU,
    checks (f1)-(f5), then each rank serving what it trained from its
    own store, gathered under the trainer's placement, checks (h1)-(h3);
    then the pod step (i) on (pod 2, data 1, model 2), four ranks, checks
    (f1)-(f4) against the same unsharded step and the pod replicas equal
    after each step; no kernel launches off the card.  Four rows a step,
    so each pod rank's two rows run as POD_MICROBATCHES microbatches."""
    import numpy as np

    monkeypatch.setattr(smoke, "TRAIN_B", 4)
    monkeypatch.setattr(smoke, "FSDP_DIR", tmp_path)
    monkeypatch.setattr(smoke, "FSDP_SERVE", (4, 16, 4))
    monkeypatch.setattr(smoke, "FSDP_PUBLISH_AT", 2)
    launches = smoke.fsdp_train_phase(torch, np, device="cpu",
                                      mesh_shape=(1, 2))
    assert launches == {"flash_attention": 0, "flash_attention_bwd": 0,
                        "flash_attention_bwd fsdp4": 0,
                        "flash_attention fsdp serve": 0,
                        "decode_attention fsdp serve": 0}
    out = capsys.readouterr().out
    assert "2 ranks on the CPU over gloo" in out
    assert "fsdp train rank 1 {'data': 0, 'model': 1}" in out
    assert "3 gathers and 3 reduce-scatters a step" in out
    assert "== launch.dryrun.residency" in out
    assert "restored bitwise onto the mesh and onto one device" in out
    assert "fsdp serve rank 1 {'data': 0, 'model': 1}" in out
    assert "(4x16, rows 2-3)" in out
    assert "(h2) one snapshot a request on all 2 ranks" in out
    assert "request 1 read the served version in all 5 calls" in out
    assert "(h3) 15 gathers a request" in out
    assert "every rank's KV cache (2, 2, 20, 4, 32)" in out
    assert "pod mesh {'pod': 2, 'data': 1, 'model': 2}" in out
    assert "4 ranks on the CPU over gloo" in out
    assert "pod train rank 3 {'pod': 1, 'data': 0, 'model': 1}" in out
    assert "pod train checks" in out and "(f1) step 1's loss" in out
    assert "2 rows a rank in 2 microbatches" in out
    assert "6 gathers and 6 reduce-scatters a step" in out    # 2 a period
    assert "to its pod replica's after each of 2 steps" in out
    assert not list(tmp_path.iterdir())         # the state removed


def test_fallback_serve_phase_on_cpu(smoke, capsys, monkeypatch, tmp_path):
    """The fallback serve step at the smoke size: Mixtral-8x22B's smoke
    config, one layer, all its experts, under its training placement on
    a mesh of (1, 2), two ranks over gloo on the CPU drawing their pieces
    and serving gathered; the rule checked on the published config; (s1)
    with the unsharded routing replayed, (s2); no kernel launches off
    the card."""
    import numpy as np

    for name, value in (("FALLBACK_SERVE", (2, 24, 4)),
                        ("FALLBACK_PUBLISH_AT", 2),
                        ("FALLBACK_DIR", tmp_path)):
        monkeypatch.setattr(smoke, name, value)
    launches = smoke.fallback_serve_phase(torch, np, device="cpu",
                                          mesh_shape=(1, 2))
    assert launches == {"flash_attention fallback": 0,
                        "decode_attention fallback": 0}
    out = capsys.readouterr().out
    assert "mixtral-8x22b-smoke 1 of 56 layers" in out
    assert "the fallback placement on mesh {'data': 1, 'model': 2}" in out
    assert "fallback serve rank 1 {'data': 0, 'model': 1}" in out
    assert "10 gathers a request" in out
    assert "(s1) every rank's request 1 logits vs the unsharded" in out
    assert "request 1 read v1 in all 5 calls" in out
    assert not list(tmp_path.iterdir())         # reference and routing


def test_plain_attention_swaps_the_layers_and_restores_them(smoke):
    from repro_torch.models import layers

    before = layers.attention_bshd, layers.decode_gqa
    with smoke.plain_attention():
        assert layers.attention_bshd is not before[0]
        assert layers.decode_gqa is not before[1]
    assert (layers.attention_bshd, layers.decode_gqa) == before


def test_visible_pairs_and_bound(smoke):
    import numpy as np

    assert smoke._visible_pairs(np, 1024, 1024, True, 0) == 1024 * 1025 // 2
    assert smoke._visible_pairs(np, 8, 8, False, 0) == 64
    # causal window 3 over 6 rows: 1 + 2 + 3 + 3 + 3 + 3
    assert smoke._visible_pairs(np, 6, 6, True, 3) == 15
    t, by = smoke._bound(67.1e6, 17.2e9, "bfloat16")
    assert by == "bytes" and abs(t - 67.1e6 / 3.35e12 * 1e3) < 1e-12
    assert smoke._bound(1e6, 1e12, "float32")[1] == "operations"


def test_chip_smoke_refuses_without_cuda(monkeypatch):
    """No card: exit code 2, nothing printed on stdout."""
    import subprocess

    code = ("import sys, torch; torch.cuda.is_available = lambda: False; "
            f"sys.argv = ['chip_smoke.py']; sys.path.insert(0, {str(ROOT)!r});"
            " import chip_smoke; sys.exit(chip_smoke.main())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 2 and out.stdout == ""


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    """Copied alone into an empty directory, the script exits 2 with
    nothing on stdout even where a card is present: it finds no
    src/repro_torch beside it and says so on stderr."""
    import shutil
    import subprocess

    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    code = ("import sys, torch; torch.cuda.is_available = lambda: True; "
            f"sys.argv = ['chip_smoke.py']; sys.path.insert(0, "
            f"{str(tmp_path)!r}); import chip_smoke; "
            "sys.exit(chip_smoke.main())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode == 2 and out.stdout == ""
    assert "no src/repro_torch" in out.stderr


def test_kernel_phase_script_refuses_without_cuda():
    """scripts/kernel_phase.py (the kernel phase of a tree, alone) needs
    a card: without one it exits 2 and prints nothing on stdout."""
    import subprocess

    code = ("import runpy, sys, torch; "
            "torch.cuda.is_available = lambda: False; "
            f"sys.argv = ['kernel_phase.py', {str(ROOT)!r}]; "
            f"runpy.run_path({str(ROOT / 'scripts' / 'kernel_phase.py')!r}, "
            "run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 2 and out.stdout == ""


def _run_witness(argv, prelude="", script="train_witness.py"):
    import subprocess

    path = str(ROOT / "scripts" / script)
    code = (f"import runpy, sys\n{prelude}"
            f"sys.argv = [{script!r}, *{argv!r}]\n"
            "try:\n"
            f"    runpy.run_path({path!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "print('jax loaded:', 'jax' in sys.modules)\n"
            "sys.exit(rc)\n")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)


def test_train_witness_rehearses_on_cpu():
    """scripts/train_witness.py at the smoke variant on the CPU: each of
    its five runs prints its losses (the kernels' run equals the plain
    attention's here, where both are plain; lr 0 starts where lr 3e-4
    does), no run launches a kernel, nothing imports jax, and it exits
    0."""
    out = _run_witness(["--device", "cpu", "--smoke", "--batch", "2",
                        "--seq", "16", "--steps", "2"])
    assert out.returncode == 0, out.stderr
    runs = {}
    for line in out.stdout.splitlines():
        if line.startswith("witness ") and ": losses " in line:
            head, rest = line.split(": losses ", 1)
            runs[head] = [float(x) for x in rest.split(";")[0].split(", ")]
            assert "flash_attention 0, flash_attention_bwd 0" in rest
    kern = "witness kernels lr 0.0003 moments bfloat16"
    assert len(runs) == 5 and all(len(v) == 2 for v in runs.values())
    assert runs[kern] == runs["witness plain lr 0.0003 moments bfloat16"]
    assert runs["witness kernels lr 0 moments bfloat16"][0] == runs[kern][0]
    assert "jax loaded: False" in out.stdout


def test_train_witness_refuses_without_cuda():
    """On its default device, "cuda", the witness needs a card: without
    one it exits 2 before printing a result."""
    out = _run_witness([], "import torch\n"
                       "torch.cuda.is_available = lambda: False\n")
    assert out.returncode == 2
    assert "witness" not in out.stdout


def test_tp_witness_rehearses_on_cpu():
    """scripts/tp_witness.py at the smoke variant on the CPU (mesh (1, 2)):
    the noise floor, then the sharded serve phase with its sums over
    "model" in bf16 and in f32, each with its checks held; two ranks sum
    two bf16 pieces with one rounding either way, so both (s1) readings
    are equal; nothing imports jax, and it exits 0."""
    out = _run_witness(["--device", "cpu", "--smoke"], script="tp_witness.py")
    assert out.returncode == 0, out.stderr
    assert "witness floor: qwen2-vl-72b-smoke 2 layers" in out.stdout
    s1 = [line.split("max |d| / max |logit| ")[1].split(" ")[0]
          for line in out.stdout.splitlines()
          if line.startswith("tp serve checks")]
    assert len(s1) == 2 and s1[0] == s1[1] and float(s1[0]) <= 3e-2
    assert "witness f32 psum:" in out.stdout and "failed" not in out.stdout
    assert "jax loaded: False" in out.stdout


def test_tp_witness_refuses_without_cuda():
    out = _run_witness([], "import torch\n"
                       "torch.cuda.is_available = lambda: False\n",
                       script="tp_witness.py")
    assert out.returncode == 2
    assert "witness" not in out.stdout


def test_record_scan_shapes_counts_the_ops_calls_by_shape(smoke):
    """A small driver run on the CPU under the recorder: every one of the
    four kernels is called through `ops`, each call counted by its shape;
    the ops layer gets its own names back afterwards."""
    from repro_torch.kernels.rss_scan_agg import kernel as K
    from repro_torch.kernels.rss_scan_agg import ops
    from repro_torch.mvcc import Scale, run_single_node

    names = ("rss_scan_agg", "rss_scan_agg_grouped", "rss_scan_agg_chunked",
             "rss_delta_fold")
    before = {n: getattr(ops, n) for n in names}
    with smoke.record_scan_shapes(K) as shapes:
        run_single_node(
            olap_mode="ssi+rss", oltp_clients=4, olap_clients=3, rounds=120,
            seed=7, olap_scan=True, paged_olap=True, check_scans=True,
            batch_plans=True, materialize=True, device="cpu",
            scale=Scale(warehouses=2, districts=20, customers=10, items=200,
                        order_capacity=10))
    assert {n for n, _ in shapes} == set(names)
    assert all(n > 0 for n in shapes.values())
    assert any(n == "rss_scan_agg" and "BP=8" in shape and "M=" in shape
               for n, shape in shapes)
    assert any(n == "rss_scan_agg_chunked" and "G=" in shape
               for n, shape in shapes)
    assert {n: getattr(ops, n) for n in names} == before


def test_rwkv_serve_phase_on_cpu(smoke, capsys):
    """RWKV6-3B's smoke variant (bf16) through the same serve phase: the
    writer under the pin, checks (a), (b) and (d) with the layers' WKV
    swapped for the plain version; no kernel launches off the card."""
    import numpy as np

    launches = smoke.serve_phase(torch, np, device="cpu", arch="rwkv6-3b")
    assert launches == {"wkv_scan": 0, "wkv_scan chunked": 0,
                        "wkv_scan step": 0}
    out = capsys.readouterr().out
    assert "serve request 2 (rwkv6-3b-smoke)" in out
    assert "serve checks: (a) rwkv6-3b-smoke" in out


def test_whisper_serve_phase_on_cpu(smoke, capsys, monkeypatch):
    """Whisper-tiny's smoke variant (bf16, its 64-frame encoder) through
    the serve phase at a tiny traffic (2 clips, a 4-token prompt, 6
    decode steps): the writer under the pin, (a) against the plain path,
    (b) against `forward` with the same frames, (d); no kernel launches
    off the card."""
    import numpy as np

    monkeypatch.setitem(smoke.SERVE_SHAPE, "whisper-tiny", (2, 4, 6))
    monkeypatch.setitem(smoke.SERVE_PROMPT, "whisper-tiny", (1, 2, 3, 4))
    launches = smoke.serve_phase(torch, np, device="cpu",
                                 arch="whisper-tiny")
    assert launches == {"flash_attention": 0, "decode_attention": 0}
    out = capsys.readouterr().out
    assert "serve request 2 (whisper-tiny-smoke)" in out
    assert "(2x4 tokens)" in out and "(2x6)" in out
    assert "serve checks: (a) whisper-tiny-smoke" in out


def test_qwen2_vl_serve_phase_on_cpu(smoke, capsys):
    """Qwen2-VL-72B's smoke variant (bf16, M-RoPE sections (4, 6, 6))
    through the serve phase: prompts that open with a vision stub of S//4
    rows on a grid, (a), (b) against `forward` over the same positions
    followed by the decode steps', (d); no kernel launches off the
    card."""
    import numpy as np

    launches = smoke.serve_phase(torch, np, device="cpu",
                                 arch="qwen2-vl-72b")
    assert launches == {"flash_attention": 0, "decode_attention": 0}
    out = capsys.readouterr().out
    assert "serve request 2 (qwen2-vl-72b-smoke)" in out
    assert "2 of 80 layers" in out
    assert "serve checks: (a) qwen2-vl-72b-smoke" in out
    assert "bf16 noise floor (plain prefill vs itself with its attention" \
        in out


def test_serve_batch_and_launches_of_the_stub_configs(smoke):
    """The batch a request of each stub config gets (frames as the
    pipeline makes them, rounded to the parameter dtype; the grid
    positions) and (c)'s launches per
    request: Whisper 12 flash in prefill and 8 decode attention a step,
    Qwen2-VL one of each a layer."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticPipeline

    cfg = get_config("whisper-tiny")
    assert smoke._serve_launches(cfg, "whisper-tiny", 124) == {
        "flash_attention": (12, 0), "decode_attention": (0, 8 * 124)}
    cut = get_config("qwen2-vl-72b").with_overrides(n_layers=32)
    assert smoke._serve_launches(cut, "qwen2-vl-72b", 64) == {
        "flash_attention": (32, 0), "decode_attention": (0, 32 * 64)}
    small = cfg.with_overrides(encoder_len=10, d_model=8, n_heads=2,
                               n_kv_heads=2, head_dim=4)
    b = smoke.serve_batch(torch, np, small, "whisper-tiny", 3, 4, "cpu")
    assert b["tokens"].tolist() == [list(smoke.SERVE_PROMPT[
        "whisper-tiny"])] * 3
    want = SyntheticPipeline(small, batch=3, seq_len=4, seed=0,
                             device="cpu").batch_at(0)["enc_embeds"]
    assert torch.equal(b["enc_embeds"], want.to(torch.bfloat16))
    pos = smoke.mrope_grid(torch, 2, 20, 16, "cpu")
    assert pos.shape == (3, 2, 20)
    assert pos[:, 0, 5].tolist() == [0, 1, 1]            # row 1, column 1
    assert pos[:, 1, 17].tolist() == [17, 17, 17]        # a text token
    whole = smoke._whole(torch, {"tokens": torch.zeros((2, 20), dtype=int),
                                 "mrope_positions": pos},
                         torch.ones((2, 3), dtype=int), 1)
    assert whole["tokens"].shape == (1, 23)
    assert whole["mrope_positions"][:, 0, 20:].tolist() == [[20, 21, 22]] * 3


def test_plain_wkv_swaps_the_layers_and_restores_them(smoke):
    from repro_torch.models import layers

    before = layers.wkv
    with smoke.plain_wkv():
        assert layers.wkv is smoke._wkv_plain
    assert layers.wkv is before


def test_wkv_plain_and_cost(smoke):
    """The chip script's plain WKV in the model's layout equals the op on
    CPU tensors (which takes the plain version), state written in place;
    the bound's bytes and operations at the serve prefill shape."""
    import numpy as np

    from repro_torch.kernels.wkv_scan.ops import wkv

    rng = np.random.default_rng(0)
    r, k, v, w_log = (torch.from_numpy(rng.standard_normal((2, 5, 3, 32))
                                       .astype(np.float32)) for _ in range(4))
    u = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
    state = torch.zeros((2, 3, 32, 32))
    o, S = smoke._wkv_plain(r, k, v, -w_log.exp(), u, state,
                            state_out=state)
    want_o, want_S = wkv(r, k, v, -w_log.exp(), u)
    assert S is state and torch.equal(o, want_o) and torch.equal(S, want_S)
    nbytes, flops = smoke._wkv_cost(8, 1024, 40, 64, 4, False)
    assert nbytes == 5 * 8 * 1024 * 40 * 64 * 4 + 40 * 64 * 4 \
        + 8 * 40 * 64 * 64 * 4
    assert abs(nbytes / 1e9 - 0.425) < 1e-3 and flops == 5 * 320 * 1024 * 4096
    t, by = smoke._bound(nbytes, flops, "float32")
    assert by == "bytes" and abs(t - 0.1268) < 1e-3
    t, by = smoke._bound(*smoke._wkv_cost(8, 1, 40, 64, 4, True), "float32")
    assert by == "bytes" and abs(t - 0.0033) < 2e-4


def test_jamba_serve_phase_on_cpu(smoke, capsys, monkeypatch):
    """Jamba-1.5-Large's smoke variant, cut as on the card (bf16, one
    period of 8 layers, holding experts 0-1 of 4 in each MoE layer),
    through the serve phase: the writer under
    the pin, check (a) with request 1's routing replayed, the drop-free
    (b), the per-launch SSM check, noise floor and f32 Mamba block, (d);
    no kernel launches off the card.  The smoke variant's 128-wide bf16
    layers put prefill + decode and the forward 3e-2 to 5e-2 of the
    logits' max-abs apart in the reference itself (ROADMAP §3), so
    the rehearsal prints the bf16 ratios unbounded; the card holds them
    at 3e-2."""
    import numpy as np

    monkeypatch.setitem(smoke.SERVE_BF16_TOL, "jamba-1.5-large-398b", None)
    launches = smoke.serve_phase(torch, np, device="cpu",
                                 arch="jamba-1.5-large-398b")
    assert launches == {"ssm_scan": 0, "flash_attention": 0,
                        "decode_attention": 0, "ssm_scan chunked": 0,
                        "ssm_scan step": 0}
    out = capsys.readouterr().out
    assert "experts 0-1 of 4 in each MoE layer" in out
    assert "serve checks: (a) jamba-1.5-large-398b-smoke" in out
    assert "f32 Mamba block kernel vs plain" in out
    assert "MoE routing replayed" in out


def test_plain_ssm_swaps_the_layers_and_restores_them(smoke):
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    from repro_torch.models import layers

    before = layers.selective_scan
    with smoke.plain_ssm():
        assert layers.selective_scan is ssm_scan_ref
    assert layers.selective_scan is before


def test_routing_is_recorded_and_replayed(smoke):
    """A MoE layer's routing recorded on one input replays onto another:
    the replayed call takes the recorded experts (with its own gate
    values and slots), counts where its own top-k differed, and the
    layer's output then equals the recorded input's routing applied to
    the new input; both wrappers restore `moe_route`."""
    import numpy as np

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import init_params, layers

    cfg = smoke_variant(get_config("mixtral-8x7b")).with_overrides(
        param_dtype="float32", compute_dtype="float32")
    p = {k: v[0] for k, v in init_params(
        cfg, torch.Generator().manual_seed(0), "cpu")["blocks"][0]
        ["mlp"].items()}
    rng = np.random.default_rng(0)
    x1, x2 = (torch.from_numpy(rng.standard_normal((2, 9, cfg.d_model))
                               .astype(np.float32)) for _ in range(2))
    route = layers.moe_route
    with smoke.record_routing() as calls:
        y1 = layers.moe_apply(p, x1, cfg)
    assert layers.moe_route is route and len(calls) == 1
    own = route(p, x2, cfg)[1]
    with smoke.replay_routing(torch, calls) as st:
        y2 = layers.moe_apply(p, x2, cfg)
    assert layers.moe_route is route
    assert st["differ"] == int((own != calls[0]).sum()) > 0
    assert not torch.equal(y2, layers.moe_apply(p, x2, cfg))
    with smoke.replay_routing(torch, calls):
        assert torch.equal(layers.moe_apply(p, x1, cfg), y1)
    with pytest.raises(AssertionError, match="replayed 0 of 1"):
        with smoke.replay_routing(torch, calls):
            pass


def test_ssm_cost_and_bound(smoke):
    """The bound's bytes and operations at Jamba's prefill and decode
    shapes (PERF.md row 10)."""
    nbytes, flops = smoke._ssm_cost(8, 1024, 16384, 16, 4, False)
    assert nbytes == 8 * 1024 * 16384 * 12 + 2 * 8 * 1024 * 16 * 4 \
        + 16384 * 16 * 4 + 16384 * 4 + 8 * 16384 * 16 * 4
    assert abs(nbytes / 1e9 - 1.622) < 1e-3
    assert flops == 8 * 8 * 1024 * 16384 * 16 + 3 * 8 * 1024 * 16384
    t, by = smoke._bound(nbytes, flops, "float32")
    assert by == "bytes" and abs(t - 0.4842) < 1e-3
    t, by = smoke._bound(*smoke._ssm_cost(8, 1, 16384, 16, 4, True),
                         "float32")
    assert by == "bytes" and abs(t - 0.0058) < 2e-4


def test_tp_ssm_shape_cost_and_bound(smoke):
    """The `ssm_scan` rows at one rank's shape of the sharded serve
    phase's Jamba (TP_SSM_ROWS): 8 x 1,024 (then 1) x 4,096 of 16,384
    channels at model 4, N 16, bf16 u; the bound's bytes and operations
    (PERF.md row 10d)."""
    assert smoke.tp_ssm_shape(smoke.TP_S) == (8, 1024, 4096, 16)
    assert smoke.tp_ssm_shape(1) == (8, 1, 4096, 16)
    nbytes, flops = smoke._ssm_cost(8, 1024, 4096, 16, 2, False)
    assert nbytes == 8 * 1024 * 4096 * 10 + 2 * 8 * 1024 * 16 * 4 \
        + 4096 * 16 * 4 + 4096 * 4 + 8 * 4096 * 16 * 4
    assert flops == 8 * 8 * 1024 * 4096 * 16 + 3 * 8 * 1024 * 4096
    t, by = smoke._bound(nbytes, flops, "float32")
    assert by == "bytes" and abs(t - 0.10116) < 1e-4
    t, by = smoke._bound(*smoke._ssm_cost(8, 1, 4096, 16, 2, True),
                         "float32")
    assert by == "bytes" and abs(t - 0.001434) < 1e-5
    assert [row for _, row in smoke.TP_SSM_ROWS.values()] == [
        "ssm_scan tp4", "ssm_scan step tp4"]


def test_n_layers_counts_by_kind(smoke):
    from repro_torch.configs import get_config

    cfg = get_config("jamba-1.5-large-398b").with_overrides(n_layers=8)
    assert smoke._n_layers(cfg, mixer="mamba") == 7
    assert smoke._n_layers(cfg, mixer="attn") == 1
    assert smoke._n_layers(cfg, mlp="moe") == 4
    assert smoke._n_layers(get_config("jamba-1.5-large-398b"),
                           mlp="moe") == 36


def test_ptxas_report_names_each_kernel(smoke, monkeypatch):
    """nvcc's -Xptxas -v output becomes one line per kernel: its name
    (mangled when no c++filt is found), registers and spills; an error
    line is kept."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z6k_stepv' for "
        "'sm_90a'",
        "ptxas info    : Function properties for _Z6k_stepv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers, 4100 bytes smem",
        "ptxas error   : Entry function uses too much shared data"])
    monkeypatch.setattr(smoke.shutil, "which", lambda name: None)
    assert smoke._ptxas_report(log) == [
        "_Z6k_stepv: Used 40 registers, used 1 barriers, 4100 bytes smem; "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas error   : Entry function uses too much shared data"]


def test_grouped_and_fold_on_cpu(smoke, monkeypatch, capsys):
    """`grouped_and_fold` at small shapes on the CPU (clock and profiler
    stubbed): every shape held against plain, a store of its own built
    for a P over the given one, one line a shape, the times of the two
    table shapes returned."""
    monkeypatch.setattr(smoke, "time_ms", lambda *a, **k: 0.0)
    monkeypatch.setattr(smoke, "_device_ops", lambda torch, fn: 1)
    monkeypatch.setattr(smoke, "GROUPED_SHAPES",
                        ((64, 3, 0, 8), (63, 40, 5, 3), (96, 2, 0, 8)))
    monkeypatch.setattr(smoke, "FOLD_SHAPES",
                        ((64, 256), (8, 4104), (8304, 8)))
    rng = np.random.default_rng(0)
    data_np, ts_np = smoke.make_store(np, 64, 4, 6, rng)
    members = {m: torch.from_numpy(np.sort(rng.choice(
        np.arange(6_001, 12_000), m, replace=False)).astype(np.int32))
        for m in (0, 5)}
    checked = []

    def check(name, got, want):
        assert torch.equal(got, want)
        checked.append(name)

    from repro_torch.kernels.rss_scan_agg import kernel as K

    times = smoke.grouped_and_fold(
        torch, np, K, None, check, torch.from_numpy(data_np),
        torch.from_numpy(ts_np), members, 6_000)
    out = capsys.readouterr().out
    # every BP here takes both routes; Lp 8,304 is over a block's tile:
    # sliced only
    assert checked.count("rss_scan_agg_grouped") == 2 + 2 + 2
    assert checked.count("rss_delta_fold") == 2 + 2 + 1
    assert out.count("kernel rss_scan_agg_grouped ") == 6
    assert "sector_only_ms=0.0" in out and "fill_only_ms=0.0" in out
    assert list(times) == ["rss_delta_fold"]     # Lp 64, Dp 256
    assert times["rss_delta_fold"][:2] == (0.0, 0.0)


K1, K2, MARK = "fold_kernel", "fill_kernel", "at::cuda::spin_kernel(long)"


@pytest.mark.parametrize("traces, ops, lost", [
    ([[K1, MARK]] * 3, 1, 0),
    ([[], [], [K1, MARK], [K1, MARK], [K1, MARK]], 1, 2),
    ([[K1, MARK], [MARK], [K1, MARK]], 1, 0),      # one event dropped
    ([[K1, K2, MARK], [K1, MARK], [], [K1, MARK]], 2, 1),
    ([[MARK]] * 3, 0, 0),                          # no operation: read 0
    ([[]] * 12, None, 12),                         # the profiler lost all
])
def test_device_ops_retakes_traces_that_lost_the_marker(
        smoke, monkeypatch, capsys, traces, ops, lost):
    """`_device_ops` (profiler stubbed with the given device events a
    trace): the marker is not counted, a trace without it is taken again
    up to 12 in all, the most of three kept traces is returned, and none
    kept raises."""
    from torch.autograd import DeviceType

    feed = iter(traces)

    class Event:
        def __init__(self, name):
            self.name, self.device_type = name, DeviceType.CUDA

    class Profile:
        def __init__(self, activities):
            self.names = next(feed)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return [Event(n) for n in self.names]

    class Cuda:
        synchronize = staticmethod(lambda: None)
        _sleep = staticmethod(lambda cycles: None)

    calls = []
    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(smoke.time, "sleep", lambda s: None)
    fake = type("FakeTorch", (), {"cuda": Cuda})
    if ops is None:
        with pytest.raises(RuntimeError, match="no marker in 12 traces"):
            smoke._device_ops(fake, lambda: calls.append(1))
    else:
        assert smoke._device_ops(fake, lambda: calls.append(1)) == ops
    assert len(calls) == len(traces)
    out = capsys.readouterr().out
    assert (f"{lost} of {len(traces)} traces lost" in out) == bool(lost)


def test_attention_bwd_phase_on_cpu(smoke, capsys, monkeypatch):
    """The flash-backward phase's checks at small shapes (every mask and
    head layout of the card's cases, and Whisper's non-causal encoder
    and S != T cross-attention, each a row of its own), the plain
    version standing in."""
    monkeypatch.setattr(smoke, "BWD_CASES", [
        ("train", "bfloat16", 2, 40, 40, 4, 4, 64, True, 0, True),
        ("gqa+window", "bfloat16", 1, 50, 50, 8, 2, 128, True, 8, True),
        ("mqa", "bfloat16", 1, 30, 30, 6, 1, 128, True, 0, True),
        ("ragged", "float32", 1, 37, 37, 4, 2, 32, False, 0, False),
        ("whisper encoder", "bfloat16", 2, 70, 70, 6, 6, 64, False, 0,
         True),
        ("whisper cross", "bfloat16", 2, 9, 70, 6, 6, 64, False, 0, True)])
    out_rows = smoke.attention_bwd_phase(torch, np, None, device="cpu")
    rows = [row for row, _ in smoke.BWD_ROWS.values()]
    assert sorted(out_rows) == sorted(["flash_attention_bwd", *rows])
    res = out_rows["flash_attention_bwd"]
    assert res["max_abs_err"] == 0.0 and "times" not in res
    assert all(out_rows[r] == {"max_abs_err": 0.0} for r in rows)
    out = capsys.readouterr().out
    assert out.count("two launches bitwise equal") == 6


def test_train_phase_on_cpu(smoke, capsys, monkeypatch, tmp_path):
    """Qwen1.5-0.5B's smoke variant through the train phase: (a) the step
    against the plain path in f32 and bf16, (b) training while a reader
    pinned at v1 keeps it and requests are served between steps, (c) no
    kernel launches off the card, (d) crash and restore at the depth
    cut."""
    monkeypatch.setattr(smoke, "TRAIN_CKPT", tmp_path / "ckpt")
    launches = smoke.train_phase(torch, np, device="cpu")
    assert launches == {"flash_attention": 0, "flash_attention_bwd": 0}
    out = capsys.readouterr().out
    for part in ("train (a) qwen1.5-0.5b: f32 loss",
                 "train (b) qwen1.5-0.5b: ", "3 steps of 2x16",
                 "reads v1 bitwise", "train (c) qwen1.5-0.5b",
                 "train (d): 1 of 2 layers", "(3 saves"):
        assert part in out, part
    assert not (tmp_path / "ckpt").exists()


def test_count_plain_attention_counts_and_restores(smoke):
    """`count_plain` counts the plain attention and the plain scans (a
    CPU call of each wrapper reaches one) and puts every name back."""
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan import ref as SR
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.kernels.wkv_scan import ref as WR
    from repro_torch.models import layers

    names = lambda: (layers.flash_attention_chunked, FO.attention_bwd_ref,
                     WR.wkv_scan_plain, WR.wkv_scan_bwd_ref,
                     SR.ssm_scan_ref, SR.ssm_scan_bwd_ref)
    before = names()
    with smoke.count_plain() as plain:
        q = torch.zeros(1, 4, 2, 32)
        layers.flash_attention(q, q, q, causal=True)
        x = torch.zeros(1, 1, 3, 32)
        WK.wkv_scan(x, x, x, x, x[:, :, 0])
        y = torch.zeros(1, 3, 4)
        SK.ssm_scan(y, y, torch.zeros(1, 3, 8), torch.zeros(1, 3, 8),
                    torch.zeros(4, 8), torch.zeros(4))
    assert plain["calls"] == 3
    assert names() == before


def test_plain_train_scans_and_checked_bwd_swap_and_restore(smoke):
    """`plain_train_scans` swaps the scan wrappers the ops call for the
    plain versions, `checked_scan_bwd` wraps the two backwards with the
    per-launch check; both put the wrappers back."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.kernels.wkv_scan import ref as WR

    before = (WK.wkv_scan, WK.wkv_scan_bwd, SK.ssm_scan, SK.ssm_scan_bwd)
    with smoke.plain_train_scans():
        assert WK.wkv_scan is WR.wkv_scan_plain
        assert WK.wkv_scan_bwd is WR.wkv_scan_bwd_ref
    assert (WK.wkv_scan, WK.wkv_scan_bwd, SK.ssm_scan,
            SK.ssm_scan_bwd) == before
    r = torch.randn(1, 2, 5, 32)
    u = torch.randn(1, 2, 32)
    with smoke.checked_scan_bwd() as seen:
        WK.wkv_scan_bwd(r, r, r, -r.exp(), u, r)
    assert seen["launches"] == 1 and seen["worst"] < 1e-5   # f32 vs f64
    assert (WK.wkv_scan, WK.wkv_scan_bwd, SK.ssm_scan,
            SK.ssm_scan_bwd) == before


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-72b"])
def test_stub_train_phase_on_cpu(smoke, capsys, monkeypatch, arch):
    """Whisper-tiny's smoke variant (its 64-frame encoder, f32 frames
    from the pipeline that the step rounds to bf16) and Qwen2-VL's cut to
    one layer (its vision stub and M-RoPE positions) through the train
    phase: (a) against the plain path in f32 and bf16, (b) training
    while a reader pinned at v1 keeps it and a request with the
    architecture's frontend inputs is served between steps, (c) no
    kernel launches off the card."""
    monkeypatch.setattr(smoke, "TRAIN_SEQ", {})
    monkeypatch.setattr(smoke, "TRAIN_BATCH", {})
    monkeypatch.setitem(smoke.SERVE_PROMPT, "whisper-tiny", (1, 2, 3, 4))
    launches = smoke.train_phase(torch, np, device="cpu", arch=arch)
    assert launches == {"flash_attention": 0, "flash_attention_bwd": 0}
    out = capsys.readouterr().out
    layers = 1 if arch == "qwen2-vl-72b" else 2
    for part in (f"train (a) {arch}: f32 loss",
                 f"train (b) {arch}: {layers} layers", "3 steps of 2x16",
                 "reads v1 bitwise", f"train (c) {arch}"):
        assert part in out, part
    assert "train (d)" not in out


def test_launch_phase_on_cpu(smoke, capsys, monkeypatch, tmp_path):
    """The launch phase on the smoke variant: both launchers' `main` run
    in the process, their lines checked; nothing launches off the
    card and the checkpoints are removed."""
    monkeypatch.setattr(smoke, "LAUNCH_CKPT", tmp_path / "ckpt")
    monkeypatch.setattr(smoke, "LAUNCH_TRAIN", [
        "--arch", "whisper-tiny", "--smoke", "--steps", "3", "--batch", "2",
        "--seq", "16", "--ckpt-dir", str(tmp_path / "ckpt"),
        "--ckpt-every", "2", "--publish"])
    monkeypatch.setattr(smoke, "LAUNCH_SERVE", [*smoke.LAUNCH_SERVE,
                                                "--smoke"])
    launches = smoke.launch_phase(torch, device="cpu")
    assert launches == {"flash_attention": 0, "decode_attention": 0,
                        "flash_attention_bwd": 0}
    out = capsys.readouterr().out
    assert "launch train: published versions: 4" in out
    assert "launch serve: arch=whisper-tiny-smoke generated (2, 8)" in out
    assert "checkpoint at step 2" in out
    assert not (tmp_path / "ckpt").exists()


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-1.5-large-398b"])
def test_scan_train_phase_on_cpu(smoke, capsys, arch):
    """RWKV6's smoke variant and Jamba's Mamba-layer cut of its smoke
    variant through the train phase: (a) against the plain path in f32
    and bf16 and per backward launch, (b) training while a reader pinned
    at v1 keeps it and requests are served between steps, (c) no kernel
    launches off the card."""
    launches = smoke.train_phase(torch, np, device="cpu", arch=arch)
    name = "wkv_scan" if arch == "rwkv6-3b" else "ssm_scan"
    assert launches == {f"{name} chunked": 0, f"{name} bwd": 0}
    out = capsys.readouterr().out
    for part in (f"train (a) {arch}: f32 loss", f"train (b) {arch}: ",
                 "reads v1 bitwise", f"train (c) {arch}",
                 f"{name}_bwd launches of a full-depth bf16 step"):
        assert part in out, part
    assert "train (d)" not in out
    if arch != "rwkv6-3b":
        assert "train (b) jamba-1.5-large-398b: 2 layers" in out
