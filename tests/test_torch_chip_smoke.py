"""`chip_smoke.py`'s snapshot-read and serve phases rehearsed on the CPU
at a tiny size (the plain versions stand in for the kernels), so the
script's own logic — traffic with writers left in flight, the
whole-mirror read held against `scan_members`, `scan_at` and the engine,
the param-store oracle, the serve phase's writer under a pinned request
and its checks (a), (b) and (d) — is checked here before it runs on the
card at full size."""

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
    monkeypatch.setattr(chip_smoke, "SERVE_SMOKE", True)
    for name, value in (("SERVE_B", 2), ("SERVE_S", 24), ("SERVE_STEPS", 6),
                        ("SERVE_PUBLISH_AT", 2)):
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
