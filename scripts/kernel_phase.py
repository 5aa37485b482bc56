#!/usr/bin/env python3
"""Run only the kernel phase of a tree's `chip_smoke.py` on one GPU.

    python3 scripts/kernel_phase.py [TREE]     # TREE: a checkout (default .)
    python3 scripts/kernel_phase.py TREE --groups G
    python3 scripts/kernel_phase.py TREE --shapes
    python3 scripts/kernel_phase.py TREE --attention
    python3 scripts/kernel_phase.py TREE --scans
    python3 scripts/kernel_phase.py TREE --backwards

Builds the tree's `rss_scan_agg.cu` and `gather.cu` (into the tree's own
`build/repro_torch/`), prints their ptxas lines, then runs the tree's
`chip_smoke.kernel_phase` (the `rss_scan_agg` family and the gathers held
against their plain versions and timed) and prints its results.  Pointed
at an unpacked earlier commit, it times that commit's kernels in the same
call as this one's, which is how two versions are compared on one card.

With `--groups G` it runs only this checkout's `chip_smoke.chunked_groups`
on the tree's `rss_scan_agg_chunked`: the kernel phase's store (P 400,000,
K 8, E 32, M 64) at G groups, group ids over 48 groups and spread over all
G, each held against plain and timed.  So an earlier tree's kernel is
timed at a G its own kernel phase does not time (the one over the
cluster route's cap that `chip_smoke.py` prints, for one).

With `--shapes` it runs only this checkout's `chip_smoke.grouped_and_fold`
on the tree's `rss_scan_agg_grouped` and `rss_delta_fold`: the grouped
scan at every shape of `chip_smoke.GROUPED_SHAPES` (the kernel phase's
store at each G and M, and the driver phase's largest shapes) and the
delta fold at `chip_smoke.FOLD_SHAPES`, each held against plain and
timed, on every route where the tree's wrappers plan routes.

With `--attention` it builds the tree's `attention.cu` and runs the
tree's own `chip_smoke.attention_kernel_phase` (flash and decode attention
at the serve shapes, held against plain and timed beside SDPA): run on
an earlier tree and on this one in turns, it shows whether a change to
the attention source moved the forward kernels' times.

With `--scans` it builds the tree's `wkv.cu` and `ssm.cu`, prints their
ptxas lines, and runs the tree's own `chip_smoke.wkv_kernel_phase` and
`chip_smoke.ssm_kernel_phase` (the serving forwards of `wkv_scan` and
`ssm_scan` at the prefill and decode shapes, held against plain and
timed): run on an earlier tree and on this one in turns, it shows
whether a change to the scan sources moved the serving kernels' times.

With `--backwards` it builds the tree's `attention.cu`, `wkv.cu` and
`ssm.cu`, prints their ptxas lines, and runs the tree's own
`chip_smoke.attention_bwd_phase` (`flash_attention_bwd` at every case of
its `BWD_CASES`, held against `attention_bwd_ref`, two launches bitwise
equal, the timed cases timed beside plain, the bound and SDPA's
backward) and this checkout's `chip_smoke.scan_bwd_phase` on the tree's
`wkv_scan_bwd` and `ssm_scan_bwd` (RWKV6-3B's train shape at two decay
scales; Jamba's train microbatch, bf16 u, 1 x 1,024 x 16,384 x 16; each
held against its plain backward, two launches bitwise equal, timed
beside plain and the bound, the SSM backward's device time split by
kernel from a profiler trace): run on an earlier tree and on this one in
turns, it times the three backward kernels of each in one call.  It also
prints each `ssm_bwd_kernel` instantiation's instruction count and mix
from `cuobjdump -sass` of the built library, where the toolkit has it.
"""

import collections
import importlib.util
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _here():
    """This checkout's chip_smoke.py, whatever tree is on sys.path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", HERE / "chip_smoke.py")
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    return here


def _check(torch):
    def check(name, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel != plain")
    return check


def groups_phase(torch, np, tree: Path, g: int) -> None:
    """This checkout's `chunked_groups` on the tree's wrapper at G = g."""
    here = _here()
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.rss_scan_agg import kernel as K_mod

    print(f"tree {tree}, G={g}: {here.card_line()}", flush=True)
    cuda_build.build(["rss_scan_agg"])
    rng = np.random.default_rng(0)
    data_np, ts_np = here.make_store(np, 400_000, 8, 32, rng)
    dev = torch.device("cuda")
    data, ts = (torch.from_numpy(data_np).to(dev),
                torch.from_numpy(ts_np).to(dev))
    floor = 6_000
    mem = torch.from_numpy(np.sort(rng.choice(
        np.arange(floor + 1, 12_000, dtype=np.int32), 64,
        replace=False))).to(dev)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    here.chunked_groups(torch, np, K_mod, flush, data, ts, mem, floor, g,
                        _check(torch))


def shapes_phase(torch, np, tree: Path) -> None:
    """This checkout's `grouped_and_fold` on the tree's wrappers."""
    here = _here()
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.rss_scan_agg import kernel as K_mod

    print(f"tree {tree}, shapes: {here.card_line()}", flush=True)
    cuda_build.build(["rss_scan_agg"])
    for line in here._ptxas_report(cuda_build.BUILD_LOGS.get(
            "rss_scan_agg", "")):
        print(f"ptxas rss_scan_agg: {line}", flush=True)
    data, ts, members, floor, _rng = here.scan_store(torch, np)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    for name, t in here.grouped_and_fold(torch, np, K_mod, flush,
                                         _check(torch), data, ts, members,
                                         floor).items():
        print(f"result {name}: {t}", flush=True)


def attention_phase(torch, np, tree: Path) -> None:
    """The tree's `chip_smoke.attention_kernel_phase`."""
    import chip_smoke
    from repro_torch.kernels import cuda_build

    print(f"tree {tree}, attention: {chip_smoke.card_line()}", flush=True)
    cuda_build.build(["attention"])
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    for name, res in chip_smoke.attention_kernel_phase(torch, np,
                                                       flush).items():
        print(f"result {name}: {res}", flush=True)


def scans_phase(torch, np, tree: Path) -> None:
    """The tree's `chip_smoke.wkv_kernel_phase` and `ssm_kernel_phase`."""
    import chip_smoke
    from repro_torch.kernels import cuda_build

    print(f"tree {tree}, scans: {chip_smoke.card_line()}", flush=True)
    cuda_build.build(["wkv", "ssm"])
    for name, log in cuda_build.BUILD_LOGS.items():
        for line in chip_smoke._ptxas_report(log):
            print(f"ptxas {name}: {line}", flush=True)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    for name, phase in (("wkv_scan", chip_smoke.wkv_kernel_phase),
                        ("ssm_scan", chip_smoke.ssm_kernel_phase)):
        print(f"result {name}: {phase(torch, np, flush)}", flush=True)


def sass_mix(lib: Path, kernel: str) -> None:
    """Each function of `lib` whose name holds `kernel`: its instruction
    count (static: a chunk loop's body counts once) and its most common
    opcodes, from `cuobjdump -sass`."""
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                "bin/cuobjdump")
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if tool is None:
        print("sass: no cuobjdump", flush=True)
        return
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True).stdout
    for block in out.split("Function : ")[1:]:
        name = block.splitlines()[0].strip()
        if kernel not in name:
            continue
        ops = collections.Counter(
            m.group(1).split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                block))
        fp = sum(ops[o] for o in ("FMUL", "FFMA", "FADD", "MUFU"))
        print(f"sass {name}: {sum(ops.values())} instructions, {fp} "
              "floating point (FMUL, FFMA, FADD, MUFU); "
              + " ".join(f"{o}:{n}" for o, n in ops.most_common(16)),
              flush=True)


def backwards_phase(torch, np, tree: Path) -> None:
    """The tree's `chip_smoke.attention_bwd_phase`, then this checkout's
    `scan_bwd_phase` on the tree's scan backwards."""
    import chip_smoke
    from repro_torch.kernels import cuda_build

    print(f"tree {tree}, backwards: {chip_smoke.card_line()}", flush=True)
    cuda_build.build(["attention", "wkv", "ssm"])
    for name, log in cuda_build.BUILD_LOGS.items():
        for line in chip_smoke._ptxas_report(log):
            print(f"ptxas {name}: {line}", flush=True)
    sass_mix(cuda_build.library_path("ssm"), "ssm_bwd_kernel")
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    res = chip_smoke.attention_bwd_phase(torch, np, flush)
    print(f"result flash_attention_bwd: {res}", flush=True)
    for name, res in _here().scan_bwd_phase(torch, np, flush).items():
        print(f"result {name}: {res}", flush=True)


def main() -> int:
    args = sys.argv[1:]
    groups = None
    if "--groups" in args:
        i = args.index("--groups")
        groups = int(args[i + 1])
        del args[i:i + 2]
    shapes = "--shapes" in args
    if shapes:
        args.remove("--shapes")
    attention = "--attention" in args
    if attention:
        args.remove("--attention")
    scans = "--scans" in args
    if scans:
        args.remove("--scans")
    backwards = "--backwards" in args
    if backwards:
        args.remove("--backwards")
    tree = Path(args[0] if args else ".").resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_phase: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if groups is not None:
        groups_phase(torch, np, tree, groups)
        return 0
    if shapes:
        shapes_phase(torch, np, tree)
        return 0
    if attention:
        attention_phase(torch, np, tree)
        return 0
    if scans:
        scans_phase(torch, np, tree)
        return 0
    if backwards:
        backwards_phase(torch, np, tree)
        return 0
    import chip_smoke
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.rss_scan_agg import kernel as K_mod

    print(f"tree {tree}: {chip_smoke.card_line()}", flush=True)
    cuda_build.build(["rss_scan_agg", "gather"])
    for name, log in cuda_build.BUILD_LOGS.items():
        for line in chip_smoke._ptxas_report(log):
            print(f"ptxas {name}: {line}", flush=True)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    t0 = time.perf_counter()
    results = chip_smoke.kernel_phase(torch, np, K_mod, flush)
    print(f"kernel phase: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, res in results.items():
        print(f"result {name}: {res}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
