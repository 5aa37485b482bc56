"""Build, load and launch helpers shared by the port's CUDA wrappers.

Every source `src/repro_torch/csrc/<name>.cu` has a plain C interface and
is compiled by nvcc for sm_90a into its own shared library under
`build/repro_torch/`, named by the hash of the source (an edit rebuilds),
then loaded with ctypes.  `build()` starts one nvcc per missing library,
all at once, and waits for them together.  Nothing is compiled when a
module is imported: the first launch (or an explicit `build()`) does it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Iterable, NamedTuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("rss_scan_agg", "gather", "attention", "wkv", "ssm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

BUILD_LOGS: dict[str, str] = {}   # nvcc's output per source built here
_LIBS: dict[str, ctypes.CDLL] = {}

_I32_MAX = 2 ** 31 - 1
_I32_MIN = -2 ** 31


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built from source at first use")
    return found


def library_path(name: str) -> Path:
    """Where the library of `csrc/<name>.cu` lives (source hash in the
    name)."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> dict[str, Path]:
    """Compile every named source whose library is missing — one nvcc
    process each, all started together — and return name -> library
    path.  Raises with nvcc's output when any build fails."""
    libs = {n: library_path(n) for n in names}
    procs = {}
    for n, lib in libs.items():
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
        procs[n] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        BUILD_LOGS[n] = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"nvcc failed on {n}.cu ({proc.returncode}):\n"
                          f"{BUILD_LOGS[n]}")
        else:
            os.replace(tmp, libs[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu` (built at first use);
    `bind` sets its functions' argtypes/restype once."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        bind(lib)
        _LIBS[name] = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaGetLastError() returned by a C entry."""
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def on_cuda(t: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (plain version); anything else raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def tensor_arg(t: torch.Tensor, name: str, dev: torch.device, ndim: int,
               dtype: torch.dtype | None = torch.int32) -> int:
    """The data pointer of a kernel input after checking its device,
    dtype (None: any), rank and contiguity; raises on what the kernels do
    not take."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def i32(v, name: str) -> int:
    """A scalar argument as a Python int that fits int32 (raises if not)."""
    v = int(v)
    if not _I32_MIN <= v <= _I32_MAX:
        raise OverflowError(f"{name}={v} does not fit int32")
    return v


class Launch(NamedTuple):
    """A wrapper's launch: the route (which kernel), its grid (blocks per
    axis) and block (threads), and whether its operands move as 16-byte
    vectors (cp.async pieces, float4) or element by element."""
    route: str
    grid: tuple[int, ...]
    block: int
    vector: bool


def on_16b(t: torch.Tensor, dims: Iterable[int]) -> bool:
    """True when `t` starts on 16 bytes and its strides over `dims` are
    multiples of 16 bytes: each row along its last dim can then move in
    16-byte pieces."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        t.stride(d) * size % 16 == 0 for d in dims)


def stream() -> int:
    """PyTorch's current CUDA stream, as the pointer the C entries take."""
    return torch.cuda.current_stream().cuda_stream


def launch_count(fn) -> int:
    """A wrapper's kernel launches: its `launches` count or, for a
    wrapper with a kernel per route, the sum of its `route_launches`."""
    by_route = getattr(fn, "route_launches", None)
    return fn.launches if by_route is None else sum(by_route.values())


def reset_counts(kernels) -> dict:
    """Zero each wrapper's count (`launches`, or `route_launches` where
    it counts by route); returns the launches before."""
    before = {fn.__name__: launch_count(fn) for fn in kernels}
    for fn in kernels:
        if hasattr(fn, "route_launches"):
            for route in fn.route_launches:
                fn.route_launches[route] = 0
        else:
            fn.launches = 0
    return before
