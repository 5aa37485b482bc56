"""CUDA kernel for Hopper: the RWKV6 WKV recurrence.

`wkv_scan` binds `wkv_forward` of `src/repro_torch/csrc/wkv.cu` (built
with nvcc for sm_90a into `build/repro_torch/` at first use, loaded with
ctypes; the source's header states the design and its bound on the
card).  It replaces the Pallas TPU kernel
`repro.kernels.wkv_scan.kernel.wkv_scan` and keeps its contract, with an
initial state added:

    r/k/v/w_log [B, H, T, N], u [B, H, N], s0 [B, H, N, N] or None
        ->  o [B, H, T, N] f32, S [B, H, N, N] f32

(the reference flattens B x H into one axis; here the two stay apart so
that the model's [B, T, H, N] tensors pass as transposed views).  r, k,
v and w_log share one dtype of f32 / bf16 / f16 and are widened to f32,
as the Pallas kernel casts them; u is taken in f32.  N in {32, 64}; any
T >= 1 (the Pallas kernel asserts T % chunk == 0).  Every operand is
read through its strides (the last dim must be contiguous), so u may be
a stride-0 batch view of [H, N]; o is allocated in [B, T, H, N] memory
order, so `ops.wkv` hands it back in the model's layout without a copy.
The final state goes to `state_out` when given (f32 [B, H, N, N], any
strides with a contiguous last dim), which may be `s0` itself: the
kernel reads each state column before it writes it, so a decode step
updates the layer's state in place.

Device choice: CUDA tensors launch the kernel (or raise); CPU tensors
take the plain version, `ref.wkv_scan_plain` (`wkv_scan_ref` at this
contract).  `wkv_scan.launches` counts
real kernel launches only.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..cuda_build import check, i32, load, on_cuda, reset_counts, stream
from ..flash_attention.kernel import DTYPE_CODES, strides

HEAD_SIZES = (32, 64)


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv_forward.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.wkv_forward.restype = ctypes.c_int


def wkv_lib():
    return load("wkv", _bind)


def _check(r, k, v, w_log, u, s0, state_out) -> tuple[int, int, int, int]:
    """Validate the operands of a launch; returns (B, H, T, N)."""
    if r.dim() != 4:
        raise ValueError(f"r must be [B, H, T, N], got {tuple(r.shape)}")
    B, H, T, N = r.shape
    for name, t in (("k", k), ("v", v), ("w_log", w_log)):
        if tuple(t.shape) != (B, H, T, N):
            raise ValueError(f"{name} {tuple(t.shape)} != r {(B, H, T, N)}")
        if t.dtype != r.dtype:
            raise TypeError(f"{name} is {t.dtype}, r is {r.dtype}")
    if r.dtype not in DTYPE_CODES:
        raise TypeError(f"dtype {r.dtype} not in {list(DTYPE_CODES)}")
    if N not in HEAD_SIZES:
        raise ValueError(f"head size N = {N} not in {HEAD_SIZES}")
    if T < 1:
        raise ValueError("T = 0: no step to scan")
    if tuple(u.shape) != (B, H, N):
        raise ValueError(f"u {tuple(u.shape)} != {(B, H, N)}")
    for name, t in (("s0", s0), ("state_out", state_out)):
        if t is None:
            continue
        if tuple(t.shape) != (B, H, N, N) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {(B, H, N, N)}, got "
                             f"{t.dtype}{list(t.shape)}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w_log", w_log),
                    ("u", u), ("s0", s0), ("state_out", state_out)):
        if t is None:
            continue
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    i32(B * H, "B * H")
    return B, H, i32(T, "T"), N


def wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w_log: torch.Tensor, u: torch.Tensor,
             s0: Optional[torch.Tensor] = None, *,
             state_out: Optional[torch.Tensor] = None):
    """r/k/v/w_log [B,H,T,N]; u [B,H,N]; s0 [B,H,N,N] f32 or None ->
    (o [B,H,T,N] f32, S [B,H,N,N] f32; S is `state_out` when given).
    Replaces the TPU `wkv_scan`."""
    if not on_cuda(r):
        from .ref import wkv_scan_plain
        return wkv_scan_plain(r, k, v, w_log, u, s0, state_out=state_out)
    u = u.float()
    B, H, T, N = _check(r, k, v, w_log, u, s0, state_out)
    o = torch.empty((B, T, H, N), dtype=torch.float32,
                    device=r.device).transpose(1, 2)
    S = state_out if state_out is not None else torch.empty(
        (B, H, N, N), dtype=torch.float32, device=r.device)
    if B * H == 0:
        return o, S
    bht = (0, 1, 2)                 # (b, h, t) or, for a state, (b, h, i)
    st = strides((r, bht), (k, bht), (v, bht), (w_log, bht), (u, (0, 1)),
                 (S if s0 is None else s0, bht), (o, bht), (S, bht))
    check(wkv_lib().wkv_forward(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
        u.data_ptr(), None if s0 is None else s0.data_ptr(),
        o.data_ptr(), S.data_ptr(), st, B, H, T, N, DTYPE_CODES[r.dtype],
        stream()), "wkv_scan")
    wkv_scan.launches += 1
    return o, S


wkv_scan.launches = 0
KERNELS = (wkv_scan,)


def reset_launches() -> dict:
    """Zero `wkv_scan.launches`; returns the count before."""
    return reset_counts(KERNELS)
