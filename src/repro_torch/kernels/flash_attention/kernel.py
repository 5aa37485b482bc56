"""CUDA kernels for Hopper: flash (prefill) and decode attention.

`flash_attention` binds `fa_flash` of `src/repro_torch/csrc/attention.cu`
(built with nvcc for sm_90a into `build/repro_torch/` at first use,
loaded with ctypes; the source's header states the design and its bound
on the card).  It replaces the Pallas TPU kernel
`repro.kernels.flash_attention.kernel.flash_attention` and keeps its
contract:

    q [B, H, S, hd], k/v [B, K, T, hd], H = K * G  ->  [B, H, S, hd]

causal or not, a sliding `window` > 0 or none, any G, hd in {32, 64,
128}, f32 / bf16 / f16 with f32 accumulation and the output in q's
dtype.  bf16 and f16 run on the tensor cores (wgmma; P rounded once to
the input type before the PV product), f32 on f32 FMA.  Query i and key j
sit at positions i and j.  Unlike the Pallas kernel, S and T need not be
multiples of a block: ragged tiles are masked.  The kernel reads every
tensor through its strides (only the head dimension must be
contiguous), so `ops.attention_bshd` hands it the model's [B, S, H, hd]
tensors as transposed views, without a copy; the output is allocated in
q's memory layout, so it comes back in the model's layout too.  The
tensor-core route moves rows in 16-byte pieces: a bf16 / f16 q, k, v or
output whose start or (b, s, h) strides are not multiples of 16 bytes
raises ValueError.

Device choice: CUDA tensors launch the kernel (or raise); CPU tensors
return the plain version, `ref.attention_ref`.  `flash_attention.launches`
counts real kernel launches only; `flash_attention.last_route` names the
kernel the last one ran, as the C dispatch reports it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..cuda_build import check, i32, load, on_cuda, reset_counts, stream

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the kernels `fa_flash` launches, by the route code it returns
ROUTES = ("flash_kernel (f32 FMA)", "flash_kernel_wgmma (wgmma)")
HEAD_DIMS = (32, 64, 128)
_GRID_MAX = 65535                   # grid y / z limit (heads, batch)
_I32_MAX = 2 ** 31 - 1              # grid x limit (blocks)


def _bind(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fa_flash.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, f,
                             ctypes.POINTER(i), p]
    lib.fa_decode.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, i, i, p]
    lib.fa_flash.restype = ctypes.c_int
    lib.fa_decode.restype = ctypes.c_int


def attention_lib():
    return load("attention", _bind)


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_rank: int) -> tuple[int, int, int, int, int]:
    """Validate attention operands for a kernel launch: q of rank
    `q_rank` ([B, H, S, hd] or [B, H, hd]), k/v [B, K, T, hd] of one
    shape, one device, one dtype of `DTYPE_CODES`, hd in `HEAD_DIMS`,
    H % K == 0, head dims contiguous.  Returns (B, H, K, T, hd)."""
    if q.dim() != q_rank or k.dim() != 4:
        raise ValueError(f"q must be {q_rank}-D and k/v 4-D, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    if tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"k {tuple(k.shape)} != v {tuple(v.shape)}")
    B, H, hd = q.shape[0], q.shape[1], q.shape[-1]
    Bk, K, T, hdk = k.shape
    if Bk != B or hdk != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch or head dim")
    if K < 1 or H % K:
        raise ValueError(f"H = {H} is not a multiple of K = {K}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"dtype {q.dtype} not in {list(DTYPE_CODES)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dimension must be contiguous")
    if B > _GRID_MAX or H > _GRID_MAX:
        raise ValueError(f"B = {B} or H = {H} exceeds {_GRID_MAX}")
    return B, H, K, T, hd


def check_rows_16b(*named: tuple[str, torch.Tensor]) -> None:
    """Raise ValueError unless each tensor starts on 16 bytes and its
    strides over dims 0-2 (those of size > 1) are multiples of 16 bytes:
    the kernels move its rows in 16-byte pieces."""
    for name, t in named:
        vec = 16 // t.element_size()
        if t.data_ptr() % 16 or any(t.size(d) > 1 and t.stride(d) % vec
                                    for d in (0, 1, 2)):
            raise ValueError(f"{name} must start on 16 bytes with strides "
                             "that are multiples of 16 bytes")


def strides(*pairs: tuple[torch.Tensor, tuple[int, ...]]):
    """The element strides of each (tensor, dims) pair over its dims, in
    order, as the int64 array the C entries read."""
    vals = [t.stride(d) for t, dims in pairs for d in dims]
    return (ctypes.c_longlong * len(vals))(*vals)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B,H,S,hd]; k/v [B,K,T,hd] with H = K·G -> [B,H,S,hd] in q's
    dtype.  Replaces the TPU `flash_attention`."""
    if not on_cuda(q):
        from .ref import attention_ref
        return attention_ref(q, k, v, causal=causal, window=window)
    B, H, K, T, hd = check_operands(q, k, v, 4)
    S = q.shape[2]
    window = i32(window, "window")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    out = torch.empty_like(q)           # q's memory layout (see above)
    if out.numel() == 0:
        return out
    if T == 0:
        raise ValueError("T = 0: no key to attend to")
    if q.dtype != torch.float32:
        check_rows_16b(("q", q), ("k", k), ("v", v), ("out", out))
        if -(-S // 64) * B * H > _I32_MAX:      # blocks of 64 query rows
            raise ValueError(f"B·H·S = {B}·{H}·{S}: too many blocks")
    bsh = (0, 2, 1)                 # [B, H, S, hd] -> (b, s, h)
    st = strides((q, bsh), (k, bsh), (v, bsh), (out, bsh))
    route = ctypes.c_int(-1)
    check(attention_lib().fa_flash(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), st,
        B, H, K, i32(S, "S"), i32(T, "T"), hd, DTYPE_CODES[q.dtype],
        int(bool(causal)), window, 1.0 / math.sqrt(hd), ctypes.byref(route),
        stream()), "flash_attention")
    flash_attention.launches += 1
    flash_attention.last_route = ROUTES[route.value]
    return out


flash_attention.launches = 0
flash_attention.last_route = None   # ROUTES entry of the last launch
KERNELS = (flash_attention,)


def reset_launches() -> dict:
    """Zero `flash_attention.launches`; returns the count before."""
    return reset_counts(KERNELS)
