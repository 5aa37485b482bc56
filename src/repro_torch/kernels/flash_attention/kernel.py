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

With `return_lse=True` the forward also returns each query row's
log-sum-exp of its scaled scores, f32 [B, H, S], which the backward
reads.  `flash_attention_bwd` binds `fa_flash_bwd` of the same source:
(dq, dk, dv) from q, k, v, the output o, lse and the output's gradient
dO, in three launches (δ = rowsum(dO∘O) into an f32 [B, H, S] buffer, a
dK/dV kernel, a dQ kernel), deterministic (no atomics).  The Pallas
package has no backward kernel; its gradients come from autodiff of the
XLA twin (`repro.models.layers.flash_attention_xla`).  dO is read
through its strides as autograd hands it; only where its head dimension
is not contiguous or a bf16 / f16 row is off 16 bytes is it copied to a
contiguous tensor first.

Device choice: CUDA tensors launch the kernel (or raise); CPU tensors
return the plain version, `ref.attention_ref` / `ref.attention_bwd_ref`.
`flash_attention.launches` and `flash_attention_bwd.launches` count real
kernel launches only (one a call; a backward call is its three
kernels); `last_route` names the kernel the last one ran.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..cuda_build import check, i32, load, on_cuda, reset_counts, stream

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the kernels `fa_flash` launches, by the route code it returns
ROUTES = ("flash_kernel (f32 FMA)", "flash_kernel_wgmma (wgmma)")
BWD_ROUTES = ("flash_bwd_*_f32 (f32 FMA)", "flash_bwd_*_mma (mma.sync)")
HEAD_DIMS = (32, 64, 128)
_GRID_MAX = 65535                   # grid y / z limit (heads, batch)
_I32_MAX = 2 ** 31 - 1              # grid x limit (blocks)


def _bind(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fa_flash.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                             f, ctypes.POINTER(i), p]
    lib.fa_flash_bwd.argtypes = [p] * 11 + [i] * 9 + [f, p]
    lib.fa_flash_bwd.restype = ctypes.c_int
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


def rows_16b(t: torch.Tensor) -> bool:
    """True when `t` starts on 16 bytes and its strides over dims 0-2
    (those of size > 1) are multiples of 16 bytes."""
    vec = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and not any(
        t.size(d) > 1 and t.stride(d) % vec for d in (0, 1, 2))


def check_rows_16b(*named: tuple[str, torch.Tensor]) -> None:
    """Raise ValueError unless each tensor's rows lie on 16 bytes
    (`rows_16b`): the kernels move its rows in 16-byte pieces."""
    for name, t in named:
        if not rows_16b(t):
            raise ValueError(f"{name} must start on 16 bytes with strides "
                             "that are multiples of 16 bytes")


def strides(*pairs: tuple[torch.Tensor, tuple[int, ...]]):
    """The element strides of each (tensor, dims) pair over its dims, in
    order, as the int64 array the C entries read."""
    vals = [t.stride(d) for t, dims in pairs for d in dims]
    return (ctypes.c_longlong * len(vals))(*vals)


def _check_launch(q, k, v, window: int):
    """Checks shared by both directions: (B, H, K, S, T, hd, window)."""
    B, H, K, T, hd = check_operands(q, k, v, 4)
    window = i32(window, "window")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if T == 0 and q.numel():
        raise ValueError("T = 0: no key to attend to")
    return B, H, K, i32(q.shape[2], "S"), i32(T, "T"), hd, window


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    return_lse: bool = False):
    """q [B,H,S,hd]; k/v [B,K,T,hd] with H = K·G -> [B,H,S,hd] in q's
    dtype, and with `return_lse` also lse f32 [B,H,S].  Replaces the TPU
    `flash_attention`."""
    if not on_cuda(q):
        from .ref import attention_ref
        return attention_ref(q, k, v, causal=causal, window=window,
                             return_lse=return_lse)
    B, H, K, S, T, hd, window = _check_launch(q, k, v, window)
    out = torch.empty_like(q)           # q's memory layout (see above)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    if q.dtype != torch.float32:
        check_rows_16b(("q", q), ("k", k), ("v", v), ("out", out))
        if -(-S // 64) * B * H > _I32_MAX:      # blocks of 64 query rows
            raise ValueError(f"B·H·S = {B}·{H}·{S}: too many blocks")
    bsh = (0, 2, 1)                 # [B, H, S, hd] -> (b, s, h)
    st = strides((q, bsh), (k, bsh), (v, bsh), (out, bsh))
    route = ctypes.c_int(-1)
    check(attention_lib().fa_flash(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), st, B, H, K, S, T, hd,
        DTYPE_CODES[q.dtype], int(bool(causal)), window, 1.0 / math.sqrt(hd),
        ctypes.byref(route), stream()), "flash_attention")
    flash_attention.launches += 1
    flash_attention.last_route = ROUTES[route.value]
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: int = 0):
    """The gradients (dq [B,H,S,hd], dk, dv [B,K,T,hd], in q's dtype and
    each in its input's memory layout) of `flash_attention`'s output o
    with row log-sum-exp lse (f32 [B,H,S]) for its gradient dO.  dK and
    dV sum over the G query heads of each KV head."""
    if not on_cuda(q):
        from .ref import attention_bwd_ref
        return attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                 window=window)
    B, H, K, S, T, hd, window = _check_launch(q, k, v, window)
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype \
                or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} must match "
                             f"q {tuple(q.shape)} {q.dtype}")
    if tuple(lse.shape) != (B, H, S) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be contiguous f32 {(B, H, S)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    bf = q.dtype != torch.float32
    if do.stride(-1) != 1 or (bf and not rows_16b(do)):
        do = do.contiguous()
    if o.stride(-1) != 1:
        raise ValueError("o's head dimension must be contiguous")
    if bf:
        check_rows_16b(("q", q), ("k", k), ("v", v), ("do", do),
                       ("dq", dq), ("dk", dk), ("dv", dv))
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    bsh = (0, 2, 1)
    st = strides(*((t, bsh) for t in (q, k, v, o, do, dq, dk, dv)))
    check(attention_lib().fa_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), st, B, H, K, S, T, hd,
        DTYPE_CODES[q.dtype], int(bool(causal)), window, 1.0 / math.sqrt(hd),
        stream()), "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.last_route = BWD_ROUTES[int(bf)]
    return dq, dk, dv


flash_attention.launches = 0
flash_attention.last_route = None   # ROUTES entry of the last launch
flash_attention_bwd.launches = 0
flash_attention_bwd.last_route = None   # BWD_ROUTES entry of the last
KERNELS = (flash_attention, flash_attention_bwd)


def reset_launches() -> dict:
    """Zero both wrappers' `launches`; returns the counts before."""
    return reset_counts(KERNELS)
