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

Routes (`pick_route`, then `plan`; one launch per call either way):
- "chunked" (T > 1), `wkv_kernel_chunked`: B x H blocks of 2N threads,
  one (b, h) each; a lane holds 4 columns of the state over N / 8 rows,
  8 lanes share a column group; chunks of 16 steps staged in a
  two-stage shared-memory ring by cp.async when r, k, v and w_log start
  on 16 bytes with strides of 16 bytes (`vector`), else by element
  loads.
- "step" (T = 1), `wkv_kernel_step`: B x H blocks of N^2 / 8 threads,
  the state elementwise in float4s (`vector`: s0 and the output state
  start on 16 bytes with strides of 16 bytes) or element by element.
  The chunked route takes T = 1 too (`route="chunked"` forces it); the
  step route is the faster there (the H100 figures are in PERF.md).

Device choice: CUDA tensors launch the kernel (or raise); CPU tensors
take the plain version, `ref.wkv_scan_plain` (`wkv_scan_ref` at this
contract).  `wkv_scan.route_launches` counts real kernel launches
only, by route (`cuda_build.launch_count` sums them), and
`wkv_scan.last_route` is the last launch's `Launch` (route, grid, block,
vector).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..cuda_build import (Launch, check, i32, load, no_backward, on_16b,
                          on_cuda, reset_counts, stream)
from ..flash_attention.kernel import DTYPE_CODES, strides

HEAD_SIZES = (32, 64)
ROUTES = ("chunked", "step")        # the routes `plan` chooses from
COLS_PER_LANE = 4                   # chunked route: columns of S a lane
STEP_FLOAT4S = 2                    # step route: float4s of S a thread


def _bind(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.wkv_forward.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                                i, ll, i, i, p]
    lib.wkv_forward.restype = ctypes.c_int


def pick_route(T: int, route: Optional[str] = None) -> str:
    """The route of a call: `route` when given ("step" only at T = 1),
    else the step route for one token and the chunked route otherwise."""
    if route is None:
        return "step" if T == 1 else "chunked"
    if route not in ROUTES or (route == "step" and T != 1):
        raise ValueError(f"route {route!r} at T = {T}: the routes are "
                         f"{ROUTES}, the step route only at T = 1")
    return route


def plan(B: int, H: int, N: int, route: str, vector: bool) -> Launch:
    """The launch of `route` (see `pick_route`); `vector` says whether
    the operands the route moves (chunked: r, k, v, w_log; step: s0 and
    the output state) sit on 16 bytes (see the module docstring).  The C
    entry rejects any other grid or block."""
    if route == "step":
        return Launch("step", (B * H,), N * N // (4 * STEP_FLOAT4S), vector)
    return Launch("chunked", (B * H,), N // COLS_PER_LANE * 8, vector)


def wkv_lib():
    return load("wkv", _bind)


def _route_code(launch: Launch) -> int:
    """The C entry's route code: 0 chunked by cp.async, 1 chunked by
    element loads, 2 step."""
    return 2 if launch.route == "step" else 0 if launch.vector else 1


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
             state_out: Optional[torch.Tensor] = None,
             route: Optional[str] = None):
    """r/k/v/w_log [B,H,T,N]; u [B,H,N]; s0 [B,H,N,N] f32 or None ->
    (o [B,H,T,N] f32, S [B,H,N,N] f32; S is `state_out` when given).
    Replaces the TPU `wkv_scan`.  `route` forces a route on the card (to
    compare the two at T = 1); None takes `pick_route`'s."""
    if not on_cuda(r):
        from .ref import wkv_scan_plain
        return wkv_scan_plain(r, k, v, w_log, u, s0, state_out=state_out)
    no_backward("wkv_scan", r, k, v, w_log, u, s0)
    u = u.float()
    B, H, T, N = _check(r, k, v, w_log, u, s0, state_out)
    route = pick_route(T, route)
    o = torch.empty((B, T, H, N), dtype=torch.float32,
                    device=r.device).transpose(1, 2)
    S = state_out if state_out is not None else torch.empty(
        (B, H, N, N), dtype=torch.float32, device=r.device)
    if B * H == 0:
        return o, S
    bht = (0, 1, 2)                 # (b, h, t) or, for a state, (b, h, i)
    state_in = S if s0 is None else s0
    if route == "step":
        vector = on_16b(state_in, bht) and on_16b(S, bht)
    else:
        vector = all(on_16b(x, bht) for x in (r, k, v, w_log))
    launch = plan(B, H, N, route, vector)
    st = strides((r, bht), (k, bht), (v, bht), (w_log, bht), (u, (0, 1)),
                 (state_in, bht), (o, bht), (S, bht))
    check(wkv_lib().wkv_forward(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
        u.data_ptr(), None if s0 is None else s0.data_ptr(),
        o.data_ptr(), S.data_ptr(), st, B, H, T, N, DTYPE_CODES[r.dtype],
        _route_code(launch), launch.grid[0], launch.block, int(vector),
        stream()),
        "wkv_scan")
    wkv_scan.route_launches[launch.route] += 1
    wkv_scan.last_route = launch
    return o, S


wkv_scan.last_route = None          # `Launch` of the last launch
# kernel launches by route: the wrapper's one count (`launch_count`)
wkv_scan.route_launches = dict.fromkeys(ROUTES, 0)
KERNELS = (wkv_scan,)


def reset_launches() -> dict:
    """Zero `wkv_scan.route_launches`; returns the launches before."""
    return reset_counts(KERNELS)
