"""CUDA kernel for Hopper: the Mamba selective scan.

`ssm_scan` binds `ssm_forward` of `src/repro_torch/csrc/ssm.cu` (built
with nvcc for sm_90a into `build/repro_torch/` at first use, loaded with
ctypes; the source's header states the design and its bound on the
card).  It replaces the Pallas TPU kernel
`repro.kernels.ssm_scan.kernel.ssm_scan` and keeps its contract, with an
initial state added:

    u/dt [Bb, T, Di], B/C [Bb, T, N], A [Di, N], D [Di],
    h0 [Bb, Di, N] or None  ->  y [Bb, T, Di] f32, h [Bb, Di, N] f32

with D·u added to y in the kernel, as the Pallas kernel adds it.  u is
f32 or bf16 (widened to f32, as the reference casts it); dt, B, C, A, D
and h0 are f32.  N in {8, 16}; any T >= 1 and any Di (the Pallas kernel
asserts T % chunk == 0 and Di % block == 0).  Every operand is read
through its strides (the last dim must be contiguous, D wholly), so B
and C may be slices of the model's x_proj output.  The final state goes
to `state_out` when given (f32 [Bb, Di, N], any strides with a
contiguous last dim), which may be `h0` itself: the kernel reads each
channel's state before it writes it, so a decode step updates the
layer's state in place.

Routes (`pick_route`, then `plan`; one launch per call either way):
- "chunked" (T > 1), `ssm_kernel_chunked`: ceil(Di / 256) x Bb blocks of
  256 threads, one channel each; chunks of 8 steps of u, dt, B and C
  staged in a two-stage shared-memory ring by cp.async when all four
  start on 16 bytes with strides of 16 bytes (`vector`), else by element
  loads.
- "step" (T = 1), `ssm_kernel_step`: one lane per (b, d, quarter of n)
  (halves at N = 8), blocks of 256; h0, A, B, C and h as float4
  (`vector`) or element by element.  The chunked route takes T = 1 too
  (`route="chunked"` forces it); the step route is the faster there
  (the H100 figures are in PERF.md).

Device choice: CUDA tensors launch the kernel (or raise); CPU tensors
take the plain version, `ref.ssm_scan_ref`.
`ssm_scan.route_launches` counts real kernel launches only, by route
(`cuda_build.launch_count` sums them), and `ssm_scan.last_route` is the
last launch's `Launch` (route, grid, block, vector).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..cuda_build import (Launch, check, i32, load, no_backward, on_16b,
                          on_cuda, reset_counts, stream)
from ..flash_attention.kernel import strides

STATE_SIZES = (8, 16)
U_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("chunked", "step")        # the routes `plan` chooses from
CHUNK_BLOCK = 256                   # channels per chunked block
STEP_BLOCK = 256                    # threads per step block
_GRID_Y_MAX = 65535                 # batch rows are the grid's y axis


def _bind(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssm_forward.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                                i, ll, i, i, p]
    lib.ssm_forward.restype = ctypes.c_int


def pick_route(T: int, route: Optional[str] = None) -> str:
    """The route of a call: `route` when given ("step" only at T = 1),
    else the step route for one token and the chunked route otherwise."""
    if route is None:
        return "step" if T == 1 else "chunked"
    if route not in ROUTES or (route == "step" and T != 1):
        raise ValueError(f"route {route!r} at T = {T}: the routes are "
                         f"{ROUTES}, the step route only at T = 1")
    return route


def plan(Bb: int, Di: int, N: int, route: str, vector: bool) -> Launch:
    """The launch of `route` (see `pick_route`); `vector` says whether
    the operands the route moves in 16-byte pieces (chunked: u, dt, B, C;
    step: h0, A, B, C and the output state) sit on 16 bytes (see the
    module docstring).  The C entry rejects any other grid or block."""
    if route == "step":
        return Launch("step", (-(-Bb * Di * (N // 4) // STEP_BLOCK),),
                      STEP_BLOCK, vector)
    return Launch("chunked", (-(-Di // CHUNK_BLOCK), Bb), CHUNK_BLOCK,
                  vector)


def ssm_lib():
    return load("ssm", _bind)


def _route_code(launch: Launch) -> int:
    """The C entry's route code: 0 chunked by cp.async, 1 chunked by
    element loads, 2 step."""
    return 2 if launch.route == "step" else 0 if launch.vector else 1


def _check(u, dt, B, C, A, D, h0, state_out) -> tuple[int, int, int, int]:
    """Validate the operands of a launch; returns (Bb, T, Di, N)."""
    if u.dim() != 3:
        raise ValueError(f"u must be [Bb, T, Di], got {tuple(u.shape)}")
    Bb, T, Di = u.shape
    if B.dim() != 3:
        raise ValueError(f"B must be [Bb, T, N], got {tuple(B.shape)}")
    N = B.shape[2]
    for name, t, shape in (("dt", dt, (Bb, T, Di)), ("B", B, (Bb, T, N)),
                           ("C", C, (Bb, T, N)), ("A", A, (Di, N)),
                           ("D", D, (Di,)), ("h0", h0, (Bb, Di, N)),
                           ("state_out", state_out, (Bb, Di, N))):
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    if u.dtype not in U_DTYPES:
        raise TypeError(f"u is {u.dtype}, not one of {list(U_DTYPES)}")
    if u.stride(-1) != 1:
        raise ValueError("u's last dimension must be contiguous")
    if N not in STATE_SIZES:
        raise ValueError(f"state size N = {N} not in {STATE_SIZES}")
    if T < 1:
        raise ValueError("T = 0: no step to scan")
    if Bb > _GRID_Y_MAX:
        raise ValueError(f"Bb = {Bb} > {_GRID_Y_MAX}")
    i32(-(-Bb * Di * (N // 4) // STEP_BLOCK), "step blocks")
    return Bb, i32(T, "T"), i32(Di, "Di"), N


def ssm_scan(u: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
             h0: Optional[torch.Tensor] = None, *,
             state_out: Optional[torch.Tensor] = None,
             route: Optional[str] = None):
    """u/dt [Bb,T,Di]; B/C [Bb,T,N]; A [Di,N]; D [Di]; h0 [Bb,Di,N] f32 or
    None -> (y [Bb,T,Di] f32, h [Bb,Di,N] f32; h is `state_out` when
    given).  Replaces the TPU `ssm_scan`.  `route` forces a route on the
    card (to compare the two at T = 1); None takes `pick_route`'s."""
    if not on_cuda(u):
        from .ref import ssm_scan_ref
        return ssm_scan_ref(u, dt, B, C, A, D, h0, state_out=state_out)
    no_backward("ssm_scan", u, dt, B, C, A, D, h0)
    Bb, T, Di, N = _check(u, dt, B, C, A, D, h0, state_out)
    route = pick_route(T, route)
    y = torch.empty((Bb, T, Di), dtype=torch.float32, device=u.device)
    h = state_out if state_out is not None else torch.empty(
        (Bb, Di, N), dtype=torch.float32, device=u.device)
    if Bb * Di == 0:
        return y, h
    bt = (0, 1)                     # (b, t) or, for a state, (b, d)
    state_in = h if h0 is None else h0
    if route == "step":
        vector = all(on_16b(x, bt) for x in (state_in, h, B, C)) and \
            on_16b(A, (0,))
    else:
        vector = all(on_16b(x, bt) for x in (u, dt, B, C))
    launch = plan(Bb, Di, N, route, vector)
    st = strides((u, bt), (dt, bt), (B, bt), (C, bt), (A, (0,)),
                 (state_in, bt), (y, bt), (h, bt))
    check(ssm_lib().ssm_forward(
        u.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
        A.data_ptr(), D.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), h.data_ptr(), st, Bb, Di, T, N, U_DTYPES[u.dtype],
        _route_code(launch), launch.grid[0], launch.block, int(vector),
        stream()), "ssm_scan")
    ssm_scan.route_launches[launch.route] += 1
    ssm_scan.last_route = launch
    return y, h


ssm_scan.last_route = None          # `Launch` of the last launch
# kernel launches by route: the wrapper's one count (`launch_count`)
ssm_scan.route_launches = dict.fromkeys(ROUTES, 0)
KERNELS = (ssm_scan,)


def reset_launches() -> dict:
    """Zero `ssm_scan.route_launches`; returns the launches before."""
    return reset_counts(KERNELS)
