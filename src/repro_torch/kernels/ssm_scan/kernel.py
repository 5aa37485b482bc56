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

With `return_states=True` (training) the call also returns the state
before every 8th step (`ref.STATE_EVERY`), f32 [Bb, ceil(T / 8), Di, N],
the chunk boundaries the backward recomputes from; it then always takes
the chunked route, whose kernel is instantiated a second time with the
store, so the serving kernel's code stays as it was.

`ssm_scan_bwd` binds `ssm_backward` of the same source: the gradients of
(y, h) in four launches (the reverse scan over ceil(Di / 64) x Bb blocks
of 64 channels, then the deterministic sums over blocks and batch rows
of its partials of dB, dC, dA and dD), no atomics.  The Pallas package
has no backward kernel; its gradients come from autodiff of the XLA
twin `repro.models.layers._mamba_scan_chunked`.

Device choice: CUDA tensors launch the kernel (or raise); CPU tensors
take the plain versions, `ref.ssm_scan_ref` and `ref.ssm_scan_bwd_ref`.
`ssm_scan.route_launches` and `ssm_scan_bwd.route_launches` count real
kernel launches only, by route (`cuda_build.launch_count` sums them; a
backward call is one), and `last_route` is the last launch's `Launch`
(route, grid, block, vector).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..cuda_build import (Launch, check, i32, load, on_16b, on_cuda,
                          reset_counts, stream)
from ..flash_attention.kernel import strides
from .ref import STATE_EVERY

STATE_SIZES = (8, 16)
U_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("chunked", "step")        # the routes `plan` chooses from
CHUNK_BLOCK = 256                   # channels per chunked block
STEP_BLOCK = 256                    # threads per step block
BWD_ROUTES = ("reverse",)           # the backward's one route
BWD_BLOCK = 64                      # channels per backward block
_GRID_Y_MAX = 65535                 # batch rows are the grid's y axis


def _bind(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssm_forward.argtypes = [p] * 11 + [i] * 6 + [ll, i, i, p]
    lib.ssm_forward.restype = ctypes.c_int
    lib.ssm_backward.argtypes = [p] * 19 + [i] * 5 + [ll, i, p]
    lib.ssm_backward.restype = ctypes.c_int


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
             route: Optional[str] = None, return_states: bool = False):
    """u/dt [Bb,T,Di]; B/C [Bb,T,N]; A [Di,N]; D [Di]; h0 [Bb,Di,N] f32 or
    None -> (y [Bb,T,Di] f32, h [Bb,Di,N] f32; h is `state_out` when
    given), and with `return_states` the chunk-boundary states
    [Bb,ceil(T/8),Di,N] f32 (chunked route).  Replaces the TPU
    `ssm_scan`.  `route` forces a route on the card (to compare the two at
    T = 1); None takes `pick_route`'s.  Autograd does not see the launch:
    `ops.selective_scan` wraps it in `SSMScan` when a gradient is
    needed."""
    if not on_cuda(u):
        from .ref import ssm_scan_ref
        return ssm_scan_ref(u, dt, B, C, A, D, h0, state_out=state_out,
                            return_states=return_states)
    Bb, T, Di, N = _check(u, dt, B, C, A, D, h0, state_out)
    route = pick_route(T, "chunked" if return_states else route)
    y = torch.empty((Bb, T, Di), dtype=torch.float32, device=u.device)
    h = state_out if state_out is not None else torch.empty(
        (Bb, Di, N), dtype=torch.float32, device=u.device)
    states = torch.empty((Bb, -(-T // STATE_EVERY), Di, N),
                         dtype=torch.float32, device=u.device) \
        if return_states else None
    if Bb * Di == 0:
        return (y, h, states) if return_states else (y, h)
    bt = (0, 1)                     # (b, t) or, for a state, (b, d)
    state_in = h if h0 is None else h0
    if route == "step":
        vector = all(on_16b(x, bt) for x in (state_in, h, B, C)) and \
            on_16b(A, (0,))
    else:
        vector = all(on_16b(x, bt) for x in (u, dt, B, C))
    launch = plan(Bb, Di, N, route, vector)
    st = strides((u, bt), (dt, bt), (B, bt), (C, bt), (A, (0,)),
                 (state_in, bt), (y, bt), (h, bt),
                 (y if states is None else states, (0, 1, 2)))
    check(ssm_lib().ssm_forward(
        u.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
        A.data_ptr(), D.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), h.data_ptr(),
        None if states is None else states.data_ptr(), st, Bb, Di, T, N,
        U_DTYPES[u.dtype], _route_code(launch), launch.grid[0],
        launch.block, int(vector), stream()), "ssm_scan")
    ssm_scan.route_launches[launch.route] += 1
    ssm_scan.last_route = launch
    return (y, h, states) if return_states else (y, h)


def plan_bwd(Bb: int, Di: int) -> Launch:
    """The backward's launch as the C entry checks it: ceil(Di / 64) x Bb
    blocks of 64 threads, one channel each."""
    return Launch("reverse", (-(-Di // BWD_BLOCK), Bb), BWD_BLOCK, False)


def ssm_scan_bwd(u: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                 dy: torch.Tensor, dh: Optional[torch.Tensor] = None,
                 h0: Optional[torch.Tensor] = None,
                 states: Optional[torch.Tensor] = None, *,
                 need_dh0: bool = False):
    """The gradients of `ssm_scan`'s (y, h) for their gradients dy
    [Bb,T,Di] f32 and dh [Bb,Di,N] f32 (None: zero), from the forward's
    inputs and its chunk-boundary `states`: (du in u's dtype, ddt, dB,
    dC, dA, dD f32, dh0 [Bb,Di,N] f32 when `need_dh0`, else None).  dB and
    dC are views of one [Bb,T,2N] buffer.  `ref.ssm_scan_bwd_ref`'s
    signature; on the card `states` is required and `h0` is not read (the
    states start from it).  Four launches, counted as one in
    `ssm_scan_bwd.route_launches`."""
    if not on_cuda(u):
        from .ref import ssm_scan_bwd_ref
        return ssm_scan_bwd_ref(u, dt, B, C, A, D, dy, dh, h0, states,
                                need_dh0=need_dh0)
    if states is None:
        raise ValueError("ssm_scan_bwd on the card takes the forward's "
                         "states")
    Bb, T, Di, N = _check(u, dt, B, C, A, D, None, dh)
    if tuple(dy.shape) != (Bb, T, Di) or dy.dtype != torch.float32:
        raise ValueError(f"dy must be float32 {(Bb, T, Di)}, got "
                         f"{dy.dtype}{list(dy.shape)}")
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    want = (Bb, -(-T // STATE_EVERY), Di, N)
    if tuple(states.shape) != want or states.dtype != torch.float32 \
            or not states.is_contiguous():
        raise ValueError(f"states must be contiguous float32 {want}")
    f32 = dict(dtype=torch.float32, device=u.device)
    du = torch.empty((Bb, T, Di), dtype=u.dtype, device=u.device)
    ddt = torch.empty((Bb, T, Di), **f32)
    dBC = torch.empty((Bb, T, 2 * N), **f32)
    dA, dD = torch.empty((Di, N), **f32), torch.empty((Di,), **f32)
    dh0 = torch.empty((Bb, Di, N), **f32) if need_dh0 else None
    if Bb * Di == 0:
        return (du, ddt.zero_(), dBC[..., :N].zero_(), dBC[..., N:].zero_(),
                dA.zero_(), dD.zero_(), None if dh0 is None else dh0.zero_())
    launch = plan_bwd(Bb, Di)
    blocks = launch.grid[0]
    part = torch.empty((Bb, blocks, T, 2 * N), **f32)
    dA_part, dD_part = torch.empty((Bb, Di, N), **f32), \
        torch.empty((Bb, Di), **f32)
    bt = (0, 1)
    st = strides((u, bt), (dt, bt), (B, bt), (C, bt), (A, (0,)), (dy, bt),
                 (states if dh is None else dh, bt), (states, (0, 1, 2)))
    ptr = lambda t: None if t is None else t.data_ptr()
    check(ssm_lib().ssm_backward(
        *(t.data_ptr() for t in (u, dt, B, C, A, D, dy)), ptr(dh),
        states.data_ptr(), du.data_ptr(), ddt.data_ptr(), dBC.data_ptr(),
        dA.data_ptr(), dD.data_ptr(), ptr(dh0), part.data_ptr(),
        dA_part.data_ptr(), dD_part.data_ptr(), st, Bb, Di, T, N,
        U_DTYPES[u.dtype], blocks, launch.block, stream()), "ssm_scan_bwd")
    ssm_scan_bwd.route_launches[launch.route] += 1
    ssm_scan_bwd.last_route = launch
    return du, ddt, dBC[..., :N], dBC[..., N:], dA, dD, dh0


ssm_scan.last_route = None          # `Launch` of the last launch
# kernel launches by route: the wrapper's one count (`launch_count`)
ssm_scan.route_launches = dict.fromkeys(ROUTES, 0)
ssm_scan_bwd.last_route = None
ssm_scan_bwd.route_launches = dict.fromkeys(BWD_ROUTES, 0)
KERNELS = (ssm_scan, ssm_scan_bwd)


def reset_launches() -> dict:
    """Zero both wrappers' `route_launches`; returns the launches
    before."""
    return reset_counts(KERNELS)
