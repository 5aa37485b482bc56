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

With `return_states=True` (training) the call also returns the state
before every 64th step (`ref.STATE_EVERY`), f32 [B, H, ceil(T / 64), N,
N], the chunk boundaries the backward recomputes from; it then always
takes the chunked route, whose kernel is instantiated a second time with
the store, so the serving kernel's code stays as it was.

`wkv_scan_bwd` binds `wkv_backward` of the same source: the gradients of
(o, S) over the forward's 64-step segments in parallel, its recurrences
and the dw_log running sum in f64 (the source's header says why), in
four launches (`plan_bwd`): a state pass over B x H x ceil(T / 64)
blocks, a carry between segments over B x H blocks, the gradient pass
over B x H x ceil(T / 64) blocks, then the du sum over the batch and the
segments.  Scratch: `a` f64 [B, H, T, N] (84 MB at RWKV6-3B's train
shape, B 4), the jumps f32 [B, H, ceil(T / 64) + 1, N, N] (45 MB), two
f64 [B, H, ceil(T / 64), N, N] (84 MB each) and four small [B, H,
ceil(T / 64), N].  No atomics.  The Pallas package has no backward
kernel; its gradients come from autodiff of the XLA twin
`repro.models.layers._wkv_chunked`.

Device choice: CUDA tensors launch the kernel (or raise); CPU tensors
take the plain version, `ref.wkv_scan_plain` (`wkv_scan_ref` at this
contract) and `ref.wkv_scan_bwd_ref`.  `wkv_scan.route_launches` and
`wkv_scan_bwd.route_launches` count real kernel launches only, by route
(`cuda_build.launch_count` sums them; a backward call is one), and
`last_route` is the last launch's `Launch` (route, grid, block,
vector); a backward call, four kernels, counts once.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..cuda_build import (Launch, check, i32, load, on_16b, on_cuda,
                          reset_counts, stream)
from ..flash_attention.kernel import DTYPE_CODES, strides
from .ref import STATE_EVERY

HEAD_SIZES = (32, 64)
ROUTES = ("chunked", "step")        # the routes `plan` chooses from
COLS_PER_LANE = 4                   # chunked route: columns of S a lane
STEP_FLOAT4S = 2                    # step route: float4s of S a thread
BWD_ROUTES = ("reverse",)           # the backward's one route
BWD_COLS = 8                        # backward: columns of a matrix a thread


def _bind(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.wkv_forward.argtypes = [p] * 10 + [i] * 6 + [ll, i, i, p]
    lib.wkv_forward.restype = ctypes.c_int
    lib.wkv_backward.argtypes = [p] * 24 + [i] * 5 + [ll, ll, i, p]
    lib.wkv_backward.restype = ctypes.c_int


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


def _empty_bthn(B: int, H: int, T: int, N: int, dtype, device):
    """A new [B, H, T, N] tensor in [B, T, H, N] memory order (not a view:
    a custom op may return it)."""
    return torch.empty_strided((B, H, T, N), (T * H * N, N, H * N, 1),
                               dtype=dtype, device=device)


def wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w_log: torch.Tensor, u: torch.Tensor,
             s0: Optional[torch.Tensor] = None, *,
             state_out: Optional[torch.Tensor] = None,
             route: Optional[str] = None, return_states: bool = False):
    """r/k/v/w_log [B,H,T,N]; u [B,H,N]; s0 [B,H,N,N] f32 or None ->
    (o [B,H,T,N] f32, S [B,H,N,N] f32; S is `state_out` when given), and
    with `return_states` the chunk-boundary states [B,H,ceil(T/64),N,N]
    f32 (chunked route).  Replaces the TPU `wkv_scan`.  `route` forces a
    route on the card (to compare the two at T = 1); None takes
    `pick_route`'s.  Autograd does not see the launch: `ops.wkv` wraps
    it in `WKVScan` when a gradient is needed."""
    if not on_cuda(r):
        from .ref import wkv_scan_plain
        return wkv_scan_plain(r, k, v, w_log, u, s0, state_out=state_out,
                              return_states=return_states)
    u = u.float()
    B, H, T, N = _check(r, k, v, w_log, u, s0, state_out)
    route = pick_route(T, "chunked" if return_states else route)
    o = _empty_bthn(B, H, T, N, torch.float32, r.device)
    S = state_out if state_out is not None else torch.empty(
        (B, H, N, N), dtype=torch.float32, device=r.device)
    states = torch.empty((B, H, -(-T // STATE_EVERY), N, N),
                         dtype=torch.float32, device=r.device) \
        if return_states else None
    if B * H == 0:
        return (o, S, states) if return_states else (o, S)
    bht = (0, 1, 2)                 # (b, h, t) or, for a state, (b, h, i)
    state_in = S if s0 is None else s0
    if route == "step":
        vector = on_16b(state_in, bht) and on_16b(S, bht)
    else:
        vector = all(on_16b(x, bht) for x in (r, k, v, w_log))
    launch = plan(B, H, N, route, vector)
    st = strides((r, bht), (k, bht), (v, bht), (w_log, bht), (u, (0, 1)),
                 (state_in, bht), (o, bht), (S, bht),
                 (S if states is None else states, (0, 1, 2, 3)))
    check(wkv_lib().wkv_forward(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
        u.data_ptr(), None if s0 is None else s0.data_ptr(),
        o.data_ptr(), S.data_ptr(),
        None if states is None else states.data_ptr(), st, B, H, T, N,
        DTYPE_CODES[r.dtype], _route_code(launch), launch.grid[0],
        launch.block, int(vector), stream()),
        "wkv_scan")
    wkv_scan.route_launches[launch.route] += 1
    wkv_scan.last_route = launch
    return (o, S, states) if return_states else (o, S)


def plan_bwd(B: int, H: int, N: int, T: int) -> Launch:
    """The backward's launch as the C entry checks it: B x H x ceil(T /
    STATE_EVERY) blocks (a (b, h, segment) each) of N^2 / 8 threads, for
    the state and gradient passes; the carry between them runs B x H
    blocks, and the du sum ceil(H N / 256) of 256."""
    return Launch("reverse", (B * H, -(-T // STATE_EVERY)),
                  N * N // BWD_COLS, False)


def wkv_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w_log: torch.Tensor, u: torch.Tensor, do: torch.Tensor,
                 dS: Optional[torch.Tensor] = None,
                 s0: Optional[torch.Tensor] = None,
                 states: Optional[torch.Tensor] = None, *,
                 S: Optional[torch.Tensor] = None, need_ds0: bool = False):
    """The gradients of `wkv_scan`'s (o, S) for their gradients do
    [B,H,T,N] f32 and dS [B,H,N,N] f32 (None: zero), from the forward's
    inputs, its chunk-boundary `states` and its final state `S` (read
    when dS is given): (dr, dk, dv, dw_log) [B,H,T,N] in r's dtype (in
    [B,T,H,N] memory order), du [H,N] in u's dtype (summed over the
    batch: the model shares u, a stride-0 view), and ds0 [B,H,N,N] f32
    when `need_ds0` (else None).  `ref.wkv_scan_bwd_ref`'s signature; on
    the card `states` is required and `s0` is not read (the states start
    from it).  Four launches (see the module docstring), counted as one
    in `wkv_scan_bwd.route_launches`."""
    if not on_cuda(r):
        from .ref import wkv_scan_bwd_ref
        return wkv_scan_bwd_ref(r, k, v, w_log, u, do, dS, s0, states,
                                S=S, need_ds0=need_ds0)
    if states is None or (dS is not None and S is None):
        raise ValueError("wkv_scan_bwd on the card takes the forward's "
                         "states, and its final state S with dS")
    uf = u.float()
    B, H, T, N = _check(r, k, v, w_log, uf, None, None)
    if tuple(do.shape) != (B, H, T, N) or do.dtype != torch.float32:
        raise ValueError(f"do must be float32 {(B, H, T, N)}, got "
                         f"{do.dtype}{list(do.shape)}")
    if do.stride(-1) != 1:
        do = do.contiguous()
    segs = -(-T // STATE_EVERY)
    want = (B, H, segs, N, N)
    if tuple(states.shape) != want or states.dtype != torch.float32 \
            or not states.is_contiguous():
        raise ValueError(f"states must be contiguous float32 {want}")
    for name, t in (("dS", dS), ("S", S if dS is not None else None)):
        if t is not None and (tuple(t.shape) != (B, H, N, N)
                              or t.dtype != torch.float32
                              or t.stride(-1) != 1):
            raise ValueError(f"{name} must be float32 {(B, H, N, N)} with a "
                             "contiguous last dimension")
    dev = r.device
    grads = [_empty_bthn(B, H, T, N, r.dtype, dev) for _ in range(4)]
    du = torch.empty((H, N), dtype=torch.float32, device=dev)
    ds0 = torch.empty((B, H, N, N), dtype=torch.float32, device=dev) \
        if need_ds0 else None
    if B * H == 0:
        return (*(g.zero_() for g in grads), du.zero_().to(u.dtype),
                None if ds0 is None else ds0.zero_())
    f64 = dict(dtype=torch.float64, device=dev)
    a_buf = torch.empty((B, H, T, N), **f64)
    jumps = torch.empty((B, H, segs + 1, N, N), dtype=torch.float32,
                        device=dev)
    e, gin = (torch.empty(want, **f64) for _ in range(2))
    wseg, loc, dwin = (torch.empty((B, H, segs, N), **f64)
                       for _ in range(3))
    du_part = torch.empty((B, H, segs, N), dtype=torch.float32, device=dev)
    launch = plan_bwd(B, H, N, T)
    bht, state = (0, 1, 2), dS if dS is not None else states
    st = strides((r, bht), (k, bht), (v, bht), (w_log, bht), (do, bht),
                 (uf, (0, 1)), (state, bht),
                 (S if dS is not None else state, bht),
                 (states, (0, 1, 2, 3)), (grads[0], bht))
    ptr = lambda t: None if t is None else t.data_ptr()
    check(wkv_lib().wkv_backward(
        *(t.data_ptr() for t in (r, k, v, w_log, uf, do)), ptr(dS),
        ptr(S if dS is not None else None), states.data_ptr(),
        *(g.data_ptr() for g in grads),
        *(t.data_ptr() for t in (a_buf, jumps, e, gin, wseg, loc, dwin,
                                 du_part, du)),
        ptr(ds0), st, B, H, T, N, DTYPE_CODES[r.dtype], *launch.grid,
        launch.block, stream()),
        "wkv_scan_bwd")
    wkv_scan_bwd.route_launches[launch.route] += 1
    wkv_scan_bwd.last_route = launch
    return (*grads, du.to(u.dtype), ds0)


wkv_scan.last_route = None          # `Launch` of the last launch
# kernel launches by route: the wrapper's one count (`launch_count`)
wkv_scan.route_launches = dict.fromkeys(ROUTES, 0)
wkv_scan_bwd.last_route = None
wkv_scan_bwd.route_launches = dict.fromkeys(BWD_ROUTES, 0)
KERNELS = (wkv_scan, wkv_scan_bwd)


def reset_launches() -> dict:
    """Zero both wrappers' `route_launches`; returns the launches
    before."""
    return reset_counts(KERNELS)
