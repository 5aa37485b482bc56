"""repro_torch: Serializable HTAP with Abort-/Wait-free Snapshot Read (RSS),
ported to PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

This package sits beside `repro` (the JAX/Pallas reference) and keeps its
module layout and public names, so each module has a counterpart there.
It imports `torch` and numpy only — never jax, and nothing of `repro`.

Subpackages:
  core        the paper's contribution (RSS theory, Algorithm 1, SSI, WAL)
  mvcc        executable MVCC engine + HTAP architectures + CH-benchmark
  cluster     N-way WAL fan-out replica cluster + lag-aware RSS routing
  tensorstore WAL-mirrored paged store, plan executor, materialized views
  kernels     CUDA kernels for sm_90a (built at first use) + plain
              PyTorch versions
  obs         metric registry and span tracing (its own, not `repro`'s)
  configs     the ten architecture configs (data, copied)
  models      the dense attention decoder: layers, init / forward /
              prefill / decode, `params_from_numpy`
  serve       ServingEngine: prefill + decode over RSS-pinned parameter
              snapshots of a `VersionedParamStore`

Device rule: entry points (`PagedMirror`, the HTAP facades, the
`run_*` drivers, `init_params`, `ServingEngine`) run on "cuda" unless the
caller passes device="cpu", and
raise when CUDA is missing — see `kernels.config.resolve_device`.
"""

__version__ = "1.0.0"
