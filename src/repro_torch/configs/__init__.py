"""Architecture registry: ``get_config(arch_id)`` / ``list_archs()``.

Every assigned architecture is selectable by its public id (``--arch``);
``smoke_variant`` derives the reduced same-family config used by CPU tests.

A copy of `repro.configs` (data only; the reference package imports jax
through `repro.models`), holding every value of the reference as it is.
"""

from __future__ import annotations

from importlib import import_module

from ..models.config import ModelConfig, SHAPES, ShapeConfig
from .base import smoke_variant

_MODULES = {
    "mixtral-8x22b": ".mixtral_8x22b",
    "mixtral-8x7b": ".mixtral_8x7b",
    "rwkv6-3b": ".rwkv6_3b",
    "qwen2-vl-72b": ".qwen2_vl_72b",
    "nemotron-4-15b": ".nemotron_4_15b",
    "codeqwen1.5-7b": ".codeqwen1_5_7b",
    "qwen1.5-0.5b": ".qwen1_5_0_5b",
    "granite-34b": ".granite_34b",
    "whisper-tiny": ".whisper_tiny",
    "jamba-1.5-large-398b": ".jamba_1_5_large",
}


def list_archs() -> list[str]:
    return list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {list_archs()}")
    mod = import_module(_MODULES[arch], __package__)
    return mod.CONFIG


def iter_cells():
    """All (arch, shape) dry-run cells, with skip markers.

    long_500k requires a sub-quadratic mixer (SSM/hybrid/SWA); pure
    full-attention archs skip it (recorded, per assignment)."""
    for arch in list_archs():
        cfg = get_config(arch)
        for shape_name, shape in SHAPES.items():
            skip = None
            if shape_name == "long_500k" and not cfg.is_subquadratic:
                skip = "full-attention arch: long_500k needs sub-quadratic"
            yield arch, shape_name, skip


__all__ = ["get_config", "list_archs", "iter_cells", "smoke_variant",
           "SHAPES", "ShapeConfig", "ModelConfig"]
