"""Architecture registry: ``get_config(arch)`` / ``get_smoke_config(arch)``.

The port carries every architecture of the JAX package's registry:
qwen3-4b, mamba2-370m, deepseek-v2-lite-16b, llama4-maverick-400b-a17b,
hymba-1.5b, starcoder2-7b, whisper-large-v3, gemma3-4b, gemma2-9b and
qwen2-vl-7b.  ``NOT_PORTED`` names any that it lacks, so that asking for
one says why it is missing; it is empty.
"""

from __future__ import annotations

from importlib import import_module

from .base import SHAPES, LayerSpec, ModelConfig, ShapeSpec, uniform_program  # noqa: F401

ARCHS: dict[str, str] = {
    "qwen3-4b": "qwen3_4b",
    "mamba2-370m": "mamba2_370m",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "hymba-1.5b": "hymba_1_5b",
    "starcoder2-7b": "starcoder2_7b",
    "whisper-large-v3": "whisper_large_v3",
    "gemma3-4b": "gemma3_4b",
    "gemma2-9b": "gemma2_9b",
    "qwen2-vl-7b": "qwen2_vl_7b",
}

NOT_PORTED: tuple[str, ...] = ()


def _module(arch: str):
    if arch in NOT_PORTED:
        raise KeyError(f"arch {arch!r} is not yet ported, see ROADMAP.md")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def list_archs() -> list[str]:
    """The architectures the port can build."""
    return list(ARCHS)
