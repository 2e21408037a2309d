"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.

qk_norm (per-head RMSNorm on q/k), GQA with explicit head_dim=128, SwiGLU,
tied embeddings, RoPE theta 1e6.  [hf:Qwen/Qwen3-8B family; hf-verified]
"""

from .base import LayerSpec, ModelConfig, uniform_program

_SPEC = LayerSpec(attn="full", ffn="dense")


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b",
        family="dense",
        num_layers=36,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab_size=151_936,
        program=uniform_program(_SPEC, 36),
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b-smoke",
        family="dense",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        program=uniform_program(_SPEC, 3),
        qk_norm=True,
        rope_theta=10_000.0,
        dtype="float32",
    )
