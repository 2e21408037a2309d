"""starcoder2-7b [dense]: 32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.

GQA + RoPE per arXiv:2402.19173; LayerNorm and GELU MLP (StarCoder2 uses the
classic MLP, not SwiGLU), head_dim=128, rope theta 1e5.  [hf-verified]

A copy of ``repro/configs/starcoder2_7b.py``: 7,173,596,160 parameters,
14.35 GB in bf16 with the LayerNorm scales and biases and the FFN biases
kept in fp32.
"""

from .base import LayerSpec, ModelConfig, uniform_program

_SPEC = LayerSpec(attn="full", ffn="dense")


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        family="dense",
        num_layers=32,
        d_model=4608,
        num_heads=36,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18432,
        vocab_size=49_152,
        program=uniform_program(_SPEC, 32),
        ffn_act="gelu",
        norm_type="layer",
        rope_theta=100_000.0,
        tie_embeddings=True,
        norm_eps=1e-5,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b-smoke",
        family="dense",
        num_layers=3,
        d_model=72,
        num_heads=6,
        num_kv_heads=2,
        head_dim=16,
        d_ff=144,
        vocab_size=512,
        program=uniform_program(_SPEC, 3),
        ffn_act="gelu",
        norm_type="layer",
        dtype="float32",
    )
