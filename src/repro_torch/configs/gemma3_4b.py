"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.

5:1 local:global attention (sliding window 1024, every 6th layer global),
head_dim=256, sandwich norms, sqrt(d) embedding scale, qk-norm, 128k-context
rope (theta 1e6 on global layers; the reference uses 1e6 throughout, and so
does this copy).  [hf:google/gemma-3 family; unverified]

A copy of ``repro/configs/gemma3_4b.py``: 3,880,099,328 parameters,
7,760,934,912 B in bf16 with the norm scales kept in fp32 (tied embeddings).
"""

from .base import LayerSpec, ModelConfig

_L = LayerSpec(attn="window", ffn="dense", window=1024)
_G = LayerSpec(attn="full", ffn="dense")


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        family="dense",
        num_layers=34,
        d_model=2560,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=10240,
        vocab_size=262_144,
        program=(((_L, _L, _L, _L, _L, _G), 5), ((_L, _L, _L, _L), 1)),
        rope_theta=1_000_000.0,
        sandwich_norms=True,
        scale_embed=True,
        qk_norm=True,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    l = LayerSpec(attn="window", ffn="dense", window=16)
    g = LayerSpec(attn="full", ffn="dense")
    return ModelConfig(
        name="gemma3-4b-smoke",
        family="dense",
        num_layers=8,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        program=(((l, l, g), 2), ((l, l), 1)),
        sandwich_norms=True,
        scale_embed=True,
        qk_norm=True,
        dtype="float32",
    )
