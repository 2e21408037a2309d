"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.

Alternating local(4096-window)/global attention, attention logit softcap 50,
final logit softcap 30, sandwich norms, sqrt(d) embedding scale, head_dim 256.
[arXiv:2408.00118; hf-verified]

A copy of ``repro/configs/gemma2_9b.py``: 9,241,705,984 parameters,
18,484,623,360 B in bf16 with the norm scales kept in fp32 (tied embeddings).
"""

from .base import LayerSpec, ModelConfig

_L = LayerSpec(attn="window", ffn="dense", window=4096)
_G = LayerSpec(attn="full", ffn="dense")


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        num_layers=42,
        d_model=3584,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256_000,
        program=(((_L, _G), 21),),
        attn_softcap=50.0,
        final_softcap=30.0,
        sandwich_norms=True,
        scale_embed=True,
        rope_theta=10_000.0,
        tie_embeddings=True,
        # gemma2 query_pre_attn_scalar = 224 for 9b (d_model/num_heads)
        attn_scale=224.0**-0.5,
    )


def smoke_config() -> ModelConfig:
    l = LayerSpec(attn="window", ffn="dense", window=16)
    g = LayerSpec(attn="full", ffn="dense")
    return ModelConfig(
        name="gemma2-9b-smoke",
        family="dense",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        program=(((l, g), 2),),
        attn_softcap=50.0,
        final_softcap=30.0,
        sandwich_norms=True,
        scale_embed=True,
        dtype="float32",
    )
