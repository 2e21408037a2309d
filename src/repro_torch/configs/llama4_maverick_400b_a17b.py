"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
expert d_ff=8192, vocab=202048, 128 routed experts top-1 + 1 shared.

MoE interleaved every other layer (interleave_moe_layer_step=2 — this is what
lands total params at ~400B with 17B active); dense layers use d_ff=16384;
sigmoid top-1 router.  Early fusion refers to the multimodal variant — the
text backbone is what's specified and lowered here.
[hf:meta-llama/Llama-4 family; unverified]

A copy of the JAX package's config.  The port serves its smoke model; the
full model (about 400B parameters) needs several cards and waits for the
distributed slice (ROADMAP.md queue A item 12).
"""

from .base import LayerSpec, ModelConfig

_DENSE = LayerSpec(attn="full", ffn="dense")
_MOE = LayerSpec(attn="full", ffn="moe")


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,             # dense (non-MoE) layers
        vocab_size=202_048,
        program=(((_DENSE, _MOE), 24),),
        num_experts=128,
        num_shared_experts=1,
        top_k=1,
        moe_d_ff=8192,
        capacity_factor=1.25,
        router_type="sigmoid",
        rope_theta=500_000.0,
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    dense = LayerSpec(attn="full", ffn="dense")
    moe = LayerSpec(attn="full", ffn="moe")
    return ModelConfig(
        name="llama4-maverick-smoke",
        family="moe",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=160,
        vocab_size=512,
        program=(((dense, moe), 2),),
        num_experts=8,
        num_shared_experts=1,
        top_k=1,
        moe_d_ff=64,
        router_type="sigmoid",
        dtype="float32",
    )
