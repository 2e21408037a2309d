"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H, MLA kv_lora=512,
moe_d_ff=1408, vocab=102400, 64 routed experts top-6 + 2 shared.

MLA dims per arXiv:2405.04434 (lite): qk_nope=128, qk_rope=64, v_head=128,
no q-LoRA; first layer is dense (d_ff=10944), layers 1..26 are MoE.
[hf-verified]

A copy of the JAX package's config: 15,706,484,224 parameters, 31.42 GB in
bf16 with the 26 routers kept in fp32, which one H100 serves at full depth.
"""

from .base import LayerSpec, ModelConfig

_DENSE = LayerSpec(attn="mla", ffn="dense")
_MOE = LayerSpec(attn="mla", ffn="moe")


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,           # v head dim; attention uses MLA dims below
        d_ff=10944,             # the single dense layer
        vocab_size=102_400,
        program=(((_DENSE,), 1), ((_MOE,), 26)),
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        num_experts=64,
        num_shared_experts=2,
        top_k=6,
        moe_d_ff=1408,
        capacity_factor=1.5,
        router_type="softmax",
        rope_theta=10_000.0,
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    dense = LayerSpec(attn="mla", ffn="dense")
    moe = LayerSpec(attn="mla", ffn="moe")
    return ModelConfig(
        name="deepseek-v2-lite-smoke",
        family="moe",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=160,
        vocab_size=512,
        program=(((dense,), 1), ((moe,), 2)),
        kv_lora_rank=32,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
        num_experts=8,
        num_shared_experts=2,
        top_k=2,
        moe_d_ff=32,
        capacity_factor=1.5,
        dtype="float32",
    )
